"""
Spectrogram <-> image codec (host side, numpy/PIL): the port's own copy of
riffusion_tpu/util/image_util.py, held to it by
tests/test_torch_training.py.

Encoding contract: normalize by max -> power curve `data**power` -> scale to
[0,255] -> invert (255 - x) -> uint8; mono writes L converted to RGB, stereo
writes channel 0 to G and channel 1 to B (R zeroed); the image is Y-flipped
so low frequencies are at the bottom.

The tensor version of this math is `riffusion_tpu_torch.ops.codec`; this
module is the PIL boundary.
"""

from __future__ import annotations

import typing as T
import warnings

import numpy as np
from PIL import Image

from riffusion_tpu_torch.spectrogram_params import SpectrogramParams


def image_from_spectrogram(spectrogram: np.ndarray, power: float = 0.25) -> Image.Image:
    """
    Encode a (channels, frequency, time) magnitude array as a PIL image.
    Inverse of `spectrogram_from_image` up to uint8 quantization.

    Degenerate inputs fail clean instead of silently casting NaN to uint8:
    non-finite magnitudes raise, and an all-zero (silent) spectrogram encodes
    as the blank-white image (the exact encoding of silence) with a warning.
    """
    max_value = float(np.max(spectrogram)) if spectrogram.size else 0.0
    if not np.isfinite(max_value):
        raise ValueError(
            "spectrogram contains non-finite values; refusing to encode"
        )
    if max_value <= 0.0:
        warnings.warn(
            "encoding an all-zero (silent) spectrogram as a blank image",
            stacklevel=2,
        )
        data = np.zeros_like(spectrogram, dtype=np.float32)
    else:
        data = spectrogram / max_value
    data = np.power(data, power)
    data = 255 - (data * 255)
    data = data.astype(np.uint8)

    if data.shape[0] == 1:
        image = Image.fromarray(data[0], mode="L").convert("RGB")
    elif data.shape[0] == 2:
        rgb = np.stack([np.zeros_like(data[0]), data[0], data[1]], axis=-1)
        image = Image.fromarray(rgb, mode="RGB")
    else:
        raise NotImplementedError(f"Unsupported number of channels: {data.shape[0]}")

    return image.transpose(Image.Transpose.FLIP_TOP_BOTTOM)


def spectrogram_from_image(
    image: Image.Image,
    power: float = 0.25,
    stereo: bool = False,
    max_value: float = 30e6,
) -> np.ndarray:
    """
    Decode a spectrogram image back to a (channels, frequency, time) magnitude
    array, reversing each step of `image_from_spectrogram`.

    A non-finite `max_value` raises; `max_value <= 0` (e.g. the stamped
    MAX_VALUE of a silent image) decodes to silence with a warning rather
    than shipping NaN-derived audio downstream.
    """
    if not np.isfinite(max_value):
        raise ValueError(f"max_value must be finite, got {max_value}")
    if max_value <= 0.0:
        warnings.warn(
            f"max_value={max_value} decodes to silence (degenerate image)",
            stacklevel=2,
        )
        max_value = 0.0
    if image.mode in ("P", "L"):
        image = image.convert("RGB")

    image = image.transpose(Image.Transpose.FLIP_TOP_BOTTOM)

    data = np.array(image).transpose(2, 0, 1)
    if stereo:
        data = data[[1, 2], :, :]
    else:
        data = data[0:1, :, :]

    data = data.astype(np.float32)
    data = (255 - data) / 255
    data = np.power(data, 1 / power)
    return data * max_value


def exif_from_image(pil_image: Image.Image) -> T.Dict[str, T.Any]:
    """Read EXIF tags from an image, keyed by SpectrogramParams tag name."""
    exif = pil_image.getexif()
    if exif is None or len(exif) == 0:
        return {}
    return {SpectrogramParams.ExifTags(key).name: val for key, val in exif.items()}
