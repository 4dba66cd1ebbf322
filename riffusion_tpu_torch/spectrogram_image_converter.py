"""
Audio <-> spectrogram-image conversion: the PIL boundary over the port's
SpectrogramConverter. The counterpart of
riffusion_tpu/spectrogram_image_converter.py (the same channel coercion,
EXIF stamping with the measured MAX_VALUE, and max_value=30e6 on the
inverse path).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import image_util


class SpectrogramImageConverter:
    """Wraps SpectrogramConverter with the uint8 image codec + EXIF stamping."""

    def __init__(self, params: SpectrogramParams, device: str = "cuda"):
        self.p = params
        self.device = device
        self.converter = SpectrogramConverter(params=params, device=device)

    def spectrogram_image_from_audio(self, segment: AudioSegment) -> Image.Image:
        """Audio segment -> spectrogram PIL image with params in EXIF."""
        if int(segment.frame_rate) != self.p.sample_rate:
            raise ValueError("Sample rate mismatch")

        if self.p.stereo:
            if segment.channels == 1:
                print("WARNING: Mono audio but stereo=True, cloning channel")
                segment = segment.set_channels(2)
            elif segment.channels > 2:
                print("WARNING: Multi channel audio, reducing to stereo")
                segment = segment.set_channels(2)
        elif segment.channels > 1:
            print("WARNING: Stereo audio but stereo=False, setting to mono")
            segment = segment.set_channels(1)

        spectrogram = self.converter.spectrogram_from_audio(segment)

        image = image_util.image_from_spectrogram(spectrogram, power=self.p.power_for_image)

        exif_data = self.p.to_exif()
        exif_data[SpectrogramParams.ExifTags.MAX_VALUE.value] = float(np.max(spectrogram))
        exif = image.getexif()
        exif.update(exif_data.items())

        return image

    def audio_from_spectrogram_image(
        self,
        image: Image.Image,
        apply_filters: bool = True,
        max_value: float = 30e6,
    ) -> AudioSegment:
        """Spectrogram PIL image -> audio segment (Griffin-Lim reconstruction)."""
        spectrogram = image_util.spectrogram_from_image(
            image,
            max_value=max_value,
            power=self.p.power_for_image,
            stereo=self.p.stereo,
        )
        return self.converter.audio_from_spectrogram(spectrogram, apply_filters=apply_filters)
