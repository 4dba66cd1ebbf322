"""
Typed parameters for the audio <-> spectrogram <-> image conversions, with EXIF
round-tripping so every spectrogram image is self-describing.

The port's own copy of riffusion_tpu/spectrogram_params.py (same field
names, defaults, derived quantities and EXIF tag ids, held to it by
tests/test_torch_host.py), so images from either package decode identically
in the other.
"""

from __future__ import annotations

import typing as T
from dataclasses import dataclass
from enum import Enum


@dataclass(frozen=True)
class SpectrogramParams:
    """
    Parameters of the spectrogram representation.

    The defaults describe the geometry the riffusion-v1 model was trained on:
    a 512x512 image is 5.12 s of 44.1 kHz audio (10 ms per column, 512 mel bins
    spanning [0, 10 kHz]).

    Derived STFT quantities (`n_fft`, `win_length`, `hop_length`) follow from
    the *_duration_ms fields, exactly as in the reference
    (spectrogram_params.py:62-81).
    """

    # Whether the audio is stereo or mono
    stereo: bool = False

    # STFT parameters
    sample_rate: int = 44100
    step_size_ms: int = 10
    window_duration_ms: int = 100
    padded_duration_ms: int = 400

    # Mel scale parameters
    num_frequencies: int = 512
    min_frequency: int = 0
    max_frequency: int = 10000
    mel_scale_norm: T.Optional[str] = None
    mel_scale_type: str = "htk"
    max_mel_iters: int = 200

    # Griffin-Lim parameters
    num_griffin_lim_iters: int = 32

    # Image parameterization
    power_for_image: float = 0.25

    class ExifTags(Enum):
        """Custom EXIF tag ids used to stamp params into spectrogram images.

        Values match the reference (spectrogram_params.py:44-60) so images are
        interchangeable between the two implementations.
        """

        SAMPLE_RATE = 11000
        STEREO = 11005
        STEP_SIZE_MS = 11010
        WINDOW_DURATION_MS = 11020
        PADDED_DURATION_MS = 11030

        NUM_FREQUENCIES = 11040
        MIN_FREQUENCY = 11050
        MAX_FREQUENCY = 11060

        POWER_FOR_IMAGE = 11070
        MAX_VALUE = 11080

    @property
    def n_fft(self) -> int:
        """Number of samples per STFT window after zero-padding."""
        return int(self.padded_duration_ms / 1000.0 * self.sample_rate)

    @property
    def win_length(self) -> int:
        """Number of samples in the (unpadded) analysis window."""
        return int(self.window_duration_ms / 1000.0 * self.sample_rate)

    @property
    def hop_length(self) -> int:
        """Number of samples between successive STFT windows."""
        return int(self.step_size_ms / 1000.0 * self.sample_rate)

    def to_exif(self) -> T.Dict[int, T.Any]:
        """Serialize to a dict of EXIF tag id -> value."""
        return {
            self.ExifTags.SAMPLE_RATE.value: self.sample_rate,
            self.ExifTags.STEREO.value: self.stereo,
            self.ExifTags.STEP_SIZE_MS.value: self.step_size_ms,
            self.ExifTags.WINDOW_DURATION_MS.value: self.window_duration_ms,
            self.ExifTags.PADDED_DURATION_MS.value: self.padded_duration_ms,
            self.ExifTags.NUM_FREQUENCIES.value: self.num_frequencies,
            self.ExifTags.MIN_FREQUENCY.value: self.min_frequency,
            self.ExifTags.MAX_FREQUENCY.value: self.max_frequency,
            self.ExifTags.POWER_FOR_IMAGE.value: float(self.power_for_image),
        }

    @classmethod
    def from_exif(cls, exif: T.Mapping[int, T.Any]) -> SpectrogramParams:
        """Reconstruct params from EXIF tags (raises KeyError on missing tags,
        matching the reference's contract used by cli.image_to_audio)."""
        return cls(
            sample_rate=int(exif[cls.ExifTags.SAMPLE_RATE.value]),
            stereo=bool(exif[cls.ExifTags.STEREO.value]),
            step_size_ms=int(exif[cls.ExifTags.STEP_SIZE_MS.value]),
            window_duration_ms=int(exif[cls.ExifTags.WINDOW_DURATION_MS.value]),
            padded_duration_ms=int(exif[cls.ExifTags.PADDED_DURATION_MS.value]),
            num_frequencies=int(exif[cls.ExifTags.NUM_FREQUENCIES.value]),
            min_frequency=int(exif[cls.ExifTags.MIN_FREQUENCY.value]),
            max_frequency=int(exif[cls.ExifTags.MAX_FREQUENCY.value]),
            power_for_image=float(exif[cls.ExifTags.POWER_FOR_IMAGE.value]),
        )
