"""
Plain reference of the audio tail of a served clip: the spectrogram image's
codes back to mel amplitudes, the mel-to-linear inverse as a ridge least
squares solve, Griffin-Lim over torch.stft / torch.istft, and the int16
peak normalization.

Geometry of riffusion's SpectrogramParams defaults: 44.1 kHz, 10 ms hop,
100 ms Hann window centered in a 400 ms frame, 512 HTK mel bins over
[0, 10 kHz], power 0.25 in the image, 32 Griffin-Lim iterations at momentum
0.99. The inverse mel is the least-squares solution with a ridge of 1e-6 of
the Gram matrix's mean diagonal (the program's stated operator; riffusion's
reference runs torchaudio's iterative InverseMelScale instead).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Geometry:
    sample_rate: int = 44100
    hop: int = 441
    win: int = 4410
    n_fft: int = 17640
    n_mels: int = 512
    f_max: float = 10000.0
    power_for_image: float = 0.25
    max_value: float = 30e6
    gl_iters: int = 32
    momentum: float = 0.99
    ridge: float = 1e-6


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def filterbank(geo: Geometry) -> np.ndarray:
    """HTK triangular filters (n_freqs, n_mels), torchaudio's orientation,
    held in float32 as torchaudio's melscale_fbanks returns them."""
    n_freqs = geo.n_fft // 2 + 1
    freqs = np.linspace(0.0, geo.sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(geo.f_max), geo.n_mels + 2))
    slopes = f_pts[None, :] - freqs[:, None]
    diff = np.diff(f_pts)
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def inverse_mel(geo: Geometry) -> np.ndarray:
    """(n_freqs, n_mels): linear ~ op @ mel, ridge least squares, float64."""
    fb = filterbank(geo).astype(np.float64)
    gram = fb.T @ fb
    lam = geo.ridge * max(np.trace(gram) / geo.n_mels, 1e-12)
    return fb @ np.linalg.inv(gram + lam * np.eye(geo.n_mels))


def phase_bins(geo: Geometry) -> int:
    """The number of lowest frequency bins whose phase a request draws: one
    past the last bin any mel filter touches, plus one, rounded up to 128."""
    rows = np.nonzero(np.any(filterbank(geo) > 0, axis=1))[0]
    last = int(rows[-1]) + 2
    return min(-(-last // 128) * 128, geo.n_fft // 2 + 1)


def mel_from_image(image_u8: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(H, W, 3) uint8 spectrogram image -> (1, n_mels, W) mel amplitudes:
    the image's rows are frequencies, lowest at the bottom; mono in red."""
    codes = torch.flip(image_u8, dims=(0,))[..., 0].float()[None]
    return ((255.0 - codes) / 255.0) ** (1.0 / geo.power_for_image) * geo.max_value


def griffin_lim(mag: torch.Tensor, init_real: torch.Tensor, init_imag: torch.Tensor,
                geo: Geometry) -> torch.Tensor:
    """(1, n_freqs, F) magnitudes -> (1, (F - 1) * hop) waveform; the
    initial phase's bins above the drawn ones are irrelevant (zero
    magnitude there)."""
    window = torch.hann_window(geo.win, periodic=True, dtype=torch.float64,
                               device=mag.device).float()
    kw = dict(n_fft=geo.n_fft, hop_length=geo.hop, win_length=geo.win, window=window,
              center=True)
    pad = mag.shape[1] - init_real.shape[1]
    phase = torch.complex(torch.nn.functional.pad(init_real, (0, 0, 0, pad), value=1.0),
                          torch.nn.functional.pad(init_imag, (0, 0, 0, pad), value=0.0))
    angles = phase / (phase.abs() + 1e-16)
    mom = geo.momentum / (1.0 + geo.momentum)
    prev = torch.zeros_like(angles)
    for _ in range(geo.gl_iters):
        wav = torch.istft(mag * angles, **kw)
        rebuilt = torch.stft(wav, pad_mode="reflect", return_complex=True, **kw)
        u = rebuilt - mom * prev
        angles, prev = u / (u.abs() + 1e-16), rebuilt
    return torch.istft(mag * angles, **kw)


def int16_peak(waveform: torch.Tensor) -> torch.Tensor:
    peak = waveform.abs().max()
    scale = 32767.0 / peak if peak > 0 else 1.0
    return torch.clamp(torch.round(waveform * scale), -32768, 32767).to(torch.int16)


def audio_from_image(image_u8: torch.Tensor, init_real: torch.Tensor, init_imag: torch.Tensor,
                     geo: Geometry = Geometry()) -> torch.Tensor:
    """The served clip's int16 samples (1, L) from its image and drawn
    Griffin-Lim phase."""
    mel = mel_from_image(image_u8, geo)
    op = torch.from_numpy(inverse_mel(geo).astype(np.float32)).to(mel.device)
    linear = torch.clamp(torch.einsum("fm,bmt->bft", op, mel), min=0.0)
    return int16_peak(griffin_lim(linear, init_real, init_imag, geo))


def _gain(samples: np.ndarray, db: float) -> np.ndarray:
    return np.clip(np.round(samples.astype(np.float64) * 10.0 ** (db / 20.0)), -32768, 32767)


def served_filters(samples: np.ndarray) -> np.ndarray:
    """riffusion's post-processing of a served clip (pydub semantics on
    int16, full scale 32767): gain to an RMS of -12 dBFS, clipping at full scale, then a peak
    normalization to 0.1 dB below full scale."""
    x = samples.astype(np.float64)
    rms = float(np.sqrt(np.mean(x ** 2)))
    if rms == 0:
        return samples
    x = _gain(x, -12.0 - 20.0 * np.log10(rms / 32767.0))
    peak = float(np.max(np.abs(x)))
    return _gain(x, -0.1 - 20.0 * np.log10(peak / 32767.0)).astype(np.int16)
