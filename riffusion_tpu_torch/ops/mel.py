"""
Mel-scale projection and its inverse (host numpy).

A copy of riffusion_tpu/ops/mel.py, which is pure numpy but cannot be
imported without jax (riffusion_tpu/ops/__init__.py imports jax). The two
must stay identical; tests/test_torch_dsp.py holds them together.

Forward: a precomputed triangular filterbank applied as a single matmul
(same HTK/Slaney math and orientation as torchaudio's melscale_fbanks).

Inverse: a closed-form ridge-regularized least-squares operator,
precomputed once on the host:

    lin ≈ clamp( fb @ (fbᵀ fb + λI)⁻¹ @ mel , 0 )

The filterbank is zero above `max_frequency`, so only the lowest
`active_bin_count(fb)` frequency rows can ever be nonzero — both projections
are restricted to that band (exact, see ops/stft.py).
"""

from __future__ import annotations

import functools
import typing as T

import numpy as np


def hz_to_mel(freq: np.ndarray, mel_scale: str = "htk") -> np.ndarray:
    """Convert Hz to mels (htk or slaney convention)."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        mels = (freq - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            freq >= min_log_hz, min_log_mel + np.log(freq / min_log_hz) / logstep, mels
        )
    raise ValueError(f"Unknown mel_scale: {mel_scale}")


def mel_to_hz(mels: np.ndarray, mel_scale: str = "htk") -> np.ndarray:
    """Convert mels to Hz (htk or slaney convention)."""
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "slaney":
        f_min, f_sp = 0.0, 200.0 / 3
        freqs = f_min + f_sp * mels
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(
            mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
        )
    raise ValueError(f"Unknown mel_scale: {mel_scale}")


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: T.Optional[str] = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank of shape (n_freqs, n_mels), float32.

    Orientation matches torchaudio.functional.melscale_fbanks:
    mel_spec = fbᵀ @ linear_spec.
    """
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = hz_to_mel(np.array(f_min), mel_scale)
    m_max = hz_to_mel(np.array(f_max), mel_scale)
    m_pts = np.linspace(float(m_min), float(m_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)

    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def active_bin_count(fb: np.ndarray, alignment: int = 128) -> int:
    """Index one past the last frequency row with any nonzero filter weight,
    rounded up to `alignment` for TPU lane tiling (capped at n_freqs)."""
    nonzero_rows = np.nonzero(np.any(fb > 0, axis=1))[0]
    last = int(nonzero_rows[-1]) + 2 if nonzero_rows.size else fb.shape[0]
    aligned = -(-last // alignment) * alignment
    return min(aligned, fb.shape[0])


@functools.lru_cache(maxsize=32)
def _inverse_mel_cached(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: T.Optional[str],
    mel_scale: str,
    n_active: int,
    ridge: float,
) -> np.ndarray:
    fb = mel_filterbank(n_freqs, f_min, f_max, n_mels, sample_rate, norm, mel_scale)
    fb_a = fb[:n_active].astype(np.float64)  # (n_active, n_mels)
    gram = fb_a.T @ fb_a  # (n_mels, n_mels)
    lam = ridge * max(float(np.trace(gram)) / n_mels, 1e-12)
    op = fb_a @ np.linalg.inv(gram + lam * np.eye(n_mels))
    return op.astype(np.float32)


def inverse_mel_operator(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: T.Optional[str] = None,
    mel_scale: str = "htk",
    n_active: T.Optional[int] = None,
    ridge: float = 1e-6,
) -> np.ndarray:
    """(n_active, n_mels) operator: linear_spec ≈ clamp(op @ mel_spec, 0)."""
    fb = mel_filterbank(n_freqs, f_min, f_max, n_mels, sample_rate, norm, mel_scale)
    if n_active is None:
        n_active = active_bin_count(fb)
    return _inverse_mel_cached(
        n_freqs, f_min, f_max, n_mels, sample_rate, norm, mel_scale, n_active, ridge
    )
