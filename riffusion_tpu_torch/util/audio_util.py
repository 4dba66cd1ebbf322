"""
Audio utility functions (host side): the part of riffusion_tpu/util/
audio_util.py that the port calls, held to it by tests/test_torch_host.py.

The dynamic range compressor of `apply_filters(compression=True)` is the
numpy version from riffusion_tpu/audio/native.py; the JAX package's C++
audio engine is not ported.
"""

from __future__ import annotations

import math
import typing as T

import numpy as np

from riffusion_tpu_torch.audio.segment import AudioSegment


def audio_from_waveform(
    samples: np.ndarray, sample_rate: int, normalize: bool = False
) -> AudioSegment:
    """
    Convert a float waveform of shape (channels, samples) to an AudioSegment.

    If `normalize`, peak-normalizes to int16 full scale first.
    """
    return AudioSegment.from_float(np.asarray(samples), sample_rate, normalize=normalize)


def apply_filters(segment: AudioSegment, compression: bool = False) -> AudioSegment:
    """
    Post-processing chain: optional compression, then level to -12 dBFS and
    peak-normalize with 0.1 dB headroom.
    """
    if compression:
        segment = normalize(segment, headroom=0.1)
        segment = segment.apply_gain(-10 - segment.dBFS)
        compressed = compress_dynamic_range_int16(
            segment.raw_data,
            segment.frame_rate,
            threshold_db=-20.0,
            ratio=4.0,
            attack_ms=5.0,
            release_ms=50.0,
        )
        segment = AudioSegment(compressed, segment.frame_rate)

    if segment.dBFS == -float("inf"):
        # Silent audio: any gain is a no-op (and +inf gain would NaN).
        return segment

    desired_db = -12
    segment = segment.apply_gain(desired_db - segment.dBFS)
    segment = normalize(segment, headroom=0.1)
    return segment


def normalize(segment: AudioSegment, headroom: float = 0.1) -> AudioSegment:
    """Peak-normalize so the loudest sample sits `headroom` dB below full scale."""
    peak = segment.max_dBFS
    if peak == -float("inf"):
        return segment
    return segment.apply_gain(-headroom - peak)


def stitch_segments(segments: T.Sequence[AudioSegment], crossfade_s: float) -> AudioSegment:
    """Concatenate segments with a crossfade between consecutive pairs."""
    crossfade_ms = int(crossfade_s * 1000)
    combined = segments[0]
    for segment in segments[1:]:
        combined = combined.append(segment, crossfade=crossfade_ms)
    return combined


def overlay_segments(segments: T.Sequence[AudioSegment]) -> AudioSegment:
    """Mix segments on top of each other (result has the first segment's length)."""
    if not segments:
        raise ValueError("overlay_segments needs at least one segment")
    output = segments[0]
    for segment in segments[1:]:
        output = output.overlay(segment)
    return output


def compress_dynamic_range_int16(
    data: np.ndarray,
    rate: int,
    threshold_db: float = -20.0,
    ratio: float = 4.0,
    attack_ms: float = 5.0,
    release_ms: float = 50.0,
) -> np.ndarray:
    """Feed-forward dynamic range compression on (samples, channels) int16
    PCM: a per-sample peak envelope follower in dB (attack / release
    smoothing), then the gain above the threshold divided by the ratio."""
    if data.dtype != np.int16 or data.ndim != 2:
        raise ValueError(f"expected (samples, channels) int16, got {data.dtype} {data.shape}")
    x = data.astype(np.float64)
    peak = np.max(np.abs(x), axis=1)
    level_db = np.where(peak > 0, 20.0 * np.log10(np.maximum(peak, 1e-9) / 32767.0), -120.0)
    att = math.exp(-1.0 / (rate * attack_ms / 1000.0))
    rel = math.exp(-1.0 / (rate * release_ms / 1000.0))
    env = np.empty_like(level_db)
    e = -120.0
    for i in range(len(level_db)):
        c = att if level_db[i] > e else rel
        e = c * e + (1 - c) * level_db[i]
        env[i] = e
    gain_db = np.where(env > threshold_db, threshold_db + (env - threshold_db) / ratio - env, 0.0)
    out = x * (10.0 ** (gain_db / 20.0))[:, None]
    return np.clip(np.round(out), -32768, 32767).astype(np.int16)
