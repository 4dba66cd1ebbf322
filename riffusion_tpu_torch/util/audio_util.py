"""
Audio utility functions (host side): the part of riffusion_tpu/util/
audio_util.py that the port calls, held to it by tests/test_torch_host.py.

The dynamic range compressor of `apply_filters(compression=True)` runs on
the C++ audio engine (`riffusion_tpu_torch.audio.native`), as the JAX
package's does.
"""

from __future__ import annotations

import typing as T

import numpy as np

from riffusion_tpu_torch.audio import native
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
        compressed = native.compress_dynamic_range_int16(
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

