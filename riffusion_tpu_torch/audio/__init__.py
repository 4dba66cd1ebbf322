"""Host-side audio: segments, wav I/O, filters (numpy and the C++ audio engine;
no device work)."""

from riffusion_tpu_torch.audio.segment import AudioSegment  # noqa: F401

__all__ = ["AudioSegment"]
