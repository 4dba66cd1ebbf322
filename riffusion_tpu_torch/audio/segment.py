"""
`AudioSegment`: an immutable, numpy-backed audio clip with the operation
surface the framework needs. The port's own copy of
riffusion_tpu/audio/segment.py, held to it by tests/test_torch_host.py.

Internal representation: int16 PCM, shape (num_samples, num_channels),
matching WAV file layout so export is a straight memory write. Resampling
and crossfades run on the C++ audio engine (`riffusion_tpu_torch.audio.native`),
as the JAX package's do on its copy of the same engine.

Format support:
  * wav: native (stdlib/scipy, no external binaries)
  * mp3/m4a/ogg/flac...: via an ffmpeg binary if one is on PATH (the reference
    had the same hard dependency through pydub); otherwise a clear error.
"""

from __future__ import annotations

import io
import math
import os
import shutil
import subprocess
import tempfile
import typing as T

import numpy as np

_INT16_MAX = float(np.iinfo(np.int16).max)  # 32767


def _ffmpeg_path() -> T.Optional[str]:
    return shutil.which("ffmpeg")


class AudioSegment:
    """An immutable PCM audio clip. All mutating-style ops return new segments."""

    def __init__(self, data: np.ndarray, frame_rate: int):
        """
        Args:
            data: int16 array of shape (num_samples, num_channels) or (num_samples,)
            frame_rate: sample rate in Hz
        """
        if data.ndim == 1:
            data = data[:, None]
        assert data.ndim == 2, f"expected (samples, channels), got {data.shape}"
        if data.dtype != np.int16:
            data = np.asarray(data)
            if np.issubdtype(data.dtype, np.floating):
                data = np.clip(np.round(data), -32768, 32767).astype(np.int16)
            else:
                data = data.astype(np.int16)
        self._data = data
        self._frame_rate = int(frame_rate)

    # ------------------------------------------------------------------ props

    @property
    def raw_data(self) -> np.ndarray:
        """(num_samples, num_channels) int16 view."""
        return self._data

    @property
    def frame_rate(self) -> int:
        return self._frame_rate

    @property
    def channels(self) -> int:
        return self._data.shape[1]

    @property
    def frame_count(self) -> int:
        return self._data.shape[0]

    @property
    def duration_seconds(self) -> float:
        return self._data.shape[0] / self._frame_rate

    @property
    def duration_ms(self) -> float:
        return 1000.0 * self.duration_seconds

    @property
    def sample_width(self) -> int:
        return 2  # int16

    @property
    def dBFS(self) -> float:
        """RMS level relative to full scale, in dB (pydub-compatible)."""
        samples = self._data.astype(np.float64)
        if samples.size == 0:
            return -float("inf")
        rms = math.sqrt(float(np.mean(samples**2)))
        if rms == 0:
            return -float("inf")
        return 20.0 * math.log10(rms / _INT16_MAX)

    @property
    def max_dBFS(self) -> float:
        peak = float(np.max(np.abs(self._data.astype(np.int32)))) if self._data.size else 0.0
        if peak == 0:
            return -float("inf")
        return 20.0 * math.log10(peak / _INT16_MAX)

    # ------------------------------------------------------------- construction

    @classmethod
    def from_float(
        cls, samples: np.ndarray, frame_rate: int, normalize: bool = False
    ) -> "AudioSegment":
        """Build from float waveform in (channels, samples) layout (device DSP layout)."""
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 1:
            samples = samples[None, :]
        if normalize:
            peak = float(np.max(np.abs(samples)))
            if peak > 0:
                samples = samples * (_INT16_MAX / peak)
        data = np.clip(np.round(samples.T), -32768, 32767).astype(np.int16)
        return cls(data, frame_rate)

    @classmethod
    def silent(cls, duration_ms: float, frame_rate: int, channels: int = 1) -> "AudioSegment":
        n = int(round(duration_ms / 1000.0 * frame_rate))
        return cls(np.zeros((n, channels), dtype=np.int16), frame_rate)

    @classmethod
    def from_wav(cls, f: T.Union[str, os.PathLike, io.IOBase]) -> "AudioSegment":
        from scipy.io import wavfile

        rate, data = wavfile.read(f)
        if data.ndim == 1:
            data = data[:, None]
        if data.dtype == np.int16:
            pass
        elif data.dtype == np.int32:
            data = (data >> 16).astype(np.int16)
        elif data.dtype == np.uint8:
            data = ((data.astype(np.int16) - 128) << 8).astype(np.int16)
        elif np.issubdtype(data.dtype, np.floating):
            data = np.clip(np.round(data * _INT16_MAX), -32768, 32767).astype(np.int16)
        else:
            raise ValueError(f"Unsupported WAV dtype: {data.dtype}")
        return cls(data, rate)

    @classmethod
    def from_file(
        cls, f: T.Union[str, os.PathLike, io.IOBase], format: T.Optional[str] = None
    ) -> "AudioSegment":
        """Load audio from a file path or file object. Non-wav formats need ffmpeg."""
        if hasattr(f, "read"):
            payload = f.read()
            fmt = format or _sniff_format(payload)
            if fmt == "wav":
                return cls.from_wav(io.BytesIO(payload))
            return cls._from_bytes_via_ffmpeg(payload, fmt)
        path = os.fspath(f)
        fmt = format or os.path.splitext(path)[1].lstrip(".").lower() or "wav"
        if fmt in ("wav", "wave"):
            return cls.from_wav(path)
        with open(path, "rb") as fh:
            return cls._from_bytes_via_ffmpeg(fh.read(), fmt)

    @classmethod
    def _from_bytes_via_ffmpeg(cls, payload: bytes, fmt: T.Optional[str]) -> "AudioSegment":
        ffmpeg = _ffmpeg_path()
        if ffmpeg is None:
            raise RuntimeError(
                f"Decoding format {fmt!r} requires an ffmpeg binary on PATH "
                "(only wav decodes natively). Install ffmpeg or supply wav input."
            )
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, f"in.{fmt or 'bin'}")
            dst = os.path.join(td, "out.wav")
            with open(src, "wb") as fh:
                fh.write(payload)
            subprocess.run(
                [ffmpeg, "-y", "-v", "error", "-i", src, "-f", "wav", dst],
                check=True,
                capture_output=True,
            )
            return cls.from_wav(dst)

    # ------------------------------------------------------------------- export

    def export(
        self, out: T.Union[str, os.PathLike, io.IOBase, None] = None, format: str = "wav"
    ) -> io.IOBase:
        """Write the segment to a file/stream. Returns the stream positioned at 0."""
        fmt = format.lower()
        if fmt in ("wav", "wave"):
            payload = self._wav_bytes()
        else:
            payload = self._encode_via_ffmpeg(fmt)
        if out is None:
            out = io.BytesIO()
        if hasattr(out, "write"):
            out.write(payload)
            if hasattr(out, "seek"):
                out.seek(0)
            return out  # type: ignore[return-value]
        with open(os.fspath(out), "wb") as fh:
            fh.write(payload)
        return open(os.fspath(out), "rb")

    def _wav_bytes(self) -> bytes:
        from scipy.io import wavfile

        buf = io.BytesIO()
        wavfile.write(buf, self._frame_rate, self._data)
        return buf.getvalue()

    def _encode_via_ffmpeg(self, fmt: str) -> bytes:
        ffmpeg = _ffmpeg_path()
        if ffmpeg is None:
            raise RuntimeError(
                f"Encoding format {fmt!r} requires an ffmpeg binary on PATH "
                "(only wav encodes natively)."
            )
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "in.wav")
            dst = os.path.join(td, f"out.{fmt}")
            with open(src, "wb") as fh:
                fh.write(self._wav_bytes())
            subprocess.run(
                [ffmpeg, "-y", "-v", "error", "-i", src, dst],
                check=True,
                capture_output=True,
            )
            with open(dst, "rb") as fh:
                return fh.read()

    # ------------------------------------------------------------------ slicing

    def __len__(self) -> int:
        """Length in milliseconds (pydub-compatible)."""
        return int(round(self.duration_ms))

    def __getitem__(self, ms_slice: slice) -> "AudioSegment":
        """Millisecond-indexed slicing, mirroring pydub's segment[a:b]."""
        assert isinstance(ms_slice, slice) and ms_slice.step is None
        start_ms = 0 if ms_slice.start is None else ms_slice.start
        stop_ms = self.duration_ms if ms_slice.stop is None else ms_slice.stop
        if start_ms < 0:
            start_ms = self.duration_ms + start_ms
        if stop_ms < 0:
            stop_ms = self.duration_ms + stop_ms
        i0 = int(round(start_ms / 1000.0 * self._frame_rate))
        i1 = int(round(stop_ms / 1000.0 * self._frame_rate))
        i0 = max(0, min(i0, self.frame_count))
        i1 = max(i0, min(i1, self.frame_count))
        return AudioSegment(self._data[i0:i1], self._frame_rate)

    # ------------------------------------------------------------------ channels

    def split_to_mono(self) -> T.List["AudioSegment"]:
        return [
            AudioSegment(self._data[:, c : c + 1], self._frame_rate)
            for c in range(self.channels)
        ]

    def get_array_of_samples(self) -> np.ndarray:
        """Interleaved flat int16 samples (pydub-compatible for mono use)."""
        return self._data.reshape(-1)

    def set_channels(self, channels: int) -> "AudioSegment":
        if channels == self.channels:
            return self
        if channels == 1:
            mixed = np.mean(self._data.astype(np.float64), axis=1)
            return AudioSegment(np.round(mixed).astype(np.int16)[:, None], self._frame_rate)
        if self.channels == 1:
            return AudioSegment(np.repeat(self._data, channels, axis=1), self._frame_rate)
        raise ValueError(f"Cannot convert {self.channels} channels to {channels}")

    # ------------------------------------------------------------------ resample

    def set_frame_rate(self, frame_rate: int) -> "AudioSegment":
        if frame_rate == self._frame_rate:
            return self
        from riffusion_tpu_torch.audio import native

        resampled = native.resample_poly_int16(self._data, self._frame_rate, frame_rate)
        return AudioSegment(resampled, frame_rate)

    # ------------------------------------------------------------------ mixing

    def apply_gain(self, gain_db: float) -> "AudioSegment":
        scale = 10.0 ** (gain_db / 20.0)
        out = np.clip(np.round(self._data.astype(np.float64) * scale), -32768, 32767)
        return AudioSegment(out.astype(np.int16), self._frame_rate)

    def overlay(self, other: "AudioSegment", position_ms: float = 0) -> "AudioSegment":
        """Mix `other` on top of self starting at position_ms; result keeps self's length."""
        assert other.frame_rate == self._frame_rate, "overlay requires matching sample rates"
        other = other.set_channels(self.channels)
        out = self._data.astype(np.int32).copy()
        i0 = int(round(position_ms / 1000.0 * self._frame_rate))
        n = min(other.frame_count, self.frame_count - i0)
        if n > 0:
            out[i0 : i0 + n] += other.raw_data[:n].astype(np.int32)
        return AudioSegment(np.clip(out, -32768, 32767).astype(np.int16), self._frame_rate)

    def append(self, other: "AudioSegment", crossfade: float = 0) -> "AudioSegment":
        """Concatenate with a linear-amplitude crossfade of `crossfade` ms."""
        assert other.frame_rate == self._frame_rate, "append requires matching sample rates"
        other = other.set_channels(self.channels)
        xf = int(round(crossfade / 1000.0 * self._frame_rate))
        xf = min(xf, self.frame_count, other.frame_count)
        if xf == 0:
            return AudioSegment(
                np.concatenate([self._data, other.raw_data], axis=0), self._frame_rate
            )
        from riffusion_tpu_torch.audio import native

        out = native.crossfade_concat_int16(self._data, other.raw_data, xf)
        return AudioSegment(out, self._frame_rate)

    def fade_in(self, duration_ms: float) -> "AudioSegment":
        n = min(int(round(duration_ms / 1000.0 * self._frame_rate)), self.frame_count)
        out = self._data.astype(np.float64).copy()
        ramp = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
        out[:n] *= ramp
        return AudioSegment(np.round(out).astype(np.int16), self._frame_rate)

    def fade_out(self, duration_ms: float) -> "AudioSegment":
        n = min(int(round(duration_ms / 1000.0 * self._frame_rate)), self.frame_count)
        out = self._data.astype(np.float64).copy()
        ramp = np.linspace(1.0, 0.0, n, endpoint=False)[:, None]
        out[self.frame_count - n :] *= ramp
        return AudioSegment(np.round(out).astype(np.int16), self._frame_rate)

    def __add__(self, other: T.Union["AudioSegment", float]) -> "AudioSegment":
        if isinstance(other, AudioSegment):
            return self.append(other, crossfade=0)
        return self.apply_gain(float(other))

    def __repr__(self) -> str:
        return (
            f"AudioSegment({self.duration_seconds:.3f}s, {self._frame_rate}Hz, "
            f"{self.channels}ch)"
        )


def _sniff_format(payload: bytes) -> str:
    if payload[:4] == b"RIFF" and payload[8:12] == b"WAVE":
        return "wav"
    if payload[:3] == b"ID3" or (len(payload) > 1 and payload[0] == 0xFF and (payload[1] & 0xE0) == 0xE0):
        return "mp3"
    if payload[:4] == b"OggS":
        return "ogg"
    if payload[:4] == b"fLaC":
        return "flac"
    if payload[4:8] == b"ftyp":
        return "m4a"
    return "wav"
