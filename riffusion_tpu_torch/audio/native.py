"""
ctypes bindings to the C++ audio engine (riffusion_tpu_torch/native/
audio_engine.cpp), with its plain numpy/scipy versions. The counterpart of
riffusion_tpu/audio/native.py: the same three functions and signatures, the
same engine source, so the port's resampling, crossfades and compressor give
the JAX package's samples.

The engine is built on first use with g++ into native/build/, under a name
keyed by the sha256 of the source, the flags and the machine's
architecture; a build goes to a temporary
name first and is moved into place, so processes building at once do not
read each other's half-written library. A build or load that fails raises
with the compiler's output: nothing falls back by itself. The numpy versions
run only when RIFFUSION_TPU_TORCH_NO_NATIVE=1 asks for them (the JAX package
falls back to them silently where its build fails).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import subprocess
import tempfile
import threading
import typing as T
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCE = NATIVE_DIR / "audio_engine.cpp"
BUILD_DIR = NATIVE_DIR / "build"
# -ffp-contract=off: no fused multiply-add, so every host rounds the same way
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")
NO_NATIVE_ENV = "RIFFUSION_TPU_TORCH_NO_NATIVE"

_lock = threading.Lock()
_lib: T.Optional[ctypes.CDLL] = None

_I16P = ctypes.POINTER(ctypes.c_int16)
_SIGNATURES = {
    "rf_resample_poly_int16": (ctypes.c_int64, [
        _I16P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, _I16P]),
    "rf_crossfade_concat_int16": (None, [
        _I16P, ctypes.c_int64, _I16P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, _I16P]),
    "rf_compress_dynamic_range_int16": (None, [
        _I16P, ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, _I16P]),
}


def engine_enabled() -> bool:
    """False only when RIFFUSION_TPU_TORCH_NO_NATIVE=1 asks for the numpy
    versions (read at every call)."""
    value = os.environ.get(NO_NATIVE_ENV, "")
    if value not in ("", "0", "1"):
        raise ValueError(f"{NO_NATIVE_ENV} must be 0 or 1, got {value!r}")
    return value != "1"


def library_path(build_dir: T.Optional[Path] = None) -> Path:
    """Where this source, built with CXX_FLAGS for this machine's
    architecture, lives (in BUILD_DIR by default)."""
    recipe = f"{' '.join(CXX_FLAGS)} {platform.machine()}".encode()
    key = hashlib.sha256(SOURCE.read_bytes() + recipe).hexdigest()[:16]
    return Path(build_dir or BUILD_DIR) / f"libriffaudio-{key}.so"


def build(build_dir: T.Optional[Path] = None) -> Path:
    """Build the engine unless this source and these flags are built; the
    library's path. Raises RuntimeError with the compiler's output."""
    path = library_path(build_dir)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=path.stem + ".", suffix=".so.tmp", dir=path.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building the audio engine ({' '.join(cmd)}) failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building the audio engine ({' '.join(cmd)}) failed with exit "
                               f"code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load() -> ctypes.CDLL:
    """The engine, built if needed and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the audio engine {path} failed: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _i16_ptr(a: np.ndarray):
    return a.ctypes.data_as(_I16P)


def _check_pcm(data: np.ndarray) -> None:
    if data.dtype != np.int16 or data.ndim != 2:
        raise ValueError(f"expected (samples, channels) int16, got {data.dtype} {data.shape}")


# ------------------------------------------------------------- the engine


def resample_poly_int16(data: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Resample (samples, channels) int16 PCM from rate_in to rate_out."""
    _check_pcm(data)
    if rate_in == rate_out:
        return data
    if not engine_enabled():
        return resample_poly_int16_numpy(data, rate_in, rate_out)
    n, channels = data.shape
    g = math.gcd(rate_in, rate_out)
    out_len = -(-(n * (rate_out // g)) // (rate_in // g))
    out = np.empty((out_len, channels), dtype=np.int16)
    if n == 0:
        return out
    src = np.ascontiguousarray(data)
    written = load().rf_resample_poly_int16(
        _i16_ptr(src), n, channels, rate_in, rate_out, _i16_ptr(out))
    if written != out_len:
        raise RuntimeError(f"the audio engine resampled {written} samples, expected {out_len}")
    return out


def crossfade_concat_int16(a: np.ndarray, b: np.ndarray, xf_samples: int) -> np.ndarray:
    """Concatenate two (samples, channels) int16 buffers with a linear
    crossfade of min(xf_samples, len(a), len(b)) samples."""
    _check_pcm(a)
    _check_pcm(b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"channel counts differ: {a.shape[1]} and {b.shape[1]}")
    if xf_samples < 0:  # the engine would copy from before the start of `a`
        raise ValueError(f"a crossfade of {xf_samples} samples")
    if not engine_enabled():
        return crossfade_concat_int16_numpy(a, b, xf_samples)
    na, channels = a.shape
    nb = b.shape[0]
    xf = int(min(xf_samples, na, nb))
    a_c, b_c = np.ascontiguousarray(a), np.ascontiguousarray(b)
    out = np.empty((na + nb - xf, channels), dtype=np.int16)
    load().rf_crossfade_concat_int16(_i16_ptr(a_c), na, _i16_ptr(b_c), nb, channels, xf,
                                     _i16_ptr(out))
    return out


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
    _check_pcm(data)
    if not engine_enabled():
        return compress_dynamic_range_int16_numpy(
            data, rate, threshold_db, ratio, attack_ms, release_ms)
    n, channels = data.shape
    src = np.ascontiguousarray(data)
    out = np.empty_like(src)
    load().rf_compress_dynamic_range_int16(
        _i16_ptr(src), n, channels, float(rate), threshold_db, ratio, attack_ms, release_ms,
        _i16_ptr(out))
    return out


# ------------------------------------------- the plain numpy/scipy versions


def resample_poly_int16_numpy(data: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """scipy's resample_poly (its own Kaiser filter, not the engine's)."""
    from scipy.signal import resample_poly

    g = math.gcd(rate_in, rate_out)
    out = resample_poly(data.astype(np.float64), rate_out // g, rate_in // g, axis=0)
    return np.clip(np.round(out), -32768, 32767).astype(np.int16)


def crossfade_concat_int16_numpy(a: np.ndarray, b: np.ndarray, xf_samples: int) -> np.ndarray:
    """The crossfade in numpy (rounds halves to even, the engine away from
    zero)."""
    na, nb = a.shape[0], b.shape[0]
    xf = int(min(xf_samples, na, nb))
    t = (np.arange(xf, dtype=np.float64) / max(xf, 1))[:, None]
    mixed = a[na - xf:].astype(np.float64) * (1.0 - t) + b[:xf].astype(np.float64) * t
    return np.concatenate(
        [a[: na - xf], np.clip(np.round(mixed), -32768, 32767).astype(np.int16), b[xf:]], axis=0)


def compress_dynamic_range_int16_numpy(
    data: np.ndarray,
    rate: int,
    threshold_db: float = -20.0,
    ratio: float = 4.0,
    attack_ms: float = 5.0,
    release_ms: float = 50.0,
) -> np.ndarray:
    """The compressor in numpy, with a Python loop over the samples for the
    envelope."""
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
