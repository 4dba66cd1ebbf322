"""
Multi-head attention over the packed (b, s, h*d) layout: the hand-written
Hopper kernel (csrc/attention.cu) and its plain PyTorch version.

`attention(q, k, v, num_heads=..., scale=...)` computes
softmax(q k^T * scale) v per head, with q, k, v and the output in the layout
the to_q / to_k / to_v projections emit. It is the port of the JAX
package's two Pallas attention kernels (jax's TPU flash_attention called
from riffusion_tpu/models/layers.py, and riffusion_tpu/ops/attention.py
full_row_attention); the CUDA source says what bounds the kernel on the
card and what its design does about it.

- For a CUDA tensor it launches the kernel, or raises. Nothing falls back.
- For a CPU tensor it runs `attention_reference`, the plain version: the
  einsum composition with fp32 softmax (riffusion_tpu/ops/attention.py
  `_reference`, models/layers.py's "pref" path).

`COUNTS.launches` counts kernel launches and `COUNTS.plain_calls` counts
calls that took the plain version, so a run can show which one it went
through. Calling `attention_reference` directly counts nothing.

The kernel is built with nvcc at first use (route (b): a shared library with
a plain C entry point, loaded with ctypes) into csrc/build/, keyed by a hash
of the source. No backward exists yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
import typing as T
from pathlib import Path

import torch

__all__ = [
    "attention", "attention_reference", "build_kernel", "compare_to_plain", "kernel_takes_head_dim",
    "COUNTS", "TOLERANCE",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "attention.cu"
BUILD_DIR = _CSRC / "build"

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# How closely the kernel must match its plain version on the same inputs, per
# dtype: (max abs error, RMS of the error / RMS of the plain output).
# - bf16: both round the softmax weights (the kernel unnormalized, the plain
#   version normalized) and the output to bf16, which moves the output by
#   about 3e-3 of its RMS. Max abs alone cannot see a fault at bf16: with
#   near-uniform weights over a thousand keys the outputs are only ~0.05, and
#   a fault that hands 1.5% of the softmax mass to the zero-padded ragged
#   tail moves them by under 2e-3. The relative RMS bound, 6e-3, passes the
#   rounding and fails that fault (it reaches 1.4e-2; tests/
#   test_torch_attention.py plants it and a skipped K/V tile).
# - fp32 (TF32 off): plain FMAs against an fp32 matmul, another sum order.
TOLERANCE = {torch.bfloat16: (2e-2, 6e-3), torch.float32: (1e-4, 1e-5)}


@dataclasses.dataclass
class Counts:
    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


COUNTS = Counts()


@dataclasses.dataclass(frozen=True)
class BuiltKernel:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build of the same source was reused
    compiler_log: str


_build_lock = threading.Lock()
_built: T.Optional[BuiltKernel] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_kernel(rebuild: bool = False) -> BuiltKernel:
    """Compile csrc/attention.cu for sm_90a (once per source hash, or anew
    with `rebuild`) and load it."""
    global _built
    with _build_lock:
        if _built is not None and not rebuild:
            return _built
        source = _SOURCE.read_bytes()
        digest = hashlib.sha256(source).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so_path = BUILD_DIR / f"attention-{digest}.so"
        log_path = BUILD_DIR / f"attention-{digest}.log"
        seconds = 0.0
        if rebuild or not so_path.is_file():
            tmp = BUILD_DIR / f"attention-{digest}.{os.getpid()}.tmp.so"
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE),
            ]
            start = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - start
            log_path.write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {_SOURCE.name}:\n{proc.stderr}"
                )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        fn = lib.riff_attention_forward
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_longlong] * 8
            + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        log = log_path.read_text() if log_path.is_file() else ""
        _built = BuiltKernel(lib=lib, path=so_path, build_seconds=seconds, compiler_log=log)
        return _built


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """The plain version: per-head einsum composition with the softmax in
    fp32 (fp64 for fp64 operands). The logits accumulate in that precision;
    the softmax weights are cast to v's dtype for the second product."""
    b, s_q, inner = q.shape
    d = inner // num_heads
    precise = torch.promote_types(torch.float32, q.dtype)
    qh = q.reshape(b, s_q, num_heads, d).to(precise)
    kh = k.reshape(b, k.shape[1], num_heads, d).to(precise)
    vh = v.reshape(b, v.shape[1], num_heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(vh.dtype), vh)
    return out.reshape(b, s_q, inner)


def compare_to_plain(out: torch.Tensor, ref: torch.Tensor) -> T.Tuple[float, float, bool]:
    """(max abs error, error RMS / plain RMS, within TOLERANCE) of a kernel
    output against the plain version's on the same inputs, in fp32."""
    err = out.float() - ref.float()
    max_abs = float(err.abs().max())
    rel_rms = float(err.norm() / ref.float().norm())
    abs_tol, rel_tol = TOLERANCE[ref.dtype]
    ok = bool(torch.isfinite(out).all()) and max_abs <= abs_tol and rel_rms <= rel_tol
    return max_abs, rel_rms, ok


def kernel_takes_head_dim(head_dim: int) -> bool:
    """The head widths csrc/attention.cu has an instance for."""
    return head_dim % 8 == 0 and 0 < head_dim <= 128


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (b, s, h*d) operands: q={tuple(q.shape)} k={tuple(k.shape)}")
    b, _, inner = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != inner:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
    if num_heads <= 0 or inner % num_heads:
        raise ValueError(f"inner={inner} not divisible by num_heads={num_heads}")
    head_dim = inner // num_heads
    if not kernel_takes_head_dim(head_dim):
        raise ValueError(f"head_dim={head_dim} must be a multiple of 8 and at most 128")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"device mismatch: {q.device}, {k.device}, {v.device}")


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, s, h*d) operands. CUDA tensors go
    through the kernel (bf16 or fp32), CPU tensors through the plain version.
    Requires head_dim = inner / num_heads to be a multiple of 8, at most 128."""
    _validate(q, k, v, num_heads)
    if q.device.type == "cpu":
        COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(
                f"{name} must have a contiguous h*d dim, batch/seq strides that are "
                f"multiples of 8 and a 16-byte aligned base (strides {x.stride()})"
            )
    b, s_q, inner = q.shape
    s_kv = k.shape[1]
    out = torch.empty((b, s_q, inner), dtype=q.dtype, device=q.device)
    kernel = build_kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = kernel.lib.riff_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s_q, s_kv, num_heads, inner // num_heads, float(scale),
        _KERNEL_DTYPES[q.dtype], q.device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {rc}")
    COUNTS.launches += 1
    return out
