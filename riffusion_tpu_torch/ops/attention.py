"""
Multi-head attention over the packed (b, s, h*d) layout: the two
hand-written Hopper kernels, their plain PyTorch version, and the gate that
picks one of them at each UNet attention site.

`attention(q, k, v, num_heads=..., scale=...)` and `row_attention(...)`
compute softmax(q k^T * scale) v per head, with q, k, v and the output in
the layout the to_q / to_k / to_v projections emit. They port the JAX
package's two Pallas attention kernels:

- `attention` (csrc/attention.cu) is K1, jax's TPU flash_attention called
  from riffusion_tpu/models/layers.py;
- `row_attention` (csrc/row_attention.cu) is K2, riffusion_tpu/ops/
  attention.py full_row_attention, the batched path's seq-4096 sites.

Each CUDA source says what bounds its kernel on the card and what its
design does about it.

- For a CUDA tensor a wrapper launches its kernel, or raises. Nothing falls
  back.
- For a CPU tensor it runs `attention_reference`, the plain version of
  both: the einsum composition with fp32 softmax (riffusion_tpu/ops/
  attention.py `_reference`, models/layers.py's "pref" path).

`route` is the one owner of the gate (which sites take which kernel) and
`kernel_takes_head_dim` of the head widths the kernels have instances for.

`COUNTS.launches` counts K1 launches, `COUNTS.row_launches` K2 launches and
`COUNTS.plain_calls` wrapper calls that took the plain version, so a run can
show which one it went through. Calling `attention_reference` directly
counts nothing.

The kernels are built with nvcc at first use (route (b): shared libraries
with a plain C entry point each, loaded with ctypes) into csrc/build/, keyed
by a hash of the source and the headers it includes. No backward exists
yet.
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
    "attention", "row_attention", "attention_reference", "build_kernels", "compare_to_plain",
    "kernel_takes_head_dim", "route", "COUNTS", "TOLERANCE",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "build"
# kernel name -> (source, C entry point)
KERNELS = {
    "attention": (_CSRC / "attention.cu", "riff_attention_forward"),
    "row_attention": (_CSRC / "row_attention.cu", "riff_row_attention_forward"),
}

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

# How closely a kernel must match its plain version on the same inputs, per
# dtype: (max abs error, RMS of the error / RMS of the plain output).
# - bf16: both round the softmax weights (the kernels unnormalized, the
#   plain version normalized) and the output to bf16, which moves the output
#   by about 3e-3 of its RMS. Max abs alone cannot see a fault at bf16: with
#   near-uniform weights over a thousand keys the outputs are only ~0.05, and
#   a fault that hands 1.5% of the softmax mass to the zero-padded ragged
#   tail moves them by under 2e-3. The relative RMS bound, 6e-3, passes the
#   rounding and fails that fault (it reaches 1.4e-2; tests/
#   test_torch_attention.py plants it, a skipped K/V tile, and Q read from
#   the wrong head).
# - fp32 (TF32 off): plain FMAs against an fp32 matmul, another sum order.
TOLERANCE = {torch.bfloat16: (2e-2, 6e-3), torch.float32: (1e-4, 1e-5)}

# The gate, as the JAX package's models/layers.py Attention sets it
# (EINSUM_SEQ_MIN, EINSUM_B_LO, ROWATTN_BLOCK_Q, and the flash branch's
# 256-query floor), without its environment knobs.
ROW_SEQ_MIN = 2048  # K2 takes self-attention with at least this many queries,
ROW_BATCH_ABOVE = 8  # at a batch above this,
ROW_BLOCK_Q = 512  # and a query count that is a multiple of this.
FLASH_SEQ_MIN = 256  # K1 takes the other self-attention sites from here up.


@dataclasses.dataclass
class Counts:
    launches: int = 0
    row_launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.row_launches = 0
        self.plain_calls = 0


COUNTS = Counts()


@dataclasses.dataclass(frozen=True)
class BuiltKernel:
    fn: T.Any  # the ctypes entry point
    path: Path
    build_seconds: float  # 0.0 when an earlier build of the same source was reused
    compiler_log: str


_build_lock = threading.Lock()
_built: T.Dict[str, BuiltKernel] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(source: Path) -> str:
    """Hash of a source and every header beside it (what it may include)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return h.hexdigest()[:16]


def build_kernels(
    names: T.Sequence[str] = tuple(KERNELS), rebuild: bool = False
) -> T.Dict[str, BuiltKernel]:
    """Compile the named sources for sm_90a (once per hash, or anew with
    `rebuild`), one nvcc per source, all started together, and load them."""
    with _build_lock:
        todo = [n for n in names if rebuild or n not in _built]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in todo:
            source = KERNELS[name][0]
            stem = BUILD_DIR / f"{name}-{_digest(source)}"
            so_path, log_path = stem.with_suffix(".so"), stem.with_suffix(".log")
            proc = tmp = None
            if rebuild or not so_path.is_file():
                tmp = stem.with_suffix(f".{os.getpid()}.tmp.so")
                cmd = [
                    _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(source),
                ]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
            jobs[name] = (so_path, log_path, tmp, proc, time.perf_counter())
        for name, (so_path, log_path, tmp, proc, start) in jobs.items():
            seconds = 0.0
            if proc is not None:
                out, _ = proc.communicate()
                seconds = time.perf_counter() - start
                log_path.write_text(out)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {KERNELS[name][0].name}:\n{out}"
                    )
                os.replace(tmp, so_path)
            fn = getattr(ctypes.CDLL(str(so_path)), KERNELS[name][1])
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] * 4
                + [ctypes.c_longlong] * 8
                + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            )
            log = log_path.read_text() if log_path.is_file() else ""
            _built[name] = BuiltKernel(fn=fn, path=so_path, build_seconds=seconds,
                                       compiler_log=log)
        return {n: _built[n] for n in names}


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
    """The head widths both kernels have an instance for."""
    return head_dim % 8 == 0 and 0 < head_dim <= 128


def route(batch: int, seq_q: int, head_dim: int, self_attention: bool) -> str:
    """Which attention a UNet site takes, in the JAX package's order
    (models/layers.py Attention): "row" (K2) for self-attention with at
    least ROW_SEQ_MIN queries, a multiple of ROW_BLOCK_Q, at a batch above
    ROW_BATCH_ABOVE; otherwise, outside that large-batch window, "flash"
    (K1) for self-attention with at least FLASH_SEQ_MIN queries; "plain"
    everywhere else. Both kernels need a head width they take."""
    if not (self_attention and kernel_takes_head_dim(head_dim)):
        return "plain"
    if seq_q >= ROW_SEQ_MIN and batch > ROW_BATCH_ABOVE:
        return "row" if seq_q % ROW_BLOCK_Q == 0 else "plain"
    return "flash" if seq_q >= FLASH_SEQ_MIN else "plain"


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


def _launch(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Launch kernel `name` on CUDA operands (checked here) into a new
    output, on the current stream; raises if the launch is refused."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(
                f"{arg} must have a contiguous h*d dim, batch/seq strides that are "
                f"multiples of 8 and a 16-byte aligned base (strides {x.stride()})"
            )
    b, s_q, inner = q.shape
    out = torch.empty((b, s_q, inner), dtype=q.dtype, device=q.device)
    fn = build_kernels((name,))[name].fn
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s_q, k.shape[1], num_heads, inner // num_heads, float(scale),
        _KERNEL_DTYPES[q.dtype], q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return out


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, s, h*d) operands through K1's
    kernel (csrc/attention.cu) for CUDA tensors (bf16 or fp32), the plain
    version for CPU tensors. head_dim = inner / num_heads must be a
    multiple of 8, at most 128."""
    _validate(q, k, v, num_heads)
    if q.device.type == "cpu":
        COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    out = _launch("attention", q, k, v, num_heads, scale)
    COUNTS.launches += 1
    return out


def row_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """The same function through K2's kernel (csrc/row_attention.cu) for
    CUDA tensors, the plain version for CPU tensors; the batched path's
    large-sequence sites (`route` == "row"). Same operand rules as
    `attention`; ragged s_q and s_kv are masked."""
    _validate(q, k, v, num_heads)
    if q.device.type == "cpu":
        COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    out = _launch("row_attention", q, k, v, num_heads, scale)
    COUNTS.row_launches += 1
    return out
