"""
Multi-head attention over the packed (b, s, h*d) layout: the hand-written
Hopper kernels, their plain PyTorch versions, and the gate that picks one
of them at each UNet attention site.

`attention(q, k, v, num_heads=..., scale=...)` and `row_attention(...)`
compute softmax(q k^T * scale) v per head, with q, k, v and the output in
the layout the to_q / to_k / to_v projections emit. They port the JAX
package's Pallas attention kernels:

- `attention` (csrc/attention.cu) is K1, jax's TPU flash_attention called
  from riffusion_tpu/models/layers.py. Its gradient is two more kernels,
  as the TPU's custom VJP is: csrc/attention_dkv.cu (dK, dV) and
  csrc/attention_dq.cu (dQ), behind `attention_backward`.
- `row_attention` (csrc/row_attention.cu) is K2, riffusion_tpu/ops/
  attention.py full_row_attention, the batched path's seq-4096 sites. Its
  gradient is the plain recompute, autograd through `attention_reference`,
  as the JAX package's `_bwd` takes jax.vjp of its einsum reference.

Each CUDA source says what bounds its kernel on the card and what its
design does about it.

- For a CUDA tensor a wrapper launches its kernel, or raises. Nothing falls
  back.
- For a CPU tensor it runs the plain version: `attention_reference`, the
  einsum composition with fp32 softmax (riffusion_tpu/ops/attention.py
  `_reference`, models/layers.py's "pref" path), and for the gradient
  `attention_backward_reference`, the explicit formulas of jax's
  `mha_reference_bwd`.
- Both wrappers are differentiable. A call whose operands need no gradient
  (serving, under inference_mode) launches the forward alone, without the
  log-sum-exp the backward kernels need.

`route` is the one owner of the gate (which sites take which kernel) and
`kernel_takes_head_dim` of the head widths the kernels have instances for.
The JAX package decides the gate on the shapes it traces: a mesh-sharded
batch at its global batch, a vmapped frame at its own. Inside
`route_batch(n)` the UNet's sites route as if their batch were n, whatever
share of it this process holds (parallel/, riffuse_audio_batch's mesh).

`COUNTS.launches` counts K1 launches, `COUNTS.row_launches` K2 launches,
`COUNTS.bwd_dkv_launches` / `COUNTS.bwd_dq_launches` the backward kernels'
launches and `COUNTS.plain_calls` wrapper calls that took the plain version
(forward or backward), so a run can show which one it went through. Calling
`attention_reference` or `attention_backward_reference` directly counts
nothing. A wrapper called while a CUDA graph is captured records its launch
into the graph and counts it there; the graph's program (aot.py) takes
those counts back and adds them again on each replay, the graph's launches.
Both forward kernels launch on the current stream, so a capture records
them like any torch operation. The same `COUNTS` holds the NHWC GroupNorm's
(ops/group_norm.py): `group_norm_launches`, its wrapper's calls on the card,
`group_norm_plain_calls`, its calls that took the plain version, and
`group_norm_library_calls`, the GroupNorm calls on CUDA tensors that ran
torch's F.group_norm instead (models/layers.py GroupNorm); and the
trainer's one-pass AdamW's (ops/adamw.py): `adamw_launches`.

`KERNELS` also lists csrc/group_norm.cu, so that it builds in the same
round as the forward attention kernels (`FORWARD_KERNELS`), and
csrc/adamw.cu, which builds with the backward kernels in the trainer's
round (`TRAIN_KERNELS`), so that serving neither builds nor loads it.

The kernels are built with nvcc at first use (route (b): shared libraries
with a plain C entry point each, loaded with ctypes) into csrc/build/, keyed
by a hash of the source and the headers it includes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
import typing as T
from pathlib import Path

import torch

__all__ = [
    "attention", "row_attention", "attention_backward", "attention_reference",
    "attention_backward_reference", "build_kernels", "built_on_disk", "compare_to_plain",
    "backward_delta", "compare_grads_to_plain", "kernel_takes_head_dim", "ptxas_instances", "route",
    "route_batch", "routed_batch", "COUNTS", "TOLERANCE", "GRAD_TOLERANCE",
]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = _CSRC / "build"
# kernel name -> (source, C entry point)
KERNELS = {
    "attention": (_CSRC / "attention.cu", "riff_attention_forward"),
    "row_attention": (_CSRC / "row_attention.cu", "riff_row_attention_forward"),
    "attention_dkv": (_CSRC / "attention_dkv.cu", "riff_attention_bwd_dkv"),
    "attention_dq": (_CSRC / "attention_dq.cu", "riff_attention_bwd_dq"),
    "group_norm": (_CSRC / "group_norm.cu", "riff_group_norm"),  # ops/group_norm.py
    "adamw": (_CSRC / "adamw.cu", "riff_adamw"),  # ops/adamw.py
}
FORWARD_KERNELS = ("attention", "row_attention", "group_norm")  # what inference launches
TRAIN_KERNELS = ("attention", "attention_dkv", "attention_dq", "adamw")  # what a trainer launches
# C entry point -> its argument types (pointers, element strides, ints,
# scale, dtype, device, stream)
_ARGTYPES = {
    "riff_attention_forward": [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 8
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "riff_attention_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 10
    + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
# riff_group_norm: x, gamma, beta, y, partials; batch, hw, channels,
# groups, rows, chunk, chunks; eps; silu, dtype, param dtype, device; stream
_ARGTYPES["riff_group_norm"] = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# riff_adamw: params, exp_avgs, exp_avg_sqs, grads, steps (pointer arrays);
# numels, grad_bf16 (arrays), leaves; lr; beta1, beta2, eps, weight decay;
# blocks, device; stream
_ARGTYPES["riff_adamw"] = [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                                   ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                                   ctypes.c_void_p] + [ctypes.c_double] * 2 \
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_ARGTYPES["riff_row_attention_forward"] = _ARGTYPES["riff_attention_forward"]
_ARGTYPES["riff_attention_bwd_dq"] = _ARGTYPES["riff_attention_bwd_dkv"]

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

# How closely the backward kernels' dQ, dK and dV must each match the plain
# backward on the same inputs, per dtype: (max abs error, error RMS / plain
# RMS). Derived from a CPU emulation of the kernels' arithmetic
# (tests/test_torch_attention_grad.py): bf16 rounds P for dV = P^T dO, dS
# for dK and dQ, and the outputs, which moves each gradient by 2.2e-3 to
# 3.0e-3 of its RMS, and its largest element by up to 6.25e-2 where large
# logits make gradients of 12 (one bf16 rounding there). The bounds pass
# that with a margin and fail the planted faults (dS without its -delta
# term, a skipped Q tile in dK/dV, the LSE of the wrong head, dK without
# the scale), which move a gradient by 0.14 of its RMS or more. fp32:
# another sum order only.
GRAD_TOLERANCE = {torch.bfloat16: (1.25e-1, 1e-2), torch.float32: (1e-3, 2e-5)}

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
    bwd_dkv_launches: int = 0
    bwd_dq_launches: int = 0
    plain_calls: int = 0
    group_norm_launches: int = 0  # ops/group_norm.py
    group_norm_plain_calls: int = 0
    group_norm_library_calls: int = 0  # models/layers.py GroupNorm
    plain_self_sites: int = 0  # models/layers.py Attention: card self-attention routed "plain"
    adamw_launches: int = 0  # ops/adamw.py

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)

    def snapshot(self) -> T.Dict[str, int]:
        return dataclasses.asdict(self)

    def since(self, before: T.Mapping[str, int]) -> T.Dict[str, int]:
        """What was counted after `before` (a snapshot)."""
        return {k: v - before[k] for k, v in self.snapshot().items()}

    def restore(self, before: T.Mapping[str, int]) -> None:
        for name, value in before.items():
            setattr(self, name, value)

    def add(self, counted: T.Mapping[str, int]) -> None:
        """Count again what `since` gave (a captured graph's replay)."""
        for name, value in counted.items():
            setattr(self, name, getattr(self, name) + value)


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


def _stem(name: str) -> Path:
    """The build's path without its suffix, keyed by the source's digest."""
    return BUILD_DIR / f"{name}-{_digest(KERNELS[name][0])}"


def built_on_disk(names: T.Sequence[str]) -> bool:
    """Whether csrc/build/ already holds a build of each named source."""
    return all(_stem(name).with_suffix(".so").is_file() for name in names)


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
            stem = _stem(name)
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
            entry = KERNELS[name][1]
            fn = getattr(ctypes.CDLL(str(so_path)), entry)
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[entry]
            log = log_path.read_text() if log_path.is_file() else ""
            _built[name] = BuiltKernel(fn=fn, path=so_path, build_seconds=seconds,
                                       compiler_log=log)
        return {n: _built[n] for n in names}


def ptxas_instances(compiler_log: str) -> T.List[T.Tuple[str, str, str]]:
    """(instance, registers, spills) of each kernel instance in an nvcc
    `-Xptxas -v` log: the instance as `name<args>` read from the mangled
    name (`_ZN4riff25attention_fwd_bf16_kernelILi48ELi40ELi2ELb0EEEv...` ->
    `attention_fwd_bf16_kernel<48, 40, 2, 0>`; a bfloat16 or float type
    argument as `bf16` or `float`), ptxas's "Used ... registers"
    line and its spill line."""
    found, instance, spills = [], "?", ""
    for line in compiler_log.splitlines():
        entry = re.search(
            r"Compiling entry function '(\w+?_kernel)I((?:L[ib]\d+E|13__nv_bfloat16|f)+)E", line)
        if entry:  # the name after the mangling's last length prefix, and its arguments
            name = re.split(r"\d+(?=[a-z])", entry.group(1))[-1]
            args = [value or ("bf16" if bf16 else "float") for value, bf16 in
                    re.findall(r"L[ib](\d+)E|13__nv_(bfloat16)|f", entry.group(2))]
            instance = f"{name}<{', '.join(args)}>"
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            found.append((instance, line.split(":", 1)[-1].strip(), spills))
    return found


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


def compare_to_plain(
    out: torch.Tensor, ref: torch.Tensor, tolerance: T.Mapping = TOLERANCE
) -> T.Tuple[float, float, bool]:
    """(max abs error, error RMS / plain RMS, within `tolerance`) of a kernel
    output against the plain version's on the same inputs, in fp32."""
    err = out.float() - ref.float()
    max_abs = float(err.abs().max())
    rel_rms = float(err.norm() / ref.float().norm())
    abs_tol, rel_tol = tolerance[ref.dtype]
    ok = bool(torch.isfinite(out).all()) and max_abs <= abs_tol and rel_rms <= rel_tol
    return max_abs, rel_rms, ok


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    *, num_heads: int, scale: float,
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dq, dk, dv) of `attention_reference` for the
    output `out` and its gradient `dout`, by the explicit formulas of jax's
    mha_reference_bwd (with the scale): P = softmax(q k^T * scale),
    dv = P^T dout, dP = dout v^T, delta = rowsum(dout * out),
    dS = P * (dP - delta), dq = scale * dS k, dk = scale * dS^T q; in fp32
    (fp64 for fp64 operands), returned in q's dtype."""
    b, s_q, inner = q.shape
    d = inner // num_heads
    precise = torch.promote_types(torch.float32, q.dtype)

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(b, x.shape[1], num_heads, d).to(precise)

    qh, kh, vh, oh, doh = (heads(x) for x in (q, k, v, out, dout))
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, doh)
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    delta = (doh * oh).sum(-1).transpose(1, 2)  # (b, h, s_q)
    ds = probs * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh) * scale
    return tuple(x.reshape(b, x.shape[1], inner).to(q.dtype) for x in (dq, dk, dv))


def compare_grads_to_plain(
    grads: T.Sequence[torch.Tensor], refs: T.Sequence[torch.Tensor]
) -> T.Dict[str, T.Tuple[float, float, bool]]:
    """compare_to_plain for each of (dq, dk, dv) against the plain
    backward's, under GRAD_TOLERANCE."""
    return {name: compare_to_plain(g, ref, GRAD_TOLERANCE)
            for name, g, ref in zip(("dq", "dk", "dv"), grads, refs)}


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


_ROUTE = threading.local()


@contextlib.contextmanager
def route_batch(batch: int) -> T.Iterator[None]:
    """Route the attention sites called in this thread, inside the block,
    as if their batch were `batch` (the batch JAX would trace: a sharded
    batch's global size, or one frame's 2 where JAX vmaps frames)."""
    previous = getattr(_ROUTE, "batch", None)
    _ROUTE.batch = int(batch)
    try:
        yield
    finally:
        _ROUTE.batch = previous


def routed_batch(batch: int) -> int:
    """The batch a site of `batch` rows routes at: route_batch's inside
    its block, else its own."""
    override = getattr(_ROUTE, "batch", None)
    return batch if override is None else override


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


def _check_operands(name: str, **tensors: torch.Tensor) -> None:
    """The layout every kernel reads: CUDA, bf16 or fp32, a contiguous h*d
    dim, batch/seq strides that are multiples of 8, a 16-byte aligned base."""
    for arg, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
        if x.dtype not in _KERNEL_DTYPES:
            raise ValueError(f"the kernel takes bfloat16 or float32, got {x.dtype}")
        if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
            raise ValueError(
                f"{arg} must have a contiguous h*d dim, batch/seq strides that are "
                f"multiples of 8 and a 16-byte aligned base (strides {x.stride()})"
            )


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    lse: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch forward kernel `name` on CUDA operands (checked here) into a
    new output, on the current stream, writing the rows' log-sum-exp into
    `lse` ((b, h, s_q) fp32) when it is given; raises if the launch is
    refused."""
    _check_operands(name, q=q, k=k, v=v)
    b, s_q, inner = q.shape
    out = torch.empty((b, s_q, inner), dtype=q.dtype, device=q.device)
    fn = build_kernels((name,))[name].fn
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s_q, k.shape[1], num_heads, inner // num_heads, float(scale),
        _KERNEL_DTYPES[q.dtype], q.device.index, _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return out


def backward_delta(out: torch.Tensor, dout: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dout * out) per head, (b, h, s_q) fp32: the backward
    kernels' input that the TPU's VJP also computes outside its kernels
    (flash_attention.py `di`)."""
    b, s_q, inner = out.shape
    prod = dout.float() * out.float()
    return prod.view(b, s_q, num_heads, inner // num_heads).sum(-1).transpose(1, 2).contiguous()


def _launch_backward(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, num_heads: int, scale: float,
) -> T.Tuple[torch.Tensor, ...]:
    """Launch backward kernel `name` ("attention_dkv" -> (dk, dv),
    "attention_dq" -> (dq,)) on checked CUDA operands into new outputs, on
    the current stream; raises if the launch is refused."""
    b, s_q, inner = q.shape
    rows = k.shape if name == "attention_dkv" else q.shape
    outs = tuple(torch.empty(rows, dtype=q.dtype, device=q.device)
                 for _ in range(2 if name == "attention_dkv" else 1))
    fn = build_kernels((name,))[name].fn
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        dout.stride(0), dout.stride(1), outs[0].stride(0), outs[0].stride(1),
        b, s_q, k.shape[1], num_heads, inner // num_heads, float(scale),
        _KERNEL_DTYPES[q.dtype], q.device.index, _stream(q),
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    return outs


def attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
    lse: T.Optional[torch.Tensor], *, num_heads: int, scale: float,
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `attention` for its output `out` and the output's
    gradient `dout`. For CUDA tensors: the dK/dV kernel (csrc/attention_dkv.cu)
    and the dQ kernel (csrc/attention_dq.cu), which recompute the
    probabilities from `lse`, the forward's (b, h, s_q) log-sum-exp. For CPU
    tensors: `attention_backward_reference` (`lse` is not used)."""
    _validate(q, k, v, num_heads)
    if q.device.type == "cpu":
        COUNTS.plain_calls += 1
        return attention_backward_reference(q, k, v, out, dout, num_heads=num_heads, scale=scale)
    dout = dout.to(q.dtype)
    if dout.stride(2) != 1 or dout.stride(0) % 8 or dout.stride(1) % 8 or dout.data_ptr() % 16:
        dout = dout.contiguous()
    _check_operands("attention_backward", q=q, k=k, v=v, dout=dout)
    b, s_q, _ = q.shape
    if lse is None or lse.shape != (b, num_heads, s_q) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("the backward kernels need the forward's (b, h, s_q) fp32 log-sum-exp")
    delta = backward_delta(out, dout, num_heads)
    dk, dv = _launch_backward("attention_dkv", q, k, v, dout, lse, delta, num_heads, scale)
    COUNTS.bwd_dkv_launches += 1
    (dq,) = _launch_backward("attention_dq", q, k, v, dout, lse, delta, num_heads, scale)
    COUNTS.bwd_dq_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """`attention` with its gradient: K1 writing the log-sum-exp and the two
    backward kernels on CUDA, the plain forward and backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        lse = None
        if q.device.type == "cpu":
            COUNTS.plain_calls += 1
            out = attention_reference(q, k, v, num_heads=num_heads, scale=scale)
        else:
            b, s_q, _ = q.shape
            lse = torch.empty((b, num_heads, s_q), dtype=torch.float32, device=q.device)
            out = _launch("attention", q, k, v, num_heads, scale, lse=lse)
            COUNTS.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, dout, lse, num_heads=ctx.num_heads,
                                        scale=ctx.scale)
        return dq, dk, dv, None, None


class _RowAttention(torch.autograd.Function):
    """`row_attention` on CUDA with its gradient: K2 forward, and the plain
    recompute (autograd through `attention_reference`) backward, as the JAX
    package's full_row_attention VJP."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        out = _launch("row_attention", q, k, v, num_heads, scale)
        COUNTS.row_launches += 1
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.scale = num_heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            out = attention_reference(q, k, v, num_heads=ctx.num_heads, scale=ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return dq, dk, dv, None, None


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int, scale: float
) -> torch.Tensor:
    """softmax(q k^T * scale) v over (b, s, h*d) operands through K1's
    kernel (csrc/attention.cu) for CUDA tensors (bf16 or fp32), the plain
    version for CPU tensors; differentiable (`attention_backward`).
    head_dim = inner / num_heads must be a multiple of 8, at most 128."""
    _validate(q, k, v, num_heads)
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, num_heads, scale)
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
    `attention`; ragged s_q and s_kv are masked. Differentiable, by the
    plain recompute."""
    _validate(q, k, v, num_heads)
    if q.device.type == "cpu":
        COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    if _needs_grad(q, k, v):
        return _RowAttention.apply(q, k, v, num_heads, scale)
    out = _launch("row_attention", q, k, v, num_heads, scale)
    COUNTS.row_launches += 1
    return out
