"""
Multi-head attention over the packed (b, s, h*d) layout: the hand-written
Hopper kernels, their plain PyTorch versions, and the gate that picks one
of them at each UNet attention site.

`attention(q, k, v, num_heads=..., scale=...)` and `row_attention(...)`
compute softmax(q k^T * scale) v per head, with q, k, v and the output in
the layout the to_q / to_k / to_v projections emit. They port the JAX
package's Pallas attention kernels:

- `attention` (csrc/attention.cu) is K1, jax's TPU flash_attention called
  from riffusion_tpu/models/layers.py. Its bf16 forward without the
  log-sum-exp runs the warp-specialised body (csrc/attention_fwd_ws.cuh)
  at the head widths of `kernels.K1_WS_HEAD_DIMS` (40, 64, 80), chosen
  here by the width and counted in COUNTS.k1_ws_launches; every other call
  runs csrc/attention_fwd.cuh's body. Its gradient is two more kernels,
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

ops/kernels.py builds and loads the kernels, and the wrappers count in its
COUNTS; `attention_reference` and `attention_backward_reference` called
directly count nothing. Both forward kernels launch on the current stream,
so a CUDA graph's capture records them like any torch operation.
"""

from __future__ import annotations

import contextlib
import threading
import typing as T

import torch

from riffusion_tpu_torch.ops import kernels

__all__ = [
    "attention", "row_attention", "attention_backward", "attention_reference",
    "attention_backward_reference", "compare_to_plain", "backward_delta", "compare_grads_to_plain",
    "kernel_takes_head_dim", "k1_ws_body", "route", "route_batch", "routed_batch", "TOLERANCE",
    "GRAD_TOLERANCE",
]

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


def k1_ws_body(head_dim: int, dtype: torch.dtype, lse: bool) -> bool:
    """Whether K1 runs the warp-specialised body: bf16 without the
    log-sum-exp at a width of kernels.K1_WS_HEAD_DIMS."""
    return dtype == torch.bfloat16 and not lse and head_dim in kernels.K1_WS_HEAD_DIMS


def _launch(
    name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int, scale: float,
    lse: T.Optional[torch.Tensor] = None, ws_body: bool = False,
) -> torch.Tensor:
    """Launch forward kernel `name` on CUDA operands (checked here) into a
    new output, on the current stream, writing the rows' log-sum-exp into
    `lse` ((b, h, s_q) fp32) when it is given; K1 through its
    warp-specialised body where `ws_body`. Raises if the launch is
    refused."""
    _check_operands(name, q=q, k=k, v=v)
    b, s_q, inner = q.shape
    out = torch.empty((b, s_q, inner), dtype=q.dtype, device=q.device)
    fn = kernels.entry(name)
    body = (int(ws_body),) if name == "attention" else ()
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        b, s_q, k.shape[1], num_heads, inner // num_heads, float(scale),
        _KERNEL_DTYPES[q.dtype], q.device.index, _stream(q), *body,
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
    fn = kernels.entry(name)
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
        kernels.COUNTS.plain_calls += 1
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
    kernels.COUNTS.bwd_dkv_launches += 1
    (dq,) = _launch_backward("attention_dq", q, k, v, dout, lse, delta, num_heads, scale)
    kernels.COUNTS.bwd_dq_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """`attention` with its gradient: K1 writing the log-sum-exp and the two
    backward kernels on CUDA, the plain forward and backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        lse = None
        if q.device.type == "cpu":
            kernels.COUNTS.plain_calls += 1
            out = attention_reference(q, k, v, num_heads=num_heads, scale=scale)
        else:
            b, s_q, _ = q.shape
            lse = torch.empty((b, num_heads, s_q), dtype=torch.float32, device=q.device)
            out = _launch("attention", q, k, v, num_heads, scale, lse=lse)
            kernels.COUNTS.launches += 1
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
        kernels.COUNTS.row_launches += 1
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
        kernels.COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    ws_body = k1_ws_body(q.shape[2] // num_heads, q.dtype, lse=False)
    out = _launch("attention", q, k, v, num_heads, scale, ws_body=ws_body)
    kernels.COUNTS.launches += 1
    kernels.COUNTS.k1_ws_launches += ws_body
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
        kernels.COUNTS.plain_calls += 1
        return attention_reference(q, k, v, num_heads=num_heads, scale=scale)
    if _needs_grad(q, k, v):
        return _RowAttention.apply(q, k, v, num_heads, scale)
    out = _launch("row_attention", q, k, v, num_heads, scale)
    kernels.COUNTS.row_launches += 1
    return out
