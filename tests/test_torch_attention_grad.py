"""
The gradient of the port's attention (riffusion_tpu_torch/ops/attention.py)
on the CPU against the JAX package's:

- the plain backward (`attention_backward_reference`, what `attention`'s
  gradient runs for CPU tensors) against jax.vjp of riffusion_tpu/ops/
  attention.py `_reference` in fp32 (2e-5 of the gradient's RMS: another
  sum order over a few hundred terms), against jax.vjp of a whole JAX
  attention site in fp64 (1e-10), and against jax's own mha_reference_bwd
  (sm_scale 1 only, so the scale is folded into q);
- `row_attention`'s gradient (the plain recompute) against jax.vjp of
  full_row_attention in interpret mode;
- a CPU emulation of the backward kernels' bf16 arithmetic (P and dS
  rounded to bf16 for the products that take them, fp32 accumulation, the
  LSE from the forward) held to GRAD_TOLERANCE, with four planted faults
  that the check must reject.

The kernels themselves run only on the card: tests/test_torch_attention_cuda.py
and chip_smoke.py hold them to the plain backward there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jax_flash

from test_torch_attention import _kernel_numerics
from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.models.layers import Attention as JaxAttention
from riffusion_tpu.ops.attention import _reference, full_row_attention
from riffusion_tpu_torch.models.layers import Attention
from riffusion_tpu_torch.models.weights import state_dict_from_jax
from riffusion_tpu_torch.ops import attention as attn


def _inputs(b, s_q, s_kv, h, d, dtype=np.float32, seed=0, logit_mult=1.0):
    """q, k ~ N(0, 1) (times `logit_mult`), v ~ N(1, 1): a mean away from 0
    so that O, and with it delta = rowsum(dO * O), is not small next to dP
    (otherwise a backward that drops -delta would hide in the noise), and
    dO ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    inner = h * d
    q = logit_mult * rng.standard_normal((b, s_q, inner))
    k = logit_mult * rng.standard_normal((b, s_kv, inner))
    v = rng.standard_normal((b, s_kv, inner)) + 1.0
    dout = rng.standard_normal((b, s_q, inner))
    return tuple(x.astype(dtype) for x in (q, k, v, dout))


def _jax_vjp(fn, q, k, v, dout):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("shape", [(2, 96, 96, 2, 16), (1, 70, 45, 3, 40)],
                         ids=["square", "ragged"])
def test_attention_gradient_matches_jax_vjp(shape):
    """`attention`'s gradient on CPU tensors (the plain backward) against
    jax.vjp of the JAX package's einsum reference, in fp32 (its logits are
    fp32 whatever the operands): 2e-5 of each gradient's RMS."""
    b, s_q, s_kv, h, d = shape
    scale = d ** -0.5
    q, k, v, dout = _inputs(b, s_q, s_kv, h, d)
    out_j, grads_j = _jax_vjp(lambda q, k, v: _reference(q, k, v, h, scale), q, k, v, dout)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = attn.COUNTS.plain_calls
    out = attn.attention(qt, kt, vt, num_heads=h, scale=scale)
    out.backward(torch.from_numpy(dout))
    assert attn.COUNTS.plain_calls == before + 2  # the plain forward and backward
    assert _rel_rms(out.detach().numpy(), out_j) < 2e-5
    for name, g, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        assert g.dtype == qt.dtype
        assert _rel_rms(g.numpy(), ref) < 2e-5, name


@pytest.mark.parametrize("context_len", [None, 7], ids=["self-kernel-site", "cross"])
def test_attention_site_gradient_matches_jax_in_fp64(context_len):
    """A whole attention site in fp64 (the wiring-oracle convention): the
    port's Attention module, whose self-attention at 256 queries takes
    `attention` and with it the plain backward, against jax.vjp of the JAX
    module (its "pref" path) with the same weights, for the input, the
    context and every weight. The two compute the same composition: 1e-10."""
    heads, head_dim, query_dim, ctx_dim, lq = 2, 16, 24, 12, 256
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, lq, query_dim))
    ctx = None if context_len is None else rng.standard_normal((2, context_len, ctx_dim))
    g = rng.standard_normal((2, lq, query_dim))
    with jax.enable_x64(True):
        module = JaxAttention(heads, head_dim, query_dim, dtype=jnp.float64, flash=False)
        args = (jnp.asarray(x),) + (() if ctx is None else (jnp.asarray(ctx),))
        params = module.init(jax.random.PRNGKey(0), *args)["params"]
        params = jax.tree.map(lambda p: np.asarray(p, np.float64)
                              + 0.01 * rng.standard_normal(p.shape), params)
        _, vjp = jax.vjp(lambda p, *a: module.apply({"params": p}, *a), params, *args)
        grads_j = vjp(jnp.asarray(g))
    port = Attention(query_dim, heads, head_dim, query_dim,
                     context_dim=None if ctx is None else ctx_dim).to(torch.float64)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    inputs = [torch.from_numpy(a).requires_grad_() for a in
              ([x] if ctx is None else [x, ctx])]
    before = attn.COUNTS.plain_calls
    port(*inputs).backward(torch.from_numpy(g))
    # the kernel site's forward and backward go through the wrapper
    assert attn.COUNTS.plain_calls == before + (2 if ctx is None else 0)
    for t, ref in zip(inputs, grads_j[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-10)
    ref_params = state_dict_from_jax(jax.tree.map(np.asarray, grads_j[0]))
    for name, param in port.named_parameters():
        np.testing.assert_allclose(param.grad.numpy(), ref_params[name].numpy(), rtol=0,
                                   atol=1e-10, err_msg=name)


def test_plain_backward_matches_mha_reference_bwd():
    """The explicit formulas against jax's mha_reference_bwd on (b, h, s, d)
    operands. It takes sm_scale 1 only, so the scale is folded into q (and
    dq carries it back)."""
    b, s_q, s_kv, h, d = 2, 64, 80, 2, 32
    scale = d ** -0.5
    q, k, v, dout = _inputs(b, s_q, s_kv, h, d)

    def bhsd(x):
        return jnp.asarray(x.reshape(b, x.shape[1], h, d).transpose(0, 2, 1, 3))

    qs = bhsd(q * scale)
    out, l, m = jax_flash.mha_reference_no_custom_vjp(
        qs, bhsd(k), bhsd(v), None, None, save_residuals=True)
    dq_j, dk_j, dv_j, _ = jax_flash.mha_reference_bwd(
        qs, bhsd(k), bhsd(v), None, None, out, l, m, bhsd(dout))
    out_t = np.asarray(out).transpose(0, 2, 1, 3).reshape(b, s_q, h * d)
    dq, dk, dv = attn.attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v, out_t, dout)), num_heads=h, scale=scale)

    def packed(x):
        return np.asarray(x).transpose(0, 2, 1, 3).reshape(b, -1, h * d)

    assert _rel_rms(dq.numpy(), packed(dq_j) * scale) < 2e-5
    assert _rel_rms(dk.numpy(), packed(dk_j)) < 2e-5
    assert _rel_rms(dv.numpy(), packed(dv_j)) < 2e-5


def test_row_attention_gradient_matches_jax():
    """K2's gradient is the plain recompute in both packages:
    full_row_attention's VJP (interpret mode) against `row_attention`'s on
    CPU tensors. fp32: 2e-5 of each gradient's RMS."""
    b, s, h, d = 2, 256, 2, 16
    scale = d ** -0.5
    q, k, v, dout = _inputs(b, s, s, h, d)
    out_j, grads_j = _jax_vjp(
        lambda q, k, v: full_row_attention(q, k, v, num_heads=h, scale=scale, block_q=128,
                                           interpret=True), q, k, v, dout)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = attn.row_attention(qt, kt, vt, num_heads=h, scale=scale)
    out.backward(torch.from_numpy(dout))
    # the TPU kernel's forward folds scale * log2(e) into q in the operands'
    # dtype, so the forward agrees to fp32 rounding of that fold
    assert _rel_rms(out.detach().numpy(), out_j) < 1e-5
    for name, g, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        assert _rel_rms(g.numpy(), ref) < 2e-5, name


def test_no_grad_call_is_the_serving_call():
    """A call whose operands need no gradient is today's serving call: no
    autograd graph, one plain call on the CPU."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 64, 64, 2, 16))
    before = attn.COUNTS.plain_calls
    with torch.inference_mode():
        out = attn.attention(q, k, v, num_heads=2, scale=0.25)
    assert out.grad_fn is None and attn.COUNTS.plain_calls == before + 1


# ------------------------------------------- the backward kernels' arithmetic


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_backward(q, k, v, out, dout, lse, num_heads, scale, fault=None):
    """The backward kernels' arithmetic on bf16 operands (given as bf16
    tensors), in fp32: P = exp2(S * scale * log2 e - LSE * log2 e) from the
    forward's LSE; dV = P^T dO with P rounded to bf16; dS = P * (dP - delta)
    rounded to bf16 for dK = scale * dS^T Q and dQ = scale * dS K; outputs
    rounded to bf16. `fault` plants one of the faults the check must catch."""
    b, s_q, inner = q.shape
    d = inner // num_heads

    def heads(x):
        return x.float().reshape(b, x.shape[1], num_heads, d)

    qh, kh, vh, doh = (heads(x) for x in (q, k, v, dout))
    lse = lse.float()
    if fault == "lse of the wrong head":
        lse = lse.roll(-1, dims=1)
    log2e = 1.4426950408889634
    c = np.float32(scale * log2e)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    p = torch.exp2(s * c - (lse * log2e)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", doh, vh)
    delta = attn.backward_delta(out, dout, num_heads)
    ds = p * dp if fault == "dS without -delta" else p * (dp - delta[..., None])
    p_kv, ds_kv = _bf16(p), _bf16(ds)
    if fault == "a skipped Q tile in dK/dV":  # the dK/dV kernel's fourth 64-row Q tile
        keep = torch.ones(s_q)
        keep[192:256] = 0
        p_kv, ds_kv = p_kv * keep[:, None], ds_kv * keep[:, None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kv, doh)
    dk_scale = 1.0 if fault == "dK without the scale" else scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_kv, qh) * dk_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kh) * scale
    return tuple(x.reshape(b, x.shape[1], inner).to(torch.bfloat16) for x in (dq, dk, dv))


def _bf16_case(b, s, h, d, logit_mult=1.0, seed=0):
    """bf16 operands, the plain forward's output (bf16) and its LSE."""
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _inputs(b, s, s, h, d, seed=seed, logit_mult=logit_mult))
    scale = d ** -0.5
    out = attn.attention_reference(q, k, v, num_heads=h, scale=scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float().reshape(b, s, h, d),
                          k.float().reshape(b, s, h, d)) * scale
    return q, k, v, out, dout, torch.logsumexp(logits, dim=-1), scale


_EMULATED = {
    # name: (b, s, h, d, logit scale on q and k)
    "d40": (1, 1024, 2, 40, 1.0),
    "d80": (1, 512, 2, 80, 1.0),
    "large logits d40": (1, 512, 2, 40, 4.0),
}


@pytest.mark.parametrize("case", list(_EMULATED))
def test_emulated_kernel_backward_within_grad_tolerance(case):
    b, s, h, d, mult = _EMULATED[case]
    q, k, v, out, dout, lse, scale = _bf16_case(b, s, h, d, mult)
    refs = attn.attention_backward_reference(q, k, v, out, dout, num_heads=h, scale=scale)
    grads = emulate_backward(q, k, v, out, dout, lse, h, scale)
    result = attn.compare_grads_to_plain(grads, refs)
    assert all(ok for _, _, ok in result.values()), result


_FAULTS = ["dS without -delta", "a skipped Q tile in dK/dV", "lse of the wrong head",
           "dK without the scale"]


@pytest.mark.parametrize("fault", _FAULTS)
def test_grad_tolerance_rejects_planted_faults(fault):
    b, s, h, d, mult = _EMULATED["d40"]
    q, k, v, out, dout, lse, scale = _bf16_case(b, s, h, d, mult)
    refs = attn.attention_backward_reference(q, k, v, out, dout, num_heads=h, scale=scale)
    grads = emulate_backward(q, k, v, out, dout, lse, h, scale, fault=fault)
    result = attn.compare_grads_to_plain(grads, refs)
    assert not all(ok for _, _, ok in result.values()), result


@pytest.mark.parametrize("lse_fault", [None, "log2 units", "next head", "rows swapped"],
                         ids=["forward-lse", "log2-units", "next-head", "rows-swapped"])
def test_backward_from_the_forward_kernels_lse(lse_fault):
    """What the backward kernels take from K1: its output and log-sum-exp by
    the forward body's arithmetic (test_torch_attention._kernel_numerics),
    at a ragged s_q and s_kv, through the backward kernels' arithmetic,
    within GRAD_TOLERANCE of attention_backward_reference on the same
    output; and rejected with each LSE fault chip_smoke.py plants in the
    forward body."""
    b, s_q, s_kv, h, d = 1, 333, 777, 2, 40
    scale = d ** -0.5
    q, k, v, dout = (torch.from_numpy(x).to(torch.bfloat16)
                     for x in _inputs(b, s_q, s_kv, h, d, seed=3))
    out, lse = _kernel_numerics(q, k, v, h, scale, lse=True, lse_fault=lse_fault)
    refs = attn.attention_backward_reference(q, k, v, out, dout, num_heads=h, scale=scale)
    grads = emulate_backward(q, k, v, out, dout, lse, h, scale)
    result = attn.compare_grads_to_plain(grads, refs)
    assert all(ok for _, _, ok in result.values()) == (lse_fault is None), result
