"""
The port's attention (riffusion_tpu_torch/ops/attention.py) against the JAX
package: the plain version against the full-row Pallas kernel (interpret
mode) and its einsum reference, the port's `Attention` module against the
JAX `Attention` on the CPU (its "pref" einsum path, which is what the JAX
tests run at the flash sites), validation and the launch counters, and
the tolerance the kernel is held to on the card against planted faults. The
Hopper kernel against the plain version on a card is in
tests/test_torch_attention_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.models import layers as jax_layers
from riffusion_tpu.models.layers import Attention as JaxAttention
from riffusion_tpu.ops.attention import _reference, full_row_attention
from riffusion_tpu_torch.models.layers import Attention
from riffusion_tpu_torch.models.weights import state_dict_from_jax
from riffusion_tpu_torch.ops import attention as attn_mod
from riffusion_tpu_torch.ops.attention import (
    COUNTS,
    TOLERANCE,
    attention,
    attention_reference,
    compare_to_plain,
    route,
    row_attention,
)


def _qkv(rng, b, s, h, d, scale=1.0, s_kv=None):
    s_kv = s if s_kv is None else s_kv
    q = (scale * rng.standard_normal((b, s, h * d))).astype(np.float32)
    k = (scale * rng.standard_normal((b, s_kv, h * d))).astype(np.float32)
    v = rng.standard_normal((b, s_kv, h * d)).astype(np.float32)
    return q, k, v


# The tests/test_rowattn.py cases. In f32 both sides compute the same
# composition in the same precision; 2e-6 is the f32 tolerance the JAX
# package holds its own kernel to.
@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
def test_plain_version_matches_jax_f32(against):
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 256, 3, 40
    q, k, v = _qkv(rng, b, s, h, d)
    scale = 1 / np.sqrt(d)
    if against == "reference":
        ref = _reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, scale)
    else:
        ref = full_row_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            num_heads=h, scale=scale, block_q=128, interpret=True,
        )
    out = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), num_heads=h, scale=scale
    )
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = float(np.max(np.abs(out.numpy() - np.asarray(ref))))
    assert err < 2e-6, err


def test_plain_version_large_logits_stable():
    """Logits of size ~3e4: the softmax's max subtraction keeps it finite.
    1e-4 as in tests/test_rowattn.py (the logits are large, so f32 rounding
    of the logits themselves is ~1e-3 relative to 1 in the exponent)."""
    rng = np.random.default_rng(1)
    b, s, h, d = 1, 128, 1, 40
    q, k, v = _qkv(rng, b, s, h, d, scale=30.0)
    out = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), num_heads=h, scale=1.0
    )
    assert torch.isfinite(out).all()
    ref = _reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, 1.0)
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < 1e-4


@pytest.mark.parametrize(
    "lq,context_len,expect_wrapper",
    [(256, None, True), (64, None, False), (256, 7, False)],
    ids=["self-kernel-site", "self-short", "cross"],
)
def test_attention_module_matches_jax(lq, context_len, expect_wrapper):
    """The port's Attention with the JAX module's weights. fp64 on both
    sides (the wiring-oracle convention): the two compute the same
    composition, so they agree to ~1e-12; 1e-9 leaves room for sum order."""
    heads, head_dim, query_dim, ctx_dim = 2, 16, 24, 12
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, lq, query_dim))
    ctx = None if context_len is None else rng.standard_normal((2, context_len, ctx_dim))
    with jax.enable_x64(True):
        module = JaxAttention(heads, head_dim, query_dim, dtype=jnp.float64, flash=False)
        args = (jnp.asarray(x),) + (() if ctx is None else (jnp.asarray(ctx),))
        params = module.init(jax.random.PRNGKey(0), *args)["params"]
        params = jax.tree.map(lambda p: np.asarray(p, np.float64), params)
        params = jax.tree.map(lambda p: p + 0.01 * rng.standard_normal(p.shape), params)
        ref = np.asarray(module.apply({"params": params}, *args))

    port = Attention(query_dim, heads, head_dim, query_dim,
                     context_dim=None if ctx is None else ctx_dim).to(torch.float64)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    COUNTS.reset()
    with torch.no_grad():
        out = port(torch.from_numpy(x), None if ctx is None else torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)
    # on the CPU the wrapper takes the plain version and never the kernel
    assert COUNTS.launches == 0
    assert COUNTS.plain_calls == (1 if expect_wrapper else 0)


def test_wrapper_validation():
    q = torch.zeros(1, 8, 30)
    with pytest.raises(ValueError, match="not divisible"):
        attention(q, q, q, num_heads=4, scale=1.0)
    q = torch.zeros(1, 8, 36)  # head_dim 12: not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        attention(q, q, q, num_heads=3, scale=1.0)
    q = torch.zeros(1, 8, 272)  # head_dim 136 > 128
    with pytest.raises(ValueError, match="at most 128"):
        attention(q, q, q, num_heads=2, scale=1.0)
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="shape mismatch"):
        attention(q, torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), num_heads=2, scale=1.0)
    with pytest.raises(ValueError, match="dtype mismatch"):
        attention(q, q.double(), q, num_heads=2, scale=1.0)
    with pytest.raises(ValueError, match=r"\(b, s, h\*d\)"):
        attention(q[0], q[0], q[0], num_heads=2, scale=1.0)


def test_cpu_wrapper_counts_plain_calls_only():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 40, 2, 8, s_kv=24))
    COUNTS.reset()
    out = attention(q, k, v, num_heads=2, scale=0.3)
    ref = attention_reference(q, k, v, num_heads=2, scale=0.3)
    assert torch.equal(out, ref)
    assert (COUNTS.launches, COUNTS.plain_calls) == (0, 1)


def test_kernel_source_is_shipped():
    for source, entry in attn_mod.KERNELS.values():
        assert source.is_file()
        assert entry in source.read_text()
        # the forward body (attention_fwd.cuh: K1 and K2) or the backward's;
        # both include attention_common.cuh and hopper.cuh
        assert any(f'#include "{body}"' in source.read_text()
                   for body in ("attention_fwd.cuh", "attention_bwd.cuh"))
    for name in ("attention", "row_attention"):  # one bf16 forward body
        assert '#include "attention_fwd.cuh"' in attn_mod.KERNELS[name][0].read_text()
    assert (attn_mod._CSRC / "attention_common.cuh").is_file()
    for body in ("attention_fwd.cuh", "attention_bwd.cuh"):
        text = (attn_mod._CSRC / body).read_text()
        assert '#include "attention_common.cuh"' in text and '#include "hopper.cuh"' in text


def _kernel_numerics(q, k, v, num_heads, scale, *, tail_logit_zero=False, skip_tile=None,
                     fold_q_bf16=False, wrong_head=False, no_rescale=False, lse=False,
                     lse_fault=None):
    """The bf16 arithmetic of csrc/attention_fwd.cuh, the body K1
    (csrc/attention.cu) and K2 (csrc/row_attention.cu) run, in PyTorch:
    fp32 logits, an online softmax over 64-row K/V tiles in the log2 domain
    with the running max in logit units and the scale*log2(e) fold in fp32
    (s * c - m * c), unnormalized weights rounded to bf16 for P V, fp32
    accumulation, the division after P V, a bf16 output. With `lse`, also
    K1's log-sum-exp, (b, h, s_q) fp32: m * scale + log(row sum), natural
    log. Flags plant faults: the zero-padded keys of the ragged last tile
    get logit 0 instead of -inf, one K/V tile is skipped, Q is read from the
    next head's columns, the fold is made into Q in bf16 as the TPU kernel
    makes it, or O is not rescaled when the running max moves (the row sum
    still is); `lse_fault` writes the LSE in log2 units ("log2 units"), into
    the next head's rows ("next head"), or swaps the two rows, g and g + 8,
    each thread of the kernel holds ("rows swapped")."""
    b, s_q, inner = q.shape
    d = inner // num_heads

    def heads(x):
        return x.float().reshape(b, x.shape[1], num_heads, d).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    if wrong_head:
        qh = qh.roll(1, dims=1)
    c = scale * math.log2(math.e)
    if fold_q_bf16:
        qh, c = (qh * c).to(torch.bfloat16).float(), 1.0
    if tail_logit_zero:
        pad = torch.zeros(b, num_heads, -kh.shape[2] % 64, d)
        kh, vh = torch.cat([kh, pad], 2), torch.cat([vh, pad], 2)
    row_max = torch.full((b, num_heads, s_q, 1), -math.inf)  # logit units
    row_sum = torch.zeros(b, num_heads, s_q, 1)
    acc = torch.zeros(b, num_heads, s_q, d)
    for tile, n0 in enumerate(range(0, kh.shape[2], 64)):
        if tile == skip_tile:
            continue
        logits = qh @ kh[:, :, n0:n0 + 64].transpose(-1, -2)
        new_max = torch.maximum(row_max, logits.amax(-1, keepdim=True))
        alpha, p = torch.exp2((row_max - new_max) * c), torch.exp2(logits * c - new_max * c)
        row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
        if not no_rescale:
            acc = acc * alpha
        acc = acc + p.to(torch.bfloat16).float() @ vh[:, :, n0:n0 + 64]
        row_max = new_max
    out = (acc / row_sum).transpose(1, 2).reshape(b, s_q, inner).to(torch.bfloat16)
    if not lse:
        return out
    if lse_fault == "log2 units":
        lse_rows = row_max * c + torch.log2(row_sum)
    else:
        lse_rows = row_max * scale + torch.log(row_sum)
    lse_rows = lse_rows[..., 0]
    if lse_fault == "next head":  # head h's rows written where head h + 1's belong
        lse_rows = lse_rows.roll(1, dims=1)
    if lse_fault == "rows swapped":
        rows = torch.arange(s_q)
        lse_rows = lse_rows[..., torch.where((rows ^ 8) < s_q, rows ^ 8, rows)]
    return out, lse_rows


def _bf16_case(s_q, s_kv, h, d, seed=4, mult=1.0):
    """The smoke's bf16 operands: q and k normal with std `mult`, v uniform
    in [-1, 1)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(mult * rng.standard_normal((1, s_q, h * d))).to(torch.bfloat16)
    k = torch.from_numpy(mult * rng.standard_normal((1, s_kv, h * d))).to(torch.bfloat16)
    v = torch.from_numpy(rng.uniform(-1, 1, (1, s_kv, h * d))).to(torch.bfloat16)
    return q, k, v


# (256, 4096, 2, 40) is K2's path row: its K/V length and head width, with
# fewer query rows.
BF16_CASES = [(1024, 1024, 2, 40), (1000, 1000, 2, 16), (1000, 777, 2, 128), (256, 4096, 2, 40)]


@pytest.mark.parametrize("s_q,s_kv,h,d", BF16_CASES,
                         ids=["d40", "ragged-d16", "ragged-d128", "path-row-d40"])
def test_bf16_tolerance_admits_the_kernels_rounding(s_q, s_kv, h, d):
    q, k, v = _bf16_case(s_q, s_kv, h, d)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(_kernel_numerics(q, k, v, h, d**-0.5), ref)
    assert ok, (max_abs, rel_rms)


@pytest.mark.parametrize(
    "s_q,s_kv,h,d,fault",
    [(1000, 1000, 2, 16, "tail"), (1000, 777, 2, 128, "tail"),
     (1000, 1000, 2, 16, "skip"), (1024, 1024, 2, 40, "skip"),
     (256, 4096, 2, 40, "rescale"), (1000, 777, 2, 128, "rescale")],
    ids=["tail-logit-0-d16", "tail-logit-0-d128", "skipped-tile-d16", "skipped-tile-d40",
         "o-not-rescaled-path-row-d40", "o-not-rescaled-ragged-d128"],
)
def test_bf16_tolerance_rejects_a_planted_fault(s_q, s_kv, h, d, fault):
    q, k, v = _bf16_case(s_q, s_kv, h, d)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    out = _kernel_numerics(q, k, v, h, d**-0.5, tail_logit_zero=fault == "tail",
                           skip_tile=3 if fault == "skip" else None,
                           no_rescale=fault == "rescale")
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert not ok, (max_abs, rel_rms)
    if fault == "tail":  # max abs alone passes it: the relative RMS bound is what fails it
        assert max_abs <= TOLERANCE[torch.bfloat16][0]


@pytest.mark.parametrize("mult", [1.0, 8.0], ids=["normal", "large-logits"])
def test_bf16_tolerance_admits_the_folded_arithmetic(mult):
    """K2's fold made in fp32 (one FFMA per logit in row_attention.cu) stays
    inside the bf16 tolerance at large logits; the TPU kernel's fold into Q
    in bf16 does not (0.13-0.18 max abs at std-8 operands), which is why the
    Hopper kernel keeps the fold in fp32."""
    q, k, v = _bf16_case(1024, 1024, 2, 40, seed=7, mult=mult)
    ref = attention_reference(q, k, v, num_heads=2, scale=40**-0.5)
    assert compare_to_plain(_kernel_numerics(q, k, v, 2, 40**-0.5), ref)[2]
    max_abs, rel_rms, ok = compare_to_plain(
        _kernel_numerics(q, k, v, 2, 40**-0.5, fold_q_bf16=True), ref)
    assert ok == (mult == 1.0), (max_abs, rel_rms)


@pytest.mark.parametrize("s_q,s_kv,h,d", [(1024, 1024, 2, 40), (1000, 1000, 2, 16)],
                         ids=["d40", "ragged-d16"])
def test_bf16_tolerance_rejects_q_from_the_wrong_head(s_q, s_kv, h, d):
    q, k, v = _bf16_case(s_q, s_kv, h, d)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(
        _kernel_numerics(q, k, v, h, d**-0.5, wrong_head=True), ref)
    assert not ok, (max_abs, rel_rms)


# K1's log-sum-exp (the body's LSE write: m * scale + log(row sum) after the
# online softmax over 64-row K/V tiles) against logsumexp of the fp32
# logits, per head: at the path's width, at a ragged s_kv (the last tile
# masked) and at large logits. 1e-4: the same fp32 arithmetic in another
# order (the card's check allows 1e-3 for ex2.approx).
@pytest.mark.parametrize("s_q,s_kv,h,d,mult", [(1024, 1024, 2, 40, 1.0), (1000, 777, 2, 128, 1.0),
                                               (333, 1000, 3, 16, 4.0)],
                         ids=["d40", "ragged-d128", "large-logits-d16"])
def test_kernel_lse_matches_logsumexp(s_q, s_kv, h, d, mult):
    q, k, v = _bf16_case(s_q, s_kv, h, d, mult=mult)
    out, lse = _kernel_numerics(q, k, v, h, d**-0.5, lse=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float().reshape(1, s_q, h, d),
                          k.float().reshape(1, s_kv, h, d)) * d**-0.5
    assert lse.shape == (1, h, s_q) and lse.dtype == torch.float32
    assert float((lse - torch.logsumexp(logits, dim=-1)).abs().max()) < 1e-4
    assert torch.equal(out, _kernel_numerics(q, k, v, h, d**-0.5))


@pytest.mark.parametrize("fault", ["log2 units", "next head", "rows swapped"])
def test_lse_check_rejects_a_planted_fault(fault):
    """The LSE faults chip_smoke.py plants in the body fail the card's LSE
    bound (1e-3 max abs against logsumexp)."""
    s_q, s_kv, h, d = 1000, 777, 2, 40
    q, k, v = _bf16_case(s_q, s_kv, h, d)
    _, lse = _kernel_numerics(q, k, v, h, d**-0.5, lse=True, lse_fault=fault)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float().reshape(1, s_q, h, d),
                          k.float().reshape(1, s_kv, h, d)) * d**-0.5
    assert float((lse - torch.logsumexp(logits, dim=-1)).abs().max()) > 1e-3


# K2's plain version (the CPU path of `row_attention`) against the JAX
# full-row kernel in interpret mode, as tests/test_rowattn.py runs it: fp32
# within 2e-6, bf16 within 2e-2 (both round the weights and output to bf16,
# at different points), large logits in fp32 within 1e-4.
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_row_attention_plain_matches_jax_kernel(dtype, tol):
    rng = np.random.default_rng(8)
    b, s, h, d = 2, 256, 3, 40
    q, k, v = _qkv(rng, b, s, h, d)
    ref = full_row_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), num_heads=h, scale=d**-0.5, block_q=128,
        interpret=True,
    )
    tdtype = getattr(torch, dtype)
    COUNTS.reset()
    out = row_attention(*(torch.from_numpy(x).to(tdtype) for x in (q, k, v)), num_heads=h,
                        scale=d**-0.5)
    assert (COUNTS.launches, COUNTS.row_launches, COUNTS.plain_calls) == (0, 0, 1)
    assert out.dtype == tdtype and out.shape == tuple(ref.shape)
    err = float(np.max(np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32)))))
    assert err < tol, err


def test_row_attention_plain_large_logits_matches_jax_kernel():
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 128, 1, 40, scale=30.0)
    ref = full_row_attention(*(jnp.asarray(x) for x in (q, k, v)), num_heads=1, scale=1.0,
                             block_q=64, interpret=True)
    out = row_attention(*(torch.from_numpy(x) for x in (q, k, v)), num_heads=1, scale=1.0)
    assert torch.isfinite(out).all()
    assert float(np.max(np.abs(out.numpy() - np.asarray(ref)))) < 1e-4


def _jax_route(b, lq, d, self_attention):
    """The JAX package's choice at one Attention call (models/layers.py
    use_rowattn and use_flash, on a TPU), from its own constants."""
    L = jax_layers
    window = lq >= L.EINSUM_SEQ_MIN and L.EINSUM_B_LO < b < L.EINSUM_B_HI
    if self_attention and window and lq % L.ROWATTN_BLOCK_Q == 0 and d <= 128:
        return "row"
    d_pad = 64 if d <= 64 else (128 if d <= 128 else 256)
    if self_attention and lq >= 256 and d_pad <= L.FLASH_MAX_DPAD and not window:
        return "flash"
    return "plain"


def test_route_matches_the_jax_gate():
    """Over batches, sequence lengths (including ragged ones inside the
    row window), the SD v1 head widths and self/cross attention."""
    seen = set()
    for b in (1, 2, 8, 9, 10, 16, 32, 64):
        for lq in (64, 255, 256, 1024, 2047, 2048, 2500, 3072, 4096, 16384):
            for d in (16, 40, 80, 128, 160):
                for self_attention in (True, False):
                    want = _jax_route(b, lq, d, self_attention)
                    assert route(b, lq, d, self_attention) == want, (b, lq, d, self_attention)
                    seen.add(want)
    assert seen == {"row", "flash", "plain"}
    # the serving shapes: batch 16 (UNet batch 32) and the single clip (2)
    assert route(32, 4096, 40, True) == "row" and route(32, 1024, 80, True) == "flash"
    assert route(2, 4096, 40, True) == "flash" and route(32, 4096, 40, False) == "plain"


def test_row_attention_wrapper_validation():
    q = torch.zeros(1, 8, 36)
    with pytest.raises(ValueError, match="multiple of 8"):
        row_attention(q, q, q, num_heads=3, scale=1.0)
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="shape mismatch"):
        row_attention(q, torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), num_heads=2, scale=1.0)
