"""
The Hopper attention kernels (riffusion_tpu_torch/csrc/attention.cu, K1,
csrc/row_attention.cu, K2, and K1's backward, csrc/attention_dkv.cu and
csrc/attention_dq.cu) against their plain PyTorch versions, on a CUDA
card. Every test here is marked `cuda` and skips where torch sees no card;
the kernels have no CPU mode. This file
imports neither jax nor the JAX package, so it runs on a card machine
without them:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_attention_cuda.py
"""

import pytest
import torch

from riffusion_tpu_torch.models.layers import Attention
from riffusion_tpu_torch.ops import attention as attn
from riffusion_tpu_torch.ops.attention import (
    attention,
    attention_backward_reference,
    attention_reference,
    compare_grads_to_plain,
    compare_to_plain,
    row_attention,
)
from riffusion_tpu_torch.ops.kernels import COUNTS

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, b, s_q, s_kv, h, d, dtype, mult=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
    k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
    v = (2 * torch.rand(b, s_kv, h * d, generator=gen, device=dev) - 1).to(dtype)
    return q, k, v


# Each case is held to ops.attention.TOLERANCE (max abs error and error RMS
# over output RMS, per dtype; the reasons are there, and
# tests/test_torch_attention.py shows the bf16 bound fails planted faults).
# K1 runs attention_fwd.cuh's body, as K2 does: 128 query rows per block
# and 64-row K/V tiles, so s_q 65 and 129 and s_kv 191 leave ragged tiles,
# s = 64 is one K/V tile, read as soon as its copies land, and d = 24 pads
# to 32 for both products.
@pytest.mark.parametrize(
    "b,s_q,s_kv,h,d,dtype,mult",
    [
        (2, 4096, 4096, 8, 40, torch.bfloat16, 1.0),
        (2, 1024, 1024, 8, 80, torch.bfloat16, 1.0),
        (32, 1024, 1024, 8, 80, torch.bfloat16, 1.0),
        (16, 1024, 1024, 8, 80, torch.bfloat16, 1.0),
        (8, 4096, 4096, 8, 40, torch.bfloat16, 1.0),
        (1, 1000, 1000, 2, 16, torch.bfloat16, 1.0),
        (1, 1000, 1000, 2, 32, torch.bfloat16, 1.0),
        (1, 1000, 777, 2, 128, torch.bfloat16, 1.0),
        (1, 1024, 1024, 2, 40, torch.bfloat16, 8.0),
        (2, 300, 300, 3, 32, torch.float32, 1.0),
        (1, 1000, 777, 2, 128, torch.float32, 1.0),
        (2, 129, 191, 2, 40, torch.bfloat16, 1.0),
        (2, 65, 191, 2, 40, torch.bfloat16, 1.0),
        (16, 64, 64, 8, 40, torch.bfloat16, 1.0),
        (3, 300, 257, 2, 24, torch.bfloat16, 1.0),
    ],
    ids=["slice-d40", "slice-d80", "batch16-d80", "batch8-d80", "batch4-d40", "ragged-d16",
         "ragged-d32", "ragged-d128", "large-logits", "f32-d32", "f32-ragged-d128", "edges-d40",
         "edges-s_q65", "one-tile", "d24"],
)
def test_kernel_matches_plain(cuda_device, b, s_q, s_kv, h, d, dtype, mult):
    q, k, v = _qkv(cuda_device, b, s_q, s_kv, h, d, dtype, mult)
    COUNTS.reset()
    out = attention(q, k, v, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (COUNTS.launches, COUNTS.plain_calls) == (1, 0)
    assert out.shape == q.shape and out.dtype == dtype
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


# K1's warp-specialised body (csrc/attention_fwd_ws.cuh), serving's bf16
# forward at d = 40, 64 and 80: SDXL's two sites, then the body's tile
# edges (128 query rows a block, 128-row K/V tiles): s_q and s_kv one short
# of and one past a tile, one K/V tile, a ragged last K/V tile, and a query
# tile whose second consumer has no row to write.
@pytest.mark.parametrize(
    "b,s_q,s_kv,h,d,mult",
    [
        (2, 4096, 4096, 10, 64, 1.0),
        (2, 1024, 1024, 20, 64, 1.0),
        (2, 127, 127, 4, 64, 1.0),
        (2, 129, 129, 4, 64, 1.0),
        (2, 127, 129, 4, 40, 1.0),
        (2, 129, 127, 4, 80, 1.0),
        (3, 200, 128, 2, 64, 1.0),
        (1, 100, 100, 2, 64, 1.0),
        (2, 256, 300, 2, 80, 1.0),
        (2, 65, 1000, 2, 64, 1.0),
        (1, 1024, 1024, 2, 64, 8.0),
    ],
    ids=["sdxl-4096", "sdxl-1024", "s127", "s129", "s_q127-s_kv129-d40", "s_q129-s_kv127-d80",
         "one-kv-tile", "one-short-tile", "ragged-last-d80", "half-query-tile", "large-logits"],
)
def test_warp_specialised_body_matches_plain(cuda_device, b, s_q, s_kv, h, d, mult):
    q, k, v = _qkv(cuda_device, b, s_q, s_kv, h, d, torch.bfloat16, mult)
    COUNTS.reset()
    out = attention(q, k, v, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (COUNTS.launches, COUNTS.k1_ws_launches, COUNTS.plain_calls) == (1, 1, 0)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def test_warp_specialised_body_replays_in_a_graph(cuda_device):
    """The body's tensor maps are kernel parameters, captured by value: a
    CUDA graph replayed on new operands copied into its buffers gives what
    an eager call on them gives, bit for bit."""
    q, k, v = _qkv(cuda_device, 2, 1024, 1024, 20, 64, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attention(q, k, v, num_heads=20, scale=0.125)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    COUNTS.reset()
    with torch.cuda.graph(graph):
        out = attention(q, k, v, num_heads=20, scale=0.125)
    assert COUNTS.k1_ws_launches == 1
    for seed in (1, 2):
        for dst, src in zip((q, k, v), _qkv(cuda_device, 2, 1024, 1024, 20, 64, torch.bfloat16,
                                            seed=seed)):
            dst.copy_(src)
        graph.replay()
        eager = attention(q, k, v, num_heads=20, scale=0.125)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert compare_to_plain(eager, attention_reference(q, k, v, num_heads=20,
                                                           scale=0.125))[2]


def test_profiler_names_the_body_as_the_benchmark_reads_it(cuda_device):
    """A profiler names SDXL's K1 launch `attention_fwd_bf16_kernel_ws<64,
    64, ...>` (ops.kernels.k1_instance), which bench_port's K1 roofline
    finds by its `attention_fwd_bf16_kernel` text and reads as d = 64."""
    from torch.profiler import ProfilerActivity, profile

    from bench_port.metrics import _attention
    from riffusion_tpu_torch.ops.kernels import k1_instance

    q, k, v = _qkv(cuda_device, 2, 1024, 1024, 20, 64, torch.bfloat16)
    attention(q, k, v, num_heads=20, scale=0.125)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        attention(q, k, v, num_heads=20, scale=0.125)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if _attention.FORWARD in e.key]
    assert len(names) == 1 and k1_instance(64) in names[0], names
    assert _attention.head_dim(names[0]) == 64


def test_strided_operands(cuda_device):
    """q, k, v as column slices of one packed (b, s, 3*h*d) projection: the
    kernel reads them through their strides, with no copy."""
    b, s, h, d = 2, 512, 4, 40
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    assert not q.is_contiguous()
    out = attention(q, k, v, num_heads=h, scale=d**-0.5)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def test_attention_module_takes_the_kernel(cuda_device):
    """The UNet's Attention at a kernel site (self-attention, 4096 queries,
    head_dim 40) in bf16: one launch, and the plain composition's result."""
    module = Attention(320, 8, 40, 320).to(cuda_device, torch.bfloat16).eval()
    x = torch.randn(2, 4096, 320, device=cuda_device).to(torch.bfloat16)
    COUNTS.reset()
    with torch.no_grad():
        out = module(x)
        q, k, v = module.to_q(x), module.to_k(x), module.to_v(x)
        ref = module.to_out(attention_reference(q, k, v, num_heads=8, scale=40**-0.5))
    assert (COUNTS.launches, COUNTS.plain_calls) == (1, 0)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(1, 64, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attention(q, q, q, num_heads=2, scale=1.0)
    q = torch.zeros(1, 32, 64, device=cuda_device).transpose(1, 2)  # h*d dim not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        attention(q, q, q, num_heads=2, scale=1.0)
    q = torch.zeros(1, 64, 36, device=cuda_device)[:, :, 4:]  # base not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        attention(q, q, q, num_heads=2, scale=1.0)


# K2's bf16 body (csrc/attention_fwd.cuh, K1's too) owns 128 query rows per block and
# streams 64-row K/V tiles: s_q 129 and s_kv 191 leave a ragged query tile
# and a ragged last K/V tile; s = 64 is one K/V tile, read as soon as its
# copies land (a ring that does not wait for them reads shared memory
# first); d = 24 pads to 32 for both products, and the output's pad columns
# are not written. One bf16 case per head-dim instance besides (8 and 16 in
# the 16 bucket, 24 and 32, 40 and 48, 64, 80, 96, 112, 128).
@pytest.mark.parametrize(
    "b,s_q,s_kv,h,d,dtype,mult",
    [
        (32, 4096, 4096, 8, 40, torch.bfloat16, 1.0),
        (9, 2048, 2048, 8, 40, torch.bfloat16, 1.0),
        (10, 1000, 1000, 2, 16, torch.bfloat16, 1.0),
        (1, 1000, 777, 2, 128, torch.bfloat16, 1.0),
        (9, 1024, 1024, 2, 40, torch.bfloat16, 8.0),
        (10, 2048, 2048, 2, 16, torch.float32, 1.0),
        (1, 1000, 777, 2, 128, torch.float32, 1.0),
        (2, 129, 191, 2, 40, torch.bfloat16, 1.0),
        (16, 64, 64, 8, 40, torch.bfloat16, 1.0),
        (3, 300, 257, 2, 24, torch.bfloat16, 1.0),
        (2, 129, 65, 3, 8, torch.bfloat16, 1.0),
        (1, 300, 257, 2, 32, torch.bfloat16, 1.0),
        (1, 257, 300, 2, 48, torch.bfloat16, 1.0),
        (1, 333, 200, 2, 64, torch.bfloat16, 1.0),
        (1, 191, 129, 2, 80, torch.bfloat16, 1.0),
        (1, 200, 333, 2, 96, torch.bfloat16, 1.0),
        (1, 129, 191, 2, 112, torch.bfloat16, 1.0),
    ],
    ids=["batch16-site", "b9", "ragged-d16", "ragged-d128", "large-logits", "f32-d16",
         "f32-ragged-d128", "edges-d40", "one-tile", "d24", "edges-d8", "d32", "d48", "d64",
         "d80", "d96", "d112"],
)
def test_row_kernel_matches_plain(cuda_device, b, s_q, s_kv, h, d, dtype, mult):
    q, k, v = _qkv(cuda_device, b, s_q, s_kv, h, d, dtype, mult, seed=2)
    COUNTS.reset()
    out = row_attention(q, k, v, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    assert (COUNTS.launches, COUNTS.row_launches, COUNTS.plain_calls) == (0, 1, 0)
    assert out.shape == q.shape and out.dtype == dtype
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def test_row_kernel_strided_operands(cuda_device):
    b, s, h, d = 9, 2048, 4, 40
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.split(h * d, dim=-1)
    out = row_attention(q, k, v, num_heads=h, scale=d**-0.5)
    ref = attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def test_row_kernel_refusal_raises(cuda_device):
    """K2 writes no log-sum-exp: its entry point refuses a buffer for one
    with a CUDA error, and the wrapper raises instead of falling back."""
    q, k, v = _qkv(cuda_device, 1, 128, 128, 2, 40, torch.bfloat16)
    lse = torch.empty(1, 2, 128, device=cuda_device)
    with pytest.raises(RuntimeError, match="row_attention kernel launch failed with CUDA error"):
        attn._launch("row_attention", q, k, v, 2, 40**-0.5, lse=lse)


def test_attention_module_takes_the_row_kernel(cuda_device):
    """At UNet batch 10 the seq-4096 self-attention goes through K2."""
    module = Attention(320, 8, 40, 320).to(cuda_device, torch.bfloat16).eval()
    x = torch.randn(10, 4096, 320, device=cuda_device).to(torch.bfloat16)
    COUNTS.reset()
    with torch.no_grad():
        out = module(x)
        q, k, v = module.to_q(x), module.to_k(x), module.to_v(x)
        ref = module.to_out(attention_reference(q, k, v, num_heads=8, scale=40**-0.5))
    assert (COUNTS.launches, COUNTS.row_launches, COUNTS.plain_calls) == (0, 1, 0)
    max_abs, rel_rms, ok = compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


def _grad_case(dev, b, s_q, s_kv, h, d, dtype, mult=1.0, seed=4):
    """q, k ~ N(0, 1) (times `mult`), v ~ N(1, 1) (so that delta is not small
    next to dP: tests/test_torch_attention_grad.py), dO ~ N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
    k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
    v = (torch.randn(b, s_kv, h * d, generator=gen, device=dev) + 1).to(dtype)
    dout = torch.randn(b, s_q, h * d, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


# Each case is held to ops.attention.GRAD_TOLERANCE for each of dQ, dK, dV
# (tests/test_torch_attention_grad.py derives it and plants faults). The
# bf16 kernels own 128 rows per block and stream 64-row tiles (32 for dK/dV
# at d = 128): s_q and s_kv of 129, 191 and 65 leave a ragged owned tile
# and a ragged streamed tile; s = 64 is one streamed tile, read as soon as
# its copies land. One bf16 case per head-dim instance (16, 32, 40 and 48 in
# the 48 bucket, 64, 80, 96, 112, 128).
@pytest.mark.parametrize(
    "b,s_q,s_kv,h,d,dtype,mult",
    [
        (4, 4096, 4096, 8, 40, torch.bfloat16, 1.0),
        (4, 1024, 1024, 8, 80, torch.bfloat16, 1.0),
        (1, 1000, 777, 2, 128, torch.bfloat16, 1.0),
        (2, 333, 1000, 2, 16, torch.bfloat16, 1.0),
        (1, 1024, 1024, 2, 40, torch.bfloat16, 4.0),
        (2, 300, 300, 3, 32, torch.float32, 1.0),
        (1, 1000, 777, 2, 128, torch.float32, 1.0),
        (2, 129, 191, 2, 40, torch.bfloat16, 1.0),
        (2, 191, 129, 2, 80, torch.bfloat16, 1.0),
        (1, 191, 129, 2, 128, torch.bfloat16, 1.0),
        (2, 129, 65, 3, 8, torch.bfloat16, 1.0),
        (1, 300, 257, 2, 32, torch.bfloat16, 1.0),
        (1, 257, 300, 2, 48, torch.bfloat16, 1.0),
        (1, 333, 200, 2, 64, torch.bfloat16, 1.0),
        (1, 200, 333, 2, 96, torch.bfloat16, 1.0),
        (1, 129, 191, 2, 112, torch.bfloat16, 1.0),
        (16, 64, 64, 8, 40, torch.bfloat16, 1.0),
    ],
    ids=["train-d40", "train-d80", "ragged-d128", "ragged-d16", "large-logits", "f32-d32",
         "f32-ragged-d128", "edges-d40", "edges-d80", "edges-d128", "edges-d8", "d32", "d48",
         "d64", "d96", "d112", "one-tile"],
)
def test_backward_kernels_match_plain(cuda_device, b, s_q, s_kv, h, d, dtype, mult):
    q, k, v, dout = _grad_case(cuda_device, b, s_q, s_kv, h, d, dtype, mult)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    COUNTS.reset()
    out = attention(*leaves, num_heads=h, scale=d**-0.5)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (COUNTS.launches, COUNTS.bwd_dkv_launches, COUNTS.bwd_dq_launches,
            COUNTS.plain_calls) == (1, 1, 1, 0)
    refs = attention_backward_reference(q, k, v, out.detach(), dout, num_heads=h,
                                        scale=d**-0.5)
    result = compare_grads_to_plain([x.grad for x in leaves], refs)
    assert all(ok for _, _, ok in result.values()), result


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_forward_writes_the_log_sum_exp(cuda_device, dtype):
    """The LSE K1 writes when asked, against logsumexp of the fp32 logits:
    1e-3 (the same products summed in another order, exp2 for exp)."""
    b, s, h, d = 2, 1000, 3, 40
    q, k, v = _qkv(cuda_device, b, s, s, h, d, dtype, mult=2.0)
    lse = torch.empty(b, h, s, device=cuda_device)
    out = attn._launch("attention", q, k, v, h, d**-0.5, lse=lse)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float().view(b, s, h, d),
                          k.float().view(b, s, h, d)) * d**-0.5
    assert float((lse - torch.logsumexp(logits, dim=-1)).abs().max()) < 1e-3
    assert torch.equal(out, attn._launch("attention", q, k, v, h, d**-0.5))


def test_backward_strided_operands(cuda_device):
    """q, k, v as column slices of one packed projection, with its gradient."""
    b, s, h, d = 2, 512, 4, 40
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn(b, s, 3 * h * d, generator=gen, device=cuda_device).to(torch.bfloat16)
    dout = torch.randn(b, s, h * d, generator=gen, device=cuda_device).to(torch.bfloat16)
    leaf = qkv.clone().requires_grad_()
    out = attention(*leaf.split(h * d, dim=-1), num_heads=h, scale=d**-0.5)
    out.backward(dout)
    refs = attention_backward_reference(*qkv.split(h * d, dim=-1), out.detach(), dout,
                                        num_heads=h, scale=d**-0.5)
    result = compare_grads_to_plain(leaf.grad.split(h * d, dim=-1), refs)
    assert all(ok for _, _, ok in result.values()), result


def test_row_attention_backward_is_the_plain_recompute(cuda_device):
    """K2's gradient (b = 9, s = 2048) against autograd of the plain version."""
    b, s, h, d = 9, 2048, 8, 40
    q, k, v, dout = _grad_case(cuda_device, b, s, s, h, d, torch.bfloat16)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    COUNTS.reset()
    row_attention(*leaves, num_heads=h, scale=d**-0.5).backward(dout)
    assert (COUNTS.row_launches, COUNTS.bwd_dkv_launches, COUNTS.plain_calls) == (1, 0, 0)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    attention_reference(*plain, num_heads=h, scale=d**-0.5).backward(dout)
    for got, ref in zip(leaves, plain):  # the same recompute on the same operands
        torch.testing.assert_close(got.grad, ref.grad)
