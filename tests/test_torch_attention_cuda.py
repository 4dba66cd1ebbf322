"""
The Hopper attention kernels (riffusion_tpu_torch/csrc/attention.cu, K1, and
csrc/row_attention.cu, K2) against their plain PyTorch version, on a CUDA
card. Every test here is marked `cuda` and skips where torch sees no card;
the kernels have no CPU mode. This file
imports neither jax nor the JAX package, so it runs on a card machine
without them:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_attention_cuda.py
"""

import pytest
import torch

from riffusion_tpu_torch.models.layers import Attention
from riffusion_tpu_torch.ops.attention import (
    COUNTS,
    attention,
    attention_reference,
    compare_to_plain,
    row_attention,
)

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
    ],
    ids=["slice-d40", "slice-d80", "batch16-d80", "batch8-d80", "batch4-d40", "ragged-d16",
         "ragged-d32", "ragged-d128", "large-logits", "f32-d32", "f32-ragged-d128"],
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
    ],
    ids=["batch16-site", "b9", "ragged-d16", "ragged-d128", "large-logits", "f32-d16",
         "f32-ragged-d128"],
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
