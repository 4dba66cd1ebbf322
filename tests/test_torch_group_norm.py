"""
The NHWC GroupNorm (riffusion_tpu_torch/ops/group_norm.py) and the serving
UNet's channels_last layout, on the CPU:
- the plain NHWC GroupNorm(+SiLU) against F.group_norm, the cast back and
  F.silu on the NCHW copy, at the UNet's (C, H*W) sites at batch 2, fp32
  and bf16, with and without SiLU;
- a CPU emulation of the kernel's arithmetic (per-chunk partials merged by
  Chan as the kernel's lanes merge them, the fused affine, the roundings)
  over `tiling`'s chunks, within
  TOLERANCE of the plain version, and two planted faults it rejects: a
  group normalised with its neighbour's statistics, the last chunk's
  partial dropped;
- `tiling` at every site of the serving and batched paths, and its refusals;
- the dispatch in models/layers.py GroupNorm: the op under inference_mode
  for channels_last input, the present path under autograd, for NCHW, and
  for a tensor that is both layouts;
- a tiny UNet with channels_last weights against the same UNet in NCHW at
  fp32, NCHW-contiguous out; the pipeline's UNet channels_last and its VAE
  NCHW; the trainer's masters NCHW from a pipeline's UNet, and a training
  step that takes no NHWC GroupNorm;
- the counters in tracing.export() and the build log's GroupNorm instances.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.models import layers
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops.kernels import COUNTS, ptxas_instances
from riffusion_tpu_torch.ops import group_norm as gn

H100_SMS = 132

# (channels, H, W) of each GroupNorm site of the SD v1 UNet at a 64x64
# latent (the single clip's 512x512), as models/unet.py builds them
UNET_SITES = [
    (320, 64, 64), (640, 64, 64), (960, 64, 64),
    (320, 32, 32), (640, 32, 32), (960, 32, 32), (1280, 32, 32), (1920, 32, 32),
    (640, 16, 16), (1280, 16, 16), (1920, 16, 16), (2560, 16, 16),
    (1280, 8, 8), (2560, 8, 8),
]


def _nchw_path(x, weight, bias, groups, eps, silu):
    """layers.GroupNorm's present path on an NCHW copy, then F.silu."""
    p = torch.promote_types(torch.float32, x.dtype)
    y = F.group_norm(x.contiguous().to(p), groups, weight.to(p), bias.to(p), eps).to(x.dtype)
    return F.silu(y) if silu else y


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,h,w", [(320, 64, 64), (960, 64, 64), (640, 32, 32),
                                   (1920, 32, 32), (1280, 16, 16), (2560, 8, 8)])
def test_plain_nhwc_matches_nchw_group_norm(c, h, w, dtype, silu):
    x, weight, bias = gn.check_inputs(2, c, h, w, dtype, "cpu", seed=c + h)
    assert x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    COUNTS.reset()
    out = gn.group_norm(x, weight, bias, 32, 1e-5, silu=silu)
    assert COUNTS.group_norm_plain_calls == 1 and COUNTS.group_norm_launches == 0
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    ref = _nchw_path(x, weight, bias, 32, 1e-5, silu)
    max_abs, rel_rms, ok = gn.compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


SEGMENT = 32  # csrc/group_norm.cu kSeg: the lanes that merge one group's partials


def _chan(a, b):
    """Chan's merge of two (count, mean, M2) states, as csrc/group_norm.cu
    chan_merge (an empty pair stays empty)."""
    (na, ma, qa), (nb, mb, qb) = a, b
    total = na + nb
    wb = torch.where(total > 0, nb / torch.where(total > 0, total, 1.0), 0.0)
    delta = mb - ma
    return total, ma + delta * wb, qa + qb + delta * delta * na * wb


def _emulate(x, weight, bias, groups, eps, silu, sms=H100_SMS, fault=None):
    """The kernel's arithmetic in torch: `tiling`'s chunks, each chunk's
    (count, mean, M2) per group (fp64 here: the kernel's Welford differs
    only in fp32 rounding), then in fp32 the apply launch's merge (SEGMENT
    lanes a group, each merging chunks lane, lane + SEGMENT, ... in turn,
    then the lanes pairwise by xor 16, 8, 4, 2, 1), a = rstd * gamma,
    b = beta - mean * a, y = x * a + b rounded to x's dtype, SiLU on the
    rounded y, rounded again. `fault`: "neighbour" (a group takes the next
    group's statistics) or "last chunk" (its partial dropped)."""
    b, c, h, w = x.shape
    tile = gn.tiling(b, h * w, c, x.element_size(), sms)
    rows = x.permute(0, 2, 3, 1).reshape(b, h * w, groups, c // groups).double()
    empty = (torch.zeros(b, groups),) * 3
    lanes = [empty] * SEGMENT
    for k in range(tile.chunks):
        if fault == "last chunk" and k == tile.chunks - 1:
            continue
        piece = rows[:, k * tile.chunk:(k + 1) * tile.chunk]
        flat = piece.permute(0, 2, 1, 3).reshape(b, groups, -1)
        mean = flat.mean(-1)
        part = (torch.full((b, groups), float(flat.shape[-1])), mean.float(),
                ((flat - mean[..., None]) ** 2).sum(-1).float())
        lanes[k % SEGMENT] = _chan(lanes[k % SEGMENT], part)
    o = SEGMENT // 2
    while o:
        lanes = [_chan(lanes[i], lanes[i ^ o]) for i in range(SEGMENT)]
        o //= 2
    count, mean, m2 = lanes[0]
    rstd = torch.rsqrt(m2 / count + eps)
    if fault == "neighbour":
        mean, rstd = mean.roll(-1, 1), rstd.roll(-1, 1)
    per = c // groups
    mean_c, rstd_c = mean.repeat_interleave(per, 1), rstd.repeat_interleave(per, 1)
    scale = rstd_c * weight.float()
    shift = bias.float() - mean_c * scale
    y = (x.float() * scale[:, :, None, None] + shift[:, :, None, None]).to(x.dtype)
    return F.silu(y) if silu else y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,h,w,batch", [(320, 64, 64, 2), (960, 64, 64, 2), (1280, 16, 16, 2),
                                         (2560, 8, 8, 2), (640, 32, 32, 32)])
def test_emulated_kernel_within_tolerance_and_faults_rejected(c, h, w, batch, dtype):
    x, weight, bias = gn.check_inputs(batch, c, h, w, dtype, "cpu", seed=7)
    ref = gn.group_norm_reference(x, weight, bias, 32, 1e-5, silu=True)
    *_, ok = gn.compare_to_plain(_emulate(x, weight, bias, 32, 1e-5, True), ref)
    assert ok
    for fault in ("neighbour", "last chunk"):
        max_abs, rel_rms, ok = gn.compare_to_plain(
            _emulate(x, weight, bias, 32, 1e-5, True, fault=fault), ref)
        assert not ok, (fault, max_abs, rel_rms)


@pytest.mark.parametrize("batch", [2, 32])
@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
def test_tiling_at_every_site(batch, element_size):
    for c, h, w in UNET_SITES:
        hw = h * w
        tile = gn.tiling(batch, hw, c, element_size, H100_SMS)
        assert tile.vec * element_size == 16
        assert tile.threads % 32 == 0 and tile.rows * c // tile.vec <= tile.threads <= 1024
        assert tile.smem_bytes <= 48 * 1024
        assert (tile.chunks - 1) * tile.chunk < hw <= tile.chunks * tile.chunk
        assert tile.chunk >= tile.rows or tile.chunks == 1
        blocks = batch * tile.chunks
        assert blocks <= gn.BLOCKS_PER_SM * H100_SMS + batch or tile.chunk == tile.rows
    # a ragged last chunk at the batched path's 4096-row sites
    tile = gn.tiling(32, 4096, 320, 2, H100_SMS)
    assert 4096 % tile.chunk != 0


def test_tiling_refusals():
    with pytest.raises(ValueError, match="16-byte"):
        gn.tiling(2, 64, 36, 2, H100_SMS)
    with pytest.raises(ValueError, match="one block"):
        gn.tiling(2, 64, 8192, 2, H100_SMS)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, weight, bias = gn.check_inputs(1, 64, 4, 4, torch.float32, "cpu", seed=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gn._check(x.to("meta"), weight.to("meta"), bias.to("meta"), 32)
    fake = type("Cuda", (), {"type": "cuda"})()

    class Fake:
        """A stand-in for a CUDA tensor: the checks read its attributes."""

        def __init__(self, t, **over):
            self.t, self.over = t, over

        def __getattr__(self, name):
            if name in self.over:
                return self.over[name]
            return getattr(self.t, name)

    def cuda(t, **over):
        return Fake(t, device=over.pop("device", fake), **over)

    with pytest.raises(ValueError, match="channels_last"):
        gn._check(cuda(x.contiguous()), cuda(weight), cuda(bias), 32)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn._check(cuda(x, dtype=torch.float16), cuda(weight), cuda(bias), 32)
    with pytest.raises(ValueError, match="groups"):
        gn._check(cuda(x), cuda(weight), cuda(bias), 24)


def test_dispatch_by_layout_and_autograd():
    norm = layers.GroupNorm(32, 64, eps=1e-5)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x, _, _ = gn.check_inputs(2, 64, 8, 8, torch.float32, "cpu", seed=1)
    COUNTS.reset()
    with torch.inference_mode():
        taken = norm(x, silu=True)
    assert COUNTS.group_norm_plain_calls == 1
    assert taken.is_contiguous(memory_format=torch.channels_last)
    # under autograd with weights that require grad: the present path
    COUNTS.reset()
    present = norm(x, silu=True)
    assert COUNTS.group_norm_plain_calls == 0 and COUNTS.group_norm_launches == 0
    assert present.requires_grad
    *_, ok = gn.compare_to_plain(taken, present.detach())
    assert ok
    # an input that requires grad, with frozen weights: the present path
    norm.requires_grad_(False)
    COUNTS.reset()
    norm(x.clone().requires_grad_())
    assert COUNTS.group_norm_plain_calls == 0
    # grad off: the op
    with torch.no_grad():
        norm(x)
    assert COUNTS.group_norm_plain_calls == 1
    # NCHW, and a (B, C, 1, 1) tensor that is both layouts: the present path
    COUNTS.reset()
    with torch.inference_mode():
        norm(x.contiguous())
        norm(torch.randn(2, 64, 1, 1).contiguous(memory_format=torch.channels_last))
    assert COUNTS.group_norm_plain_calls == 0


def test_takes_nhwc_group_norm():
    w = torch.ones(8, requires_grad=True)
    cl = torch.randn(1, 8, 3, 3).contiguous(memory_format=torch.channels_last)
    assert not layers.takes_nhwc_group_norm(cl, w)  # grad enabled, w requires it
    with torch.no_grad():
        assert layers.takes_nhwc_group_norm(cl, w)
        assert not layers.takes_nhwc_group_norm(cl.contiguous(), w)
        assert not layers.takes_nhwc_group_norm(torch.randn(1, 8, 9), w)
    assert layers.takes_nhwc_group_norm(cl, w.detach())


def test_vae_never_takes_the_nhwc_op():
    """An fp32 NCHW VAE keeps torch's GroupNorm, also under inference_mode.
    (On the card, models/vae.py makes the pipeline's channels_last pixels
    and latents NCHW-contiguous first; tests/test_torch_group_norm_cuda.py
    counts the VAE's calls on torch's GroupNorm in a served request.)"""
    vae = random_bundle("tiny", seed=0, device="cpu").vae.eval()
    COUNTS.reset()
    with torch.inference_mode():
        mean, _ = vae.encode_moments(torch.rand(2, 3, 64, 64) * 2 - 1)
        vae.decode(mean)
    assert COUNTS.group_norm_plain_calls == 0


# (8, 8) reaches a 1x1 level (8 -> 4 -> 2 -> 1); (10, 6) and (16, 16) do not
@pytest.mark.parametrize("hw,every_site", [((8, 8), False), ((10, 6), True), ((16, 16), True)])
def test_channels_last_unet_matches_nchw(hw, every_site):
    """The tiny UNet with channels_last weights against itself in NCHW at
    fp32 under inference_mode: within 1e-5 of the peak, NCHW-contiguous
    out, each GroupNorm site with more than one spatial position on the
    NHWC op (a 1x1 site is both layouts and keeps the present path)."""
    unet = random_bundle("tiny", seed=0, device="cpu").unet.eval()
    nhwc = copy.deepcopy(unet).to(memory_format=torch.channels_last)
    assert nhwc.conv_in.weight.is_contiguous(memory_format=torch.channels_last)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4, *hw)).astype(np.float32))
    t = torch.tensor([801, 801])
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    sites = sum(isinstance(m, layers.GroupNorm) for m in unet.modules())
    with torch.inference_mode():
        ref = unet(x, t, ctx)
        COUNTS.reset()
        out = nhwc(x, t, ctx)
    assert out.is_contiguous() and out.shape == ref.shape
    taken = COUNTS.group_norm_plain_calls
    assert 0 < taken <= sites and (taken == sites) == every_site
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5


def test_unet_output_is_nchw_contiguous_for_nchw_weights():
    unet = UNet2DCondition(UNetConfig.tiny()).eval()
    x = torch.randn(1, 8, 8, 4).permute(0, 3, 1, 2)  # channels_last strides, as the trainer's
    with torch.no_grad():
        out = unet(x, torch.tensor([10]), torch.randn(1, 77, 64))
    assert out.is_contiguous()


def test_pipeline_unet_is_channels_last_and_its_vae_is_not():
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    pipe = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu", channels_last=False)
    convs = [p for p in pipe.unet.parameters() if p.dim() == 4]
    assert convs and all(p.is_contiguous(memory_format=torch.channels_last) and
                         not p.is_contiguous() for p in convs if p.shape[2:] != (1, 1))
    assert all(p.is_contiguous() for p in pipe.vae.parameters())


def test_trainer_masters_are_nchw_and_a_step_takes_no_nhwc_op():
    """init_from a serving pipeline's channels_last UNet gives NCHW masters;
    a training step (autograd) runs every GroupNorm on the present path."""
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    pipe = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    trainer = DiffusionTrainer(device="cpu", dtype=torch.float32)
    trainer.init_from(pipe.unet)
    assert all(p.is_contiguous() for p in trainer.master.parameters())
    assert all(p.is_contiguous() for p in trainer.unet.parameters())
    gen = torch.Generator().manual_seed(0)
    COUNTS.reset()
    trainer.step(latents=torch.randn(2, 8, 8, 4, generator=gen),
                 context=torch.randn(2, 77, 64, generator=gen))
    assert COUNTS.group_norm_plain_calls == 0 and COUNTS.group_norm_launches == 0


def test_tracing_export_counts_the_group_norm_paths():
    COUNTS.reset()
    COUNTS.group_norm_launches += 3
    COUNTS.group_norm_library_calls += 2
    try:
        counters = tracing.Tracer().export()["counters"]
    finally:
        COUNTS.reset()
    assert {k: counters[k] for k in tracing.KERNEL_COUNTERS} == {
        "group_norm_launches": 3, "group_norm_library_calls": 2, "launches": 0,
        "k1_ws_launches": 0, "plain_self_sites": 0, "adamw_launches": 0}


def test_ptxas_instances_read_the_group_norm_kernels():
    log = ("ptxas info    : Compiling entry function '_ZN6riffgn23group_norm_stats_kernelI13__nv"
           "_bfloat16EEvPKT_NS_8PartialsENS_8GeometryE' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_ZN6riffgn23group_norm_apply_kernelIfEEvPKT"
           "_PKvS5_iNS_8PartialsEPS1_NS_8GeometryEfi' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 32 registers, 400 bytes cmem[0]\n")
    found = ptxas_instances(log)
    assert [f[0] for f in found] == ["group_norm_stats_kernel<bf16>",
                                     "group_norm_apply_kernel<float>"]
