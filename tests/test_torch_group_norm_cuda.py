"""
The NHWC GroupNorm kernel (riffusion_tpu_torch/csrc/group_norm.cu, through
ops/group_norm.py) and the channels_last serving UNet on a card:
- the kernel against its plain version at every GroupNorm shape of the SD
  v1 UNet at batch 2 and 32 (the 4096-row sites at 32 end in a ragged
  chunk), bf16 and fp32, with and without SiLU, and an input whose every
  chunk is ragged, held to ops.group_norm.TOLERANCE: both versions round
  the same values to the same dtype, and differ in the order their fp32
  statistics are summed, which moves a bf16 output by a rounding step now
  and then (the tolerance's comment says more);
- random:full's PNDM-50 request at strength 0.75 replayed as a captured
  graph: 38 x 61 = 2,318 NHWC GroupNorm calls and none of torch's in the
  UNet (the VAE's, NCHW fp32, stay torch's), no cuDNN layout transpose in
  the replay's trace, and each replay bit-equal to the capturing call,
  which runs the program eagerly on the same inputs;
- a training step of the tiny trainer takes no NHWC GroupNorm.
Every test is marked `cuda` and skips where torch sees no card. No jax
import, so it runs on a card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_group_norm_cuda.py
"""

import numpy as np
import pytest
import torch

from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models import layers
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.ops import group_norm as gn
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

# (channels, H, W) of each GroupNorm site of the SD v1 UNet at a 64x64 latent
SITES = [
    (320, 64, 64), (640, 64, 64), (960, 64, 64),
    (320, 32, 32), (640, 32, 32), (960, 32, 32), (1280, 32, 32), (1920, 32, 32),
    (640, 16, 16), (1280, 16, 16), (1920, 16, 16), (2560, 16, 16),
    (1280, 8, 8), (2560, 8, 8),
]
CASES = [(b, c, h, w) for b in (2, 32) for c, h, w in SITES] + [(3, 640, 30, 50)]
TRANSPOSES = ("nchwToNhwc", "nhwcToNchw")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,c,h,w", CASES, ids=[f"{b}x{c}x{h}x{w}" for b, c, h, w in CASES])
def test_kernel_against_plain(card, b, c, h, w, dtype):
    x, weight, bias = gn.check_inputs(b, c, h, w, dtype, card, seed=c + h + b)
    for silu in (True, False):
        COUNTS.reset()
        out = gn.group_norm(x, weight, bias, 32, 1e-5, silu=silu)
        torch.cuda.synchronize()
        assert COUNTS.group_norm_launches == 1 and COUNTS.group_norm_plain_calls == 0
        assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == dtype
        ref = gn.group_norm_reference(x, weight, bias, 32, 1e-5, silu=silu)
        max_abs, rel_rms, ok = gn.compare_to_plain(out, ref)
        assert ok, (silu, max_abs, rel_rms)


def test_kernel_takes_fp32_gamma_and_beta_with_bf16_x(card):
    x, weight, bias = gn.check_inputs(2, 640, 32, 32, torch.bfloat16, card, seed=5)
    out = gn.group_norm(x, weight.float(), bias.float(), 32, 1e-6, silu=False)
    ref = gn.group_norm_reference(x, weight.float(), bias.float(), 32, 1e-6, silu=False)
    *_, ok = gn.compare_to_plain(out, ref)
    assert ok


def test_wrapper_refuses_nchw_on_the_card(card):
    x, weight, bias = gn.check_inputs(2, 64, 8, 8, torch.bfloat16, card, seed=0)
    with pytest.raises(ValueError, match="channels_last"):
        gn.group_norm(x.contiguous(), weight, bias, 32, 1e-5)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn.group_norm(x.half(), weight, bias, 32, 1e-5)


def _request() -> InferenceInput:
    return InferenceInput(
        start=PromptInput(prompt="funky synth solo", seed=42, denoising=0.75),
        end=PromptInput(prompt="jazzy saxophone", seed=123, denoising=0.75),
        alpha=0.5, num_inference_steps=50)


def test_full_request_graph_counts_and_layout(card, monkeypatch):
    """random:full's PNDM-50 request at strength 0.75 (38 UNet evaluations):
    eagerly, then captured and replayed. Every call runs 2,318 NHWC
    GroupNorm calls, and torch's GroupNorm only at the VAE's sites; the
    replays equal the capturing call's eager run bit for bit; a profiled
    replay launches no cuDNN layout transpose."""
    from pathlib import Path

    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import load_seed_image
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    seed = load_seed_image(Path(__file__).resolve().parent.parent / "seed_images", "og_beat")
    params = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=512)
    evaluations = pipe._plan("pndm", 50, 0.75)[0].num_steps
    assert evaluations == 38
    vae_sites = sum(isinstance(m, layers.GroupNorm) for m in pipe.vae.modules())

    def run():
        COUNTS.reset()
        image, segment = pipe.riffuse_audio(_request(), seed, params=params, scheduler="pndm")
        counts = COUNTS.snapshot()
        assert counts["group_norm_launches"] == 61 * evaluations == 2318, counts
        assert counts["group_norm_library_calls"] == vae_sites, counts
        return np.asarray(image), segment.raw_data

    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    eager = run()
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT")
    captured = run()  # the capturing call's result is its warm-up: the program run eagerly
    for _ in range(2):
        image, audio = run()
        np.testing.assert_array_equal(image, captured[0])
        np.testing.assert_array_equal(audio, captured[1])
    # the eager call of another process state: cuDNN may pick other
    # algorithms under capture (chip_smoke.py's graphs phase, GRAPH_IMAGE_BAND)
    assert np.abs(captured[0].astype(float) - eager[0]).mean() < 1.0

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = {e.key for e in prof.key_averages()}
    assert any("group_norm_apply_kernel" in k for k in kernels), sorted(kernels)[:40]
    transposes = sorted(k for k in kernels if any(t in k for t in TRANSPOSES))
    assert not transposes, transposes


def test_training_step_takes_no_nhwc_group_norm(card):
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    trainer = DiffusionTrainer(device=card, dtype=torch.bfloat16)
    trainer.init_from(random_bundle("tiny", seed=0, device=card).unet)
    gen = torch.Generator(device=card).manual_seed(0)
    COUNTS.reset()
    for _ in range(2):
        trainer.step(latents=torch.randn(2, 32, 32, 4, generator=gen, device=card),
                     context=torch.randn(2, 77, 64, generator=gen, device=card))
    torch.cuda.synchronize()
    assert COUNTS.group_norm_launches == 0 and COUNTS.group_norm_library_calls > 0
