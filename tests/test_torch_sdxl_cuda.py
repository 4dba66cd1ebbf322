"""
Stable Diffusion XL base 1.0 on a card, at its published widths with random
weights:
- K1 at SDXL's self-attention sites, (2, 4096, 10 x 64) and
  (2, 1024, 20 x 64), against the plain version under ops.attention.TOLERANCE
  (the reasons are there; tests/test_torch_attention.py shows the bf16
  bound fails planted faults);
- the NHWC GroupNorm kernel at every GroupNorm site of SDXL's UNet at a
  64 x 256 latent (a 512 x 2048 image) at batch 2, against its plain
  version under ops.group_norm.TOLERANCE;
- one 512 x 2048 request (Euler at 4 steps and strength 0.75: 3
  evaluations) captured and then replayed: K1 takes all 70 self-attention
  sites of every evaluation and no site falls to the plain composition, as
  ops.kernels.COUNTS and tracing.export()'s counters read them.
Every test is marked `cuda` and skips where torch sees no card. No jax
import, so it runs on a card machine:
    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_sdxl_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.diffusion.schedulers import NoiseConfig
from riffusion_tpu_torch.models import layers, weights
from riffusion_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTextProjectionConfig,
)
from riffusion_tpu_torch.models.tokenizer import HashTokenizer
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetXLConfig
from riffusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from riffusion_tpu_torch.ops import attention as attn
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.ops import group_norm as gn
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

# (channels, H, W) of each GroupNorm site of SDXL's UNet at a 64 x 256 latent
SITES = [
    (320, 64, 256), (640, 64, 256), (960, 64, 256),
    (320, 32, 128), (640, 32, 128), (960, 32, 128), (1280, 32, 128), (1920, 32, 128),
    (640, 16, 64), (1280, 16, 64), (1920, 16, 64), (2560, 16, 64),
]
SELF_ATTENTION_SITES = 70  # 10 at seq 4096 and 60 at seq 1024 an evaluation


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("s,h", [(4096, 10), (1024, 20)], ids=["seq4096-h10", "seq1024-h20"])
def test_k1_at_sdxl_sites(card, s, h):
    gen = torch.Generator(device=card).manual_seed(s + h)
    q, k = (torch.randn(2, s, h * 64, generator=gen, device=card).to(torch.bfloat16)
            for _ in range(2))
    v = (2 * torch.rand(2, s, h * 64, generator=gen, device=card) - 1).to(torch.bfloat16)
    assert attn.route(2, s, 64, True) == "flash"
    COUNTS.reset()
    out = attn.attention(q, k, v, num_heads=h, scale=64 ** -0.5)
    torch.cuda.synchronize()
    assert (COUNTS.launches, COUNTS.plain_calls) == (1, 0)
    ref = attn.attention_reference(q, k, v, num_heads=h, scale=64 ** -0.5)
    max_abs, rel_rms, ok = attn.compare_to_plain(out, ref)
    assert ok, (max_abs, rel_rms)


@pytest.mark.parametrize("c,h,w", SITES, ids=[f"{c}x{h}x{w}" for c, h, w in SITES])
def test_group_norm_kernel_at_sdxl_sites(card, c, h, w):
    x, weight, bias = gn.check_inputs(2, c, h, w, torch.bfloat16, card, seed=c + h)
    for silu in (True, False):
        COUNTS.reset()
        out = gn.group_norm(x, weight, bias, 32, 1e-5, silu=silu)
        torch.cuda.synchronize()
        assert COUNTS.group_norm_launches == 1 and COUNTS.group_norm_plain_calls == 0
        ref = gn.group_norm_reference(x, weight, bias, 32, 1e-5, silu=silu)
        max_abs, rel_rms, ok = gn.compare_to_plain(out, ref)
        assert ok, (silu, max_abs, rel_rms)


def _sdxl_pipeline(device: torch.device) -> RiffusionPipeline:
    """SDXL base 1.0's published widths with random weights."""
    with torch.device("meta"):
        modules = (UNet2DCondition(UNetXLConfig()), AutoencoderKL(VAEConfig(scaling_factor=0.13025)),
                   CLIPTextModel(CLIPTextConfig()), CLIPTextModel(CLIPTextProjectionConfig()))
    modules = [m.to_empty(device=device) for m in modules]
    for i, module in enumerate(modules):
        weights.randomize_(module, torch.Generator(device=device).manual_seed(i))
    unet, vae, first, second = modules
    bundle = weights.ModelBundle(
        unet=unet.to(torch.bfloat16).eval(), vae=vae.eval(), text_encoder=first.to(torch.bfloat16),
        tokenizer=HashTokenizer(vocab_size=49408), scheduler_name="euler",
        text_encoder_2=second.to(torch.bfloat16), noise_config=NoiseConfig(timestep_spacing="leading"))
    return RiffusionPipeline(bundle, device=str(device))


def test_a_request_runs_k1_at_every_self_attention_site(card, monkeypatch):
    monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    pipe = _sdxl_pipeline(card)
    beat = np.asarray(Image.open(Path(__file__).resolve().parent.parent / "seed_images"
                                 / "og_beat.png").convert("RGB"))
    seed = Image.fromarray(np.tile(beat, (1, 4, 1)))
    assert seed.size == (2048, 512)
    steps, strength = 4, 0.75
    evaluations = pipe._plan("euler", steps, strength)[0].num_steps
    assert evaluations == 3
    norms = sum(isinstance(m, layers.GroupNorm) for m in pipe.unet.modules())
    inputs = InferenceInput(start=PromptInput(prompt="lofi beat", seed=1),
                            end=PromptInput(prompt="jazz piano", seed=2), alpha=0.25,
                            num_inference_steps=steps)
    params = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=512)
    images = []
    for _ in range(2):  # the capturing call, then a replay
        COUNTS.reset()
        before = tracing.export()["counters"]["launches"]
        image, segment = pipe.riffuse_audio(inputs, seed, params=params)
        counts = COUNTS.snapshot()
        assert counts["launches"] == SELF_ATTENTION_SITES * evaluations, counts
        assert counts["k1_ws_launches"] == counts["launches"], counts  # all at d = 64
        assert counts["plain_self_sites"] == 0 and counts["row_launches"] == 0, counts
        assert counts["group_norm_launches"] == norms * evaluations, counts
        assert tracing.export()["counters"]["launches"] - before == counts["launches"]
        assert image.size == (2048, 512) and segment.duration_seconds > 20.0
        images.append(np.asarray(image))
    np.testing.assert_array_equal(images[0], images[1])
