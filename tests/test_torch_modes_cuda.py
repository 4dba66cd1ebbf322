"""
The generating modes and the warm start on a CUDA card: txt2img_audio_batch
and img2img_magic_mix with the tiny model in fp32 on the card against the
same calls on the CPU with the same noise (within one uint8 level on at
least 99% of pixels, K1 launched, no plain call), the text-embedding disk
cache on the card (a hit comes back on the card in bf16, keyed on the
card's name), and warmstart_report's kernel stage. Every test is marked
`cuda` and skips where torch sees no card. No jax import, so it runs on a
card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_modes_cuda.py
"""

import copy

import numpy as np
import pytest
import torch
from PIL import Image

from riffusion_tpu_torch import embed_cache
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops.kernels import COUNTS, FORWARD_KERNELS, built_on_disk
from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

pytestmark = pytest.mark.cuda

SIZE = 256  # 32x32 latents: the tiny UNet's self-attention takes K1


@pytest.fixture(scope="module")
def pipes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    return (RiffusionPipeline(copy.deepcopy(bundle), device="cuda"),
            RiffusionPipeline(bundle, device="cpu"))


def _agree(a_img, b_img):
    a, b = np.asarray(a_img, np.int16), np.asarray(b_img, np.int16)
    assert a.shape == b.shape
    stats = (int(np.abs(a - b).max()), float((a == b).mean()))
    assert stats[0] <= 1 and stats[1] >= 0.99, stats


def _on_card(fn):
    COUNTS.reset()
    out = fn()
    torch.cuda.synchronize()
    assert COUNTS.launches > 0 and COUNTS.plain_calls == 0, COUNTS
    return out


def test_txt2img_audio_batch_on_the_card_matches_the_cpu(pipes):
    gpu, cpu = pipes
    params = SpectrogramParams(num_frequencies=SIZE)
    rng = np.random.default_rng(0)
    n_active = cpu.converter(params).n_active
    noises = [FixedNoise({"latents": rng.standard_normal((1, 4, SIZE // 8, SIZE // 8)),
                          "gl_real": rng.random((1, n_active, SIZE)),
                          "gl_imag": rng.random((1, n_active, SIZE))}) for _ in range(2)]
    kw = dict(negative_prompts=["noise", None], num_inference_steps=6, guidances=[1.5, 1.75],
              width=SIZE, height=SIZE, scheduler="pndm", params=params, apply_filters=False,
              noises=noises)
    out_g = _on_card(lambda: gpu.txt2img_audio_batch(["church bells", "techno"], **kw))
    out_c = cpu.txt2img_audio_batch(["church bells", "techno"], **kw)
    for (image_g, audio_g), (image_c, audio_c) in zip(out_g, out_c):
        _agree(image_g, image_c)
        assert audio_g.raw_data.shape == audio_c.raw_data.shape
        assert np.abs(audio_g.raw_data.astype(int)).max() > 30000


@pytest.mark.parametrize("scheduler", ["pndm", "euler_a"])
def test_magic_mix_on_the_card_matches_the_cpu(pipes, scheduler):
    gpu, cpu = pipes
    rng = np.random.default_rng(1)
    image = Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8))
    latent = (1, 4, SIZE // 8, SIZE // 8)
    draws = {"vae_eps": rng.standard_normal(latent), "noise": rng.standard_normal(latent)}
    t_start = cpu._magic_mix_start(scheduler, 8, 0.3, 0.7)[0]
    steps = sched.make_plan(scheduler, 8, t_start).num_steps
    if scheduler == "euler_a":
        draws["ancestral"] = rng.standard_normal((steps,) + latent)
    kw = dict(num_inference_steps=8, guidance_scale=1.5, kmax=0.7, scheduler=scheduler,
              noise=FixedNoise(draws))
    image_g = _on_card(lambda: gpu.img2img_magic_mix("organ", image, **kw))
    _agree(image_g, cpu.img2img_magic_mix("organ", image, **kw))


def test_embed_cache_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("RIFFUSION_TPU_EMBED_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("RIFFUSION_TPU_NO_EMBED_CACHE", raising=False)
    assert torch.cuda.get_device_name(0) in embed_cache.fingerprint("cuda")
    pipes = [RiffusionPipeline(random_bundle("tiny", device="cuda", dtype=torch.bfloat16),
                               device="cuda") for _ in range(2)]
    first = pipes[0].embed_text_weighted("church bells")
    second = pipes[1].embed_text_weighted("church bells")
    assert pipes[1].embed_cache_counts == {"hits": 1, "misses": 0}
    assert second.device.type == "cuda" and second.dtype == torch.bfloat16
    assert torch.equal(first, second)


def test_warmstart_report_on_the_card(pipes):
    gpu, _ = pipes
    rng = np.random.default_rng(2)
    image = Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8))
    inputs = InferenceInput(start=PromptInput(prompt="a", seed=1),
                            end=PromptInput(prompt="b", seed=2), alpha=0.5, num_inference_steps=4)
    params = SpectrogramParams(num_frequencies=SIZE)
    first = gpu.warmstart_report(inputs, image, params=params)
    assert first["kernel_source"] in ("built", "cached") and first["kernel_build_s"] >= 0
    assert built_on_disk(FORWARD_KERNELS)
    second = gpu.warmstart_report(inputs, image, params=params)
    assert second["kernel_source"] == "cached"
    for report in (first, second):
        assert all(report[k] >= 0 for k in ("host_prep_s", "weights_ready_s", "execute_s"))
