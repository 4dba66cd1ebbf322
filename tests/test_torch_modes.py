"""
The port's txt2img, img2img, txt2img_audio_batch and img2img_magic_mix
(riffusion_tpu_torch/riffusion_pipeline.py) against the JAX package's on the
CPU at the tiny geometry, on the JAX programs' own draws; euler_a's
per-request noise on the batched path; slice_anchor_timesteps against the
JAX package's. The fixtures, the JAX draws and the image and mel bounds are
test_torch_pipeline.py's (guidance 1.5-1.75 there and here, for the reason
given beside them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from test_torch_pipeline import (  # noqa: F401  (fixtures)
    JAX_PARAMS, PARAMS, SIZE, _ancestral, _assert_images_agree, _assert_mels_agree,
    _batch_inputs, _draws_for, _inputs, _jax_draws, _low_guidance, pipes, seed_image,
)
from riffusion_tpu.diffusion import schedulers as jax_sched
from riffusion_tpu_torch import riffusion_pipeline as pipeline
from riffusion_tpu_torch.diffusion import schedulers as sched


def test_euler_a_batch_item_equals_single_request(pipes, seed_image):
    """Under the default noise (GeneratorNoise of each request's seeds),
    euler_a's per-step noise is the request's own: request i of a batch of
    three is request i alone."""
    _, tp = pipes
    inputs_list = _batch_inputs(6)
    batch = tp.riffuse_audio_batch(inputs_list, seed_image, params=PARAMS, apply_filters=False,
                                   scheduler="euler_a")
    for inputs, (image_b, _) in zip(inputs_list, batch):
        _assert_images_agree(image_b, tp.riffuse(inputs, seed_image, scheduler="euler_a"))
    # and the noise matters: another start seed moves the image
    other = dataclasses.replace(inputs_list[0], start=dataclasses.replace(
        inputs_list[0].start, seed=99))
    a = np.asarray(tp.riffuse(inputs_list[0], seed_image, scheduler="euler_a"), np.int16)
    b = np.asarray(tp.riffuse(other, seed_image, scheduler="euler_a"), np.int16)
    assert np.abs(a - b).max() > 1


def test_fixed_noise_asks_for_ancestral_only_for_euler_a(pipes, seed_image):
    """The five riffuse draws serve every other sampler; euler_a without its
    draw raises and names it."""
    _, tp = pipes
    inputs = _low_guidance(_inputs(num_inference_steps=4))
    noise = _draws_for(tp, [inputs])[0]
    tp.riffuse(inputs, seed_image, scheduler="euler", noise=noise)
    with pytest.raises(ValueError, match="no draw 'ancestral'"):
        tp.riffuse(inputs, seed_image, scheduler="euler_a", noise=noise)


# ----------------------------------------------------------- txt2img, img2img


def _txt2img_draws(seed, num_steps_euler_a=None):
    """txt2img's draws from PRNGKey(seed) as the JAX program splits it:
    the latents from the first half, euler_a's noise from the second."""
    key_lat, key_sched = jax.random.split(jax.random.PRNGKey(seed))
    h = SIZE // 8
    draws = {"latents": np.array(jax.random.normal(key_lat, (1, h, h, 4), jnp.float32))
             .transpose(0, 3, 1, 2)}
    if num_steps_euler_a is not None:
        draws["ancestral"] = _ancestral(key_sched, num_steps_euler_a, (h, h))
    return pipeline.FixedNoise(draws)


@pytest.mark.parametrize("scheduler", ["pndm", "ddim", "lms", "euler_a"])
def test_txt2img_matches_jax(pipes, scheduler):
    """Pure noise at the plan's init_noise_sigma (14.6 for the sigma
    samplers, 1 for pndm and ddim), a weighted prompt against a negative
    one, guidance 1.75: the images within the slice's bound."""
    jp, tp = pipes
    kw = dict(prompt="church bells", negative_prompt="noise", seed=5, num_inference_steps=6,
              guidance=1.75, width=SIZE, height=SIZE, scheduler=scheduler)
    image_j = jp.txt2img(**kw)
    steps = sched.make_plan(scheduler, 6).num_steps if scheduler == "euler_a" else None
    image_t = tp.txt2img(**kw, noise=_txt2img_draws(5, steps))
    assert image_t.size == (SIZE, SIZE) and image_t.mode == "RGB"
    assert np.asarray(image_t).std() > 0
    _assert_images_agree(image_j, image_t)


def test_txt2img_default_noise_is_the_seeds():
    """GeneratorNoise(seed, seed): the same seed gives the same image, and
    the latents draw is not noise_a's."""
    dev = torch.device("cpu")
    a = pipeline.GeneratorNoise(3, 3, dev)
    assert not torch.equal(a("latents", (1, 4, 8, 8), dev), a("noise_a", (1, 4, 8, 8), dev))
    assert not torch.equal(pipeline.GeneratorNoise(3, 3, dev)("ancestral", (2, 1, 4, 8, 8), dev)[0],
                           pipeline.GeneratorNoise(3, 3, dev)("latents", (1, 4, 8, 8), dev))


@pytest.mark.parametrize("scheduler", ["pndm", "euler_a"])
def test_img2img_matches_jax(pipes, seed_image, scheduler):
    """riffuse at alpha 0 with one prompt: the JAX draws of (seed, seed)."""
    jp, tp = pipes
    kw = dict(prompt="organ", denoising_strength=0.55, negative_prompt="hiss", seed=11,
              num_inference_steps=7, guidance=1.5, scheduler=scheduler)
    image_j = jp.img2img(init_image=seed_image, **kw)
    n_active = tp.converter(PARAMS).n_active
    strength_steps = tp._plan(scheduler, 7, 0.55)[0].num_steps
    noise = _jax_draws(11, 11, (SIZE // 8, SIZE // 8), (1, n_active, SIZE),
                       strength_steps if scheduler == "euler_a" else None)
    image_t = tp.img2img(init_image=seed_image, **kw, noise=noise)
    _assert_images_agree(image_j, image_t)


# ------------------------------------------------------ txt2img_audio_batch


def _txt2img_batch_draws(tp, seeds, scheduler, num_steps):
    """Each request's draws as the JAX batch program makes them from its
    keys (PRNGKey(s), fold_in(PRNGKey(s), 7)): the latents from the first;
    euler_a's noise and the Griffin-Lim phase from the second (which is
    request_keys(s, s)[3], so the phase is _jax_draws' own)."""
    h = SIZE // 8
    n_active = tp.converter(PARAMS).n_active
    noises = []
    for s in seeds:
        key0 = jax.random.PRNGKey(s)
        key1 = jax.random.fold_in(key0, 7)
        phase = _jax_draws(s, s, (h, h), (1, n_active, SIZE))
        draws = {
            "latents": np.array(jax.random.normal(key0, (h, h, 4), jnp.float32))
            .transpose(2, 0, 1)[None],
            "gl_real": phase("gl_real", (1, n_active, SIZE), torch.device("cpu")),
            "gl_imag": phase("gl_imag", (1, n_active, SIZE), torch.device("cpu")),
        }
        if scheduler == "euler_a":
            draws["ancestral"] = _ancestral(key1, sched.make_plan(scheduler, num_steps).num_steps,
                                            (h, h))
        noises.append(pipeline.FixedNoise(draws))
    return noises


@pytest.mark.parametrize("scheduler", ["pndm", "euler_a"])
def test_txt2img_audio_batch_matches_jax(pipes, scheduler):
    """N = 2 prompts as one program, fused through the audio tail: the
    images within the slice's bound and the mels where the pixels agree."""
    jp, tp = pipes
    kw = dict(prompts=["church bells", "techno"], negative_prompts=["noise", None],
              seeds=[5, 9], num_inference_steps=6, guidances=[1.5, 1.75], width=SIZE,
              height=SIZE, scheduler=scheduler, apply_filters=False)
    out_j = jp.txt2img_audio_batch(**kw, params=JAX_PARAMS)
    out_t = tp.txt2img_audio_batch(**kw, params=PARAMS,
                                   noises=_txt2img_batch_draws(tp, [5, 9], scheduler, 6))
    assert len(out_t) == 2
    for (image_j, audio_j), (image_t, audio_t) in zip(out_j, out_t):
        assert image_t.size == (SIZE, SIZE) and np.asarray(image_t).std() > 0
        _assert_images_agree(image_j, image_t)
        _assert_mels_agree(image_j, image_t)
        assert audio_t.raw_data.shape == audio_j.raw_data.shape
        assert audio_t.frame_rate == audio_j.frame_rate
        assert np.abs(audio_t.raw_data.astype(int)).max() > 30000  # per-item peak


def test_txt2img_audio_batch_item_equals_prompt_alone(pipes):
    """Under the default noise (GeneratorNoise of each seed) request i of a
    batch is prompt i alone, txt2img is the batch of one, and without
    params the audio slot is None."""
    _, tp = pipes
    kw = dict(num_inference_steps=4, width=SIZE, height=SIZE, scheduler="pndm")
    batch = tp.txt2img_audio_batch(["jazz", "rain"], seeds=[3, 4], guidances=[1.5, 1.75], **kw)
    assert [audio for _, audio in batch] == [None, None]
    for (image_b, _), prompt, seed, g in zip(batch, ["jazz", "rain"], [3, 4], [1.5, 1.75]):
        _assert_images_agree(image_b, tp.txt2img(prompt, seed=seed, guidance=g, **kw))
    with pytest.raises(ValueError, match="one negative prompt, seed and guidance"):
        tp.txt2img_audio_batch(["a", "b"], seeds=[1], **kw)


# ---------------------------------------------------------------- magic mix


def _magic_mix_draws(seed, plan_steps=None):
    """MagicMix's draws from the JAX program's three keys: the VAE eps from
    PRNGKey(seed), the q-sample noise from fold_in 1, euler_a's from
    fold_in 2."""
    base = jax.random.PRNGKey(seed)
    h = SIZE // 8

    def latent(key):
        return np.array(jax.random.normal(key, (1, h, h, 4), jnp.float32)).transpose(0, 3, 1, 2)

    draws = {"vae_eps": latent(base), "noise": latent(jax.random.fold_in(base, 1))}
    if plan_steps is not None:
        draws["ancestral"] = _ancestral(jax.random.fold_in(base, 2), plan_steps, (h, h))
    return pipeline.FixedNoise(draws)


@pytest.mark.parametrize("scheduler", ["pndm", "euler", "unipc_k:rho=2"])
def test_img2img_magic_mix_matches_jax(pipes, seed_image, scheduler):
    """The start from kmax (unipc_k searches the linear grid: the Karras
    anchor), the blend while t > kmin, CFG at batch 2: the images within the
    slice's bound."""
    jp, tp = pipes
    kw = dict(prompt="organ", num_inference_steps=6, guidance_scale=1.5, seed=13, kmin=0.3,
              kmax=0.7, mix_factor=0.6, scheduler=scheduler)
    image_j = jp.img2img_magic_mix(init_image=seed_image, **kw)
    image_t = tp.img2img_magic_mix(init_image=seed_image, **kw, noise=_magic_mix_draws(13))
    assert image_t.size == (SIZE, SIZE) and np.asarray(image_t).std() > 0
    _assert_images_agree(image_j, image_t)


def test_img2img_magic_mix_default_noise(pipes, seed_image):
    """GeneratorNoise of the seed: deterministic, seed-sensitive; euler_a
    draws its per-step noise too."""
    _, tp = pipes
    kw = dict(num_inference_steps=5, guidance_scale=1.5, kmax=0.7)
    a = np.asarray(tp.img2img_magic_mix("organ", seed_image, seed=1, **kw), np.int16)
    b = np.asarray(tp.img2img_magic_mix("organ", seed_image, seed=1, **kw), np.int16)
    c = np.asarray(tp.img2img_magic_mix("organ", seed_image, seed=2, **kw), np.int16)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1
    tp.img2img_magic_mix("organ", seed_image, seed=1, scheduler="euler_a", **kw)


@pytest.mark.parametrize("name", list(sched.SCHEDULER_NAMES) + ["unipc_k:rho=2",
                                                                 "dpmpp_k:anchor=suffix,rho=5"])
@pytest.mark.parametrize("num_steps", [7, 50])
def test_slice_anchor_timesteps_matches_jax(name, num_steps):
    """The timesteps MagicMix searches for its start: the linear grid for
    the Karras names (with or without options), the plan's own otherwise."""
    ref = jax_sched.slice_anchor_timesteps(name, num_steps)
    out = sched.slice_anchor_timesteps(name, num_steps)
    assert out.dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(out, ref)
