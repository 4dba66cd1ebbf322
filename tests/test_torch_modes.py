"""
The port's txt2img and img2img (riffusion_tpu_torch/riffusion_pipeline.py)
against the JAX package's on the CPU at the tiny geometry, on the JAX
programs' own draws, and euler_a's per-request noise on the batched path.
The fixtures, the JAX draws and the image bound are test_torch_pipeline.py's
(guidance 1.5-1.75 there and here, for the reason given beside them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from test_torch_pipeline import (  # noqa: F401  (fixtures)
    PARAMS, SIZE, _ancestral, _assert_images_agree, _batch_inputs, _draws_for, _inputs,
    _jax_draws, _low_guidance, pipes, seed_image,
)
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
