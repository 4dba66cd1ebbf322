"""
The port's PNDM (riffusion_tpu_torch/diffusion/schedulers.py) against the
JAX package's: the same plans, and the same latents after a run of `step`
fed the same eps sequence (the duplicated second timestep and the ets ring
are where a port goes wrong).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.diffusion import schedulers as jax_sched
from riffusion_tpu_torch.diffusion import schedulers as sched


@pytest.mark.parametrize("num_steps,t_start", [(50, 0), (50, 13), (8, 0), (8, 3)])
def test_pndm_plan_matches_jax(num_steps, t_start):
    pj = jax_sched.make_plan("pndm", num_steps, t_start)
    pt = sched.make_plan("pndm", num_steps, t_start)
    np.testing.assert_array_equal(pt.timesteps, pj.timesteps)
    assert pt.num_steps == pj.num_steps
    assert set(pt.coeffs) == set(pj.coeffs)
    for name, value in pj.coeffs.items():
        np.testing.assert_array_equal(pt.coeffs[name], np.asarray(value), err_msg=name)


def test_serving_plan_has_38_unet_evaluations():
    """50 steps at strength 0.75: the serving request's denoise length."""
    strength, num_steps, offset = 0.75, 50, 1
    init_timestep = min(int(num_steps * strength) + offset, num_steps)
    t_start = max(num_steps - init_timestep + offset, 0)
    assert t_start == 13
    assert sched.make_plan("pndm", num_steps, t_start).num_steps == 38


@pytest.mark.parametrize("t_start", [0, 3])
def test_pndm_steps_match_jax(t_start):
    """8 steps of `step` on the same eps sequence. float32 both sides, with
    coefficients of order 1-10 over 8 steps: 1e-5 relative is float32
    rounding with room for the different operation order."""
    plan_j = jax_sched.make_plan("pndm", 8 + t_start, t_start)
    plan_t = sched.make_plan("pndm", 8 + t_start, t_start)
    rng = np.random.default_rng(0)
    shape = (1, 4, 6, 5)
    sample = rng.standard_normal(shape).astype(np.float32)
    eps_seq = rng.standard_normal((plan_j.num_steps,) + shape).astype(np.float32)

    lat_j, st_j = jnp.asarray(sample), jax_sched.init_state(plan_j, shape, jnp.float32)
    lat_t, st_t = torch.from_numpy(sample), sched.init_state(plan_t, shape, torch.float32)
    for i in range(plan_j.num_steps):
        lat_j, st_j = jax_sched.step(plan_j, st_j, jnp.asarray(i), jnp.asarray(eps_seq[i]), lat_j)
        lat_t, st_t = sched.step(plan_t, st_t, i, torch.from_numpy(eps_seq[i]), lat_t)
        scale = float(np.max(np.abs(np.asarray(lat_j))))
        assert float(np.max(np.abs(lat_t.numpy() - np.asarray(lat_j)))) < 1e-5 * scale, i
        np.testing.assert_allclose(st_t["ets"].numpy(), np.asarray(st_j["ets"]), rtol=0,
                                   atol=1e-6)


def test_add_noise_matches_jax():
    cfg_j, cfg_t = jax_sched.NoiseConfig(), sched.NoiseConfig()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 3, 3)).astype(np.float32)
    n = rng.standard_normal((1, 4, 3, 3)).astype(np.float32)
    for t in (1, 501, 981):
        ref = np.asarray(jax_sched.add_noise(cfg_j, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)))
        out = sched.add_noise(cfg_t, torch.from_numpy(x), torch.from_numpy(n), t).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    plan_j, plan_t = jax_sched.make_plan("pndm", 10, 2), sched.make_plan("pndm", 10, 2)
    ref = jax_sched.add_noise_at_index(plan_j, cfg_j, jnp.asarray(x), jnp.asarray(n), 4)
    out = sched.add_noise_at_index(plan_t, cfg_t, torch.from_numpy(x), torch.from_numpy(n), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="not ported"):
        sched.make_plan("ddim", 10)
