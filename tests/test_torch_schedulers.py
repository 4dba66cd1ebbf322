"""
The port's samplers (riffusion_tpu_torch/diffusion/schedulers.py) against
the JAX package's: the same plans, and the same latents after a run of
`step` fed the same eps sequence (PNDM's duplicated second timestep and its
ets ring, LMS's filling history and euler_a's per-step noise are where a
port goes wrong).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import jax_ancestral_draws, torch_one_thread  # noqa: F401  (autouse)
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
    lat_t, st_t = torch.from_numpy(sample), sched.init_state(plan_t, shape, torch.float32, "cpu")
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
    with pytest.raises(ValueError, match="Unknown scheduler"):
        sched.make_plan("ddpm", 10)


# ------------------------------------------------------------ dpmpp and unipc

SIGMA_SCHEDULERS = ["dpmpp", "dpmpp_k", "unipc", "unipc_k:rho=2"]


@pytest.mark.parametrize("name", SIGMA_SCHEDULERS)
@pytest.mark.parametrize("num_steps,t_start", [(16, 4), (24, 6), (50, 13)])
def test_sigma_plan_matches_jax(name, num_steps, t_start):
    """The plans are the same numpy code on both sides: 1e-6."""
    pj = jax_sched.make_plan(name, num_steps, t_start)
    pt = sched.make_plan(name, num_steps, t_start)
    assert pt.name == pj.name and pt.history == pj.history
    np.testing.assert_array_equal(pt.timesteps, pj.timesteps)
    assert set(pt.coeffs) == set(pj.coeffs)
    for key, value in pj.coeffs.items():
        np.testing.assert_allclose(pt.coeffs[key], np.asarray(value), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("anchor", ["suffix", "suffix_exact"])
def test_karras_anchor_options_match_jax(anchor):
    name = f"dpmpp_k:anchor={anchor},rho=5"
    pj, pt = jax_sched.make_plan(name, 20, 5), sched.make_plan(name, 20, 5)
    np.testing.assert_array_equal(pt.timesteps, pj.timesteps)
    np.testing.assert_allclose(pt.coeffs["sigmas"], pj.coeffs["sigmas"], rtol=1e-6)


@pytest.mark.parametrize("name", SIGMA_SCHEDULERS)
@pytest.mark.parametrize("edit", [False, True], ids=["plain", "edited"])
def test_sigma_steps_match_jax(name, edit):
    """A run of `step` on the same latents and eps, in float32. With `edit`
    the latents are changed between steps (what mask re-noising does), which
    unipc's delta correction has to carry. Latents of order 10: 1e-5
    relative is float32 rounding with room for another operation order."""
    plan_j, plan_t = jax_sched.make_plan(name, 16, 4), sched.make_plan(name, 16, 4)
    rng = np.random.default_rng(5)
    shape = (2, 4, 6, 5)
    sample = (plan_t.coeffs["sigmas"][0] * rng.standard_normal(shape)).astype(np.float32)
    eps_seq = rng.standard_normal((plan_j.num_steps,) + shape).astype(np.float32)
    lat_j, st_j = jnp.asarray(sample), jax_sched.init_state(plan_j, shape, jnp.float32)
    lat_t, st_t = torch.from_numpy(sample), sched.init_state(plan_t, shape, torch.float32, "cpu")
    for i in range(plan_j.num_steps):
        lat_j, st_j = jax_sched.step(plan_j, st_j, jnp.asarray(i), jnp.asarray(eps_seq[i]), lat_j)
        lat_t, st_t = sched.step(plan_t, st_t, i, torch.from_numpy(eps_seq[i]), lat_t)
        if edit:
            lat_j = 0.9 * lat_j + 0.1 * jnp.asarray(sample)
            lat_t = 0.9 * lat_t + 0.1 * torch.from_numpy(sample)
        scale = float(np.max(np.abs(np.asarray(lat_j))))
        assert float(np.max(np.abs(lat_t.numpy() - np.asarray(lat_j)))) < 1e-5 * scale, i


@pytest.mark.parametrize("name", ["pndm", "dpmpp", "unipc_k:rho=2"])
def test_noising_and_input_scaling_match_jax(name):
    cfg_j, cfg_t = jax_sched.NoiseConfig(), sched.NoiseConfig()
    plan_j, plan_t = jax_sched.make_plan(name, 16, 4), sched.make_plan(name, 16, 4)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    n = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    xt, nt, xj, nj = torch.from_numpy(x), torch.from_numpy(n), jnp.asarray(x), jnp.asarray(n)
    for i in (0, 3, plan_t.num_steps - 1):
        pairs = [
            (sched.add_noise_at_index(plan_t, cfg_t, xt, nt, i),
             jax_sched.add_noise_at_index(plan_j, cfg_j, xj, nj, i)),
            (sched.scale_model_input(plan_t, xt, i), jax_sched.scale_model_input(plan_j, xj, i)),
        ]
        if name != "pndm":
            pairs.append((sched.add_noise_sigma(plan_t, xt, nt, i),
                          jax_sched.add_noise_sigma(plan_j, xj, nj, i)))
        for out, ref in pairs:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "name,match",
    [("unipc_k:rho=2,bogus=1", "unknown scheduler options"),
     ("dpmpp:rho=2", "only apply to"),
     ("unipc_k:anchor=middle", "unknown Karras slice anchor"),
     ("euler:rho=2", "only apply to"),
     ("ddpm", "Unknown scheduler")],
)
def test_bad_scheduler_names_raise_as_in_jax(name, match):
    with pytest.raises(ValueError, match=match):
        sched.make_plan(name, 16, 4)
    with pytest.raises(ValueError, match=match):
        jax_sched.make_plan(name, 16, 4)


def test_fast_preset_unet_evaluations():
    """The FAST preset at the gated strength 0.75 (unipc_k:rho=2, 16 steps)
    and its fallback at 0.65 (dpmpp, 24 steps): 12 and 15 evaluations."""
    def evals(name, num_steps, strength):
        init_timestep = min(int(num_steps * strength) + 1, num_steps)
        return sched.make_plan(name, num_steps, max(num_steps - init_timestep + 1, 0)).num_steps

    assert evals("unipc_k:rho=2", 16, 0.75) == 12
    assert evals("dpmpp", 24, 0.65) == 15
    assert sched.make_plan("unipc_k:rho=2", 16, 4) is sched.make_plan("unipc_k:rho=2", 16, 4)


# ------------------------------------------------------ ddim, lms, euler, euler_a

NEW_SCHEDULERS = ["ddim", "lms", "euler", "euler_a"]


def test_scheduler_names_match_jax():
    assert sched.SCHEDULER_NAMES == jax_sched.SCHEDULER_NAMES
    assert sched.SIGMA_BASED == jax_sched.SIGMA_BASED
    assert sched.KARRAS_GRID == jax_sched.KARRAS_GRID


@pytest.mark.parametrize("name", NEW_SCHEDULERS)
@pytest.mark.parametrize("num_steps,t_start", [(50, 0), (50, 13), (16, 4), (7, 0), (7, 6)])
def test_new_plan_matches_jax(name, num_steps, t_start):
    """The same numpy code on both sides (lms's scipy quadrature too): equal
    timesteps and coefficients within 1e-6, the same history and starting
    noise scale."""
    pj = jax_sched.make_plan(name, num_steps, t_start)
    pt = sched.make_plan(name, num_steps, t_start)
    assert (pt.name, pt.num_steps, pt.history) == (pj.name, pj.num_steps, pj.history)
    assert pt.init_noise_sigma == pytest.approx(pj.init_noise_sigma, rel=1e-12)
    np.testing.assert_array_equal(pt.timesteps, pj.timesteps)
    assert set(pt.coeffs) == set(pj.coeffs)
    for key, value in pj.coeffs.items():
        np.testing.assert_allclose(pt.coeffs[key], np.asarray(value), rtol=1e-6, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["pndm", "dpmpp", "unipc_k:rho=2"])
def test_init_noise_sigma_matches_jax(name):
    for t_start in (0, 5):
        pj, pt = jax_sched.make_plan(name, 20, t_start), sched.make_plan(name, 20, t_start)
        assert pt.init_noise_sigma == pytest.approx(pj.init_noise_sigma, rel=1e-12)


@pytest.mark.parametrize("name", NEW_SCHEDULERS)
@pytest.mark.parametrize("num_steps,t_start", [(12, 0), (16, 4), (6, 5)])
def test_new_steps_match_jax(name, num_steps, t_start):
    """A run of `step` on the same latents and eps, float32, batch of 2.
    euler_a's noise is the JAX stepper's own: its per-item keys split once a
    step and drawn at (1, ...) each, replayed here and fed to the port. With
    latents of order 10 (sigma_0 up to 14.6): 1e-5 relative is float32
    rounding with room for another operation order."""
    plan_j = jax_sched.make_plan(name, num_steps, t_start)
    plan_t = sched.make_plan(name, num_steps, t_start)
    rng = np.random.default_rng(7)
    shape = (2, 4, 6, 5)
    sample = (plan_t.init_noise_sigma * rng.standard_normal(shape)).astype(np.float32)
    eps_seq = rng.standard_normal((plan_j.num_steps,) + shape).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), shape[0])
    ancestral = None
    if name == "euler_a":
        ancestral = torch.from_numpy(jax_ancestral_draws(keys, plan_j.num_steps, shape[1:]))
    lat_j = jnp.asarray(sample)
    st_j = jax_sched.init_state(plan_j, shape, jnp.float32, key=keys)
    lat_t = torch.from_numpy(sample)
    st_t = sched.init_state(plan_t, shape, torch.float32, "cpu", ancestral=ancestral)
    for i in range(plan_j.num_steps):
        lat_j, st_j = jax_sched.step(plan_j, st_j, jnp.asarray(i), jnp.asarray(eps_seq[i]), lat_j)
        lat_t, st_t = sched.step(plan_t, st_t, i, torch.from_numpy(eps_seq[i]), lat_t)
        scale = float(np.max(np.abs(np.asarray(lat_j))))
        assert float(np.max(np.abs(lat_t.numpy() - np.asarray(lat_j)))) < 1e-5 * scale, i


def test_euler_a_needs_its_noise():
    plan = sched.make_plan("euler_a", 8)
    with pytest.raises(ValueError, match="per-step noise of shape"):
        sched.init_state(plan, (1, 4, 2, 2), torch.float32, "cpu")
    with pytest.raises(ValueError, match="per-step noise of shape"):
        sched.init_state(plan, (1, 4, 2, 2), torch.float32, "cpu",
                         ancestral=torch.zeros(7, 1, 4, 2, 2))
    with pytest.raises(ValueError, match="takes no per-step noise"):
        sched.init_state(sched.make_plan("euler", 8), (1, 4, 2, 2), torch.float32, "cpu",
                         ancestral=torch.zeros(8, 1, 4, 2, 2))


@pytest.mark.parametrize("name", NEW_SCHEDULERS)
def test_new_noising_and_input_scaling_match_jax(name):
    """img2img's start and mask re-noising in each sampler's own space
    (DDPM for ddim, sigma for the others), and the UNet input scaling."""
    cfg_j, cfg_t = jax_sched.NoiseConfig(), sched.NoiseConfig()
    plan_j, plan_t = jax_sched.make_plan(name, 16, 4), sched.make_plan(name, 16, 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    n = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    xt, nt, xj, nj = torch.from_numpy(x), torch.from_numpy(n), jnp.asarray(x), jnp.asarray(n)
    assert (name in sched.SIGMA_BASED) == (name != "ddim")
    for i in (0, 3, plan_t.num_steps - 1):
        for out, ref in [
            (sched.add_noise_at_index(plan_t, cfg_t, xt, nt, i),
             jax_sched.add_noise_at_index(plan_j, cfg_j, xj, nj, i)),
            (sched.scale_model_input(plan_t, xt, i), jax_sched.scale_model_input(plan_j, xj, i)),
        ]:
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
