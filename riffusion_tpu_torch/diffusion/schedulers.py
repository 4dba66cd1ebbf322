"""
Diffusion schedulers on tensors: DDIM, PNDM (PLMS), LMS, Euler,
Euler-Ancestral, DPM-Solver++(2M) and the UniPC-style exponential
predictor-corrector, the last two on the linear sigma grid or (the `_k`
variants) the Karras rho-spaced grid.

The counterpart of riffusion_tpu/diffusion/schedulers.py: a host-side
*plan* (numpy per-step timesteps and coefficients, computed once per
(scheduler, steps, t_start)) and a pure `step(plan, state, i, model_output,
sample)` with a fixed-size history ring. The plan builders are copies of the
JAX package's numpy code (it cannot be imported without jax), held to it by
tests/test_torch_schedulers.py; the denoise loop that calls `step` is a
plain Python loop in the pipeline, so `i` is a Python int here.

A step reads its scalar coefficients as Python floats (the plan is part of
a captured program's key, riffusion_tpu_torch/aot.py) and its rows of
weights from the plan's tables on the device (`device_table`), uploaded
once per plan and device and held by the plan, so a captured CUDA graph's
steps copy nothing from the host.

euler_a adds noise at every step. The JAX package keeps a PRNG key per
batch item in the stepper's state; here the caller draws every step's noise
up front, one (S, N, C, h, w) tensor (`init_state(..., ancestral=...)`), so
each request's draws come from its own noise source.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as T

import numpy as np
import torch

SCHEDULER_NAMES = (
    "pndm", "ddim", "lms", "euler", "euler_a", "dpmpp", "dpmpp_k", "unipc", "unipc_k"
)

#: Schedulers on the Karras rho-spaced sigma grid; only they take grid
#: options ("unipc_k:rho=2", "dpmpp_k:anchor=suffix_exact,rho=5").
KARRAS_GRID = ("dpmpp_k", "unipc_k")

#: Schedulers whose step works in k-diffusion sigma space (x = x0 + sigma*eps)
#: rather than DDPM space: their img2img start and mask re-noising use
#: `add_noise_sigma`, and the UNet input is divided by sqrt(sigma^2 + 1).
SIGMA_BASED = ("lms", "euler", "euler_a", "dpmpp", "dpmpp_k", "unipc", "unipc_k")


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Training-time noise schedule (SD v1 defaults)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False  # DDIM/PNDM final-alpha convention
    #: The sigma samplers' grid: "linspace" (t evenly over [0, T - 1]) or
    #: diffusers' "leading" (every T // steps-th timestep plus steps_offset,
    #: Stable Diffusion XL's). DDIM and PNDM are "leading" by construction.
    timestep_spacing: str = "linspace"

    @functools.cached_property
    def alphas_cumprod(self) -> np.ndarray:
        n = self.num_train_timesteps
        if self.beta_schedule == "scaled_linear":
            betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5, n) ** 2
        elif self.beta_schedule == "linear":
            betas = np.linspace(self.beta_start, self.beta_end, n)
        else:
            raise ValueError(f"Unknown beta schedule {self.beta_schedule}")
        return np.cumprod(1.0 - betas).astype(np.float64)

    @property
    def final_alpha_cumprod(self) -> float:
        return 1.0 if self.set_alpha_to_one else float(self.alphas_cumprod[0])


@dataclasses.dataclass(frozen=True)
class SchedulerPlan:
    """Precomputed per-step arrays for one (scheduler, num_steps, t_start).
    `timesteps[i]` is what the UNet sees at loop index i; `name` is the
    stepper family (dpmpp_k plans are named "dpmpp")."""

    name: str
    num_inference_steps: int
    timesteps: np.ndarray  # (S,) int32
    coeffs: T.Dict[str, np.ndarray]
    init_noise_sigma: float = 1.0  # the scale of txt2img's starting noise
    history: int = 1  # size of the history ring the stepper keeps
    # device_table's uploads, (name, device, dtype) -> tensor, held as long
    # as the plan: a captured graph reads them where they were captured
    _device: T.Dict[T.Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False)

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    def device_table(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """coeffs[name] as a tensor in `like`'s dtype on its device, uploaded
        on first use and kept."""
        key = (name, like.device, like.dtype)
        if key not in self._device:  # the first upload stays: a graph may hold its address
            self._device.setdefault(key, torch.as_tensor(self.coeffs[name], dtype=like.dtype,
                                                         device=like.device))
        return self._device[key]


# ------------------------------------------------------------- sigma grids


def _interp_sigmas(noise: NoiseConfig, num_steps: int) -> T.Tuple[np.ndarray, np.ndarray]:
    """k-diffusion sigmas linearly interpolated over the train steps:
    (timesteps as floats, descending; sigmas, descending, with a final 0)."""
    acp = noise.alphas_cumprod
    sigmas_full = ((1 - acp) / acp) ** 0.5
    if noise.timestep_spacing == "leading":
        ratio = noise.num_train_timesteps // num_steps
        t = (np.arange(num_steps, dtype=np.float64) * ratio + noise.steps_offset)[::-1]
    elif noise.timestep_spacing == "linspace":
        t = np.linspace(0, noise.num_train_timesteps - 1, num_steps, dtype=np.float64)[::-1]
    else:
        raise ValueError(f"Unknown timestep spacing {noise.timestep_spacing!r}")
    sigmas = np.interp(t, np.arange(len(sigmas_full)), sigmas_full)
    return t, np.concatenate([sigmas, [0.0]])


def _karras_sigmas(
    noise: NoiseConfig, num_steps: int, rho: float = 7.0, sigma_max: T.Optional[float] = None
) -> T.Tuple[np.ndarray, np.ndarray]:
    """Karras et al. (2022) rho-spaced sigmas over the trained range, or up
    to `sigma_max` (the img2img top); timesteps by inverting the training
    sigma curve in log-sigma space. Same return layout as _interp_sigmas."""
    acp = noise.alphas_cumprod
    sigmas_full = ((1 - acp) / acp) ** 0.5
    sigma_min = float(sigmas_full[0])
    if sigma_max is None:
        sigma_max = float(sigmas_full[-1])
    ramp = np.linspace(0, 1, num_steps, dtype=np.float64)
    min_inv, max_inv = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    sigmas = (max_inv + ramp * (min_inv - max_inv)) ** rho
    t = np.interp(np.log(sigmas), np.log(sigmas_full), np.arange(len(sigmas_full)))
    return t, np.concatenate([sigmas, [0.0]])


def _sliced_grid(
    noise: NoiseConfig, num_steps: int, t_start: int, karras: bool,
    rho: float = 7.0, anchor: str = "respace",
) -> T.Tuple[np.ndarray, np.ndarray]:
    """(t, sigmas) of the executed suffix of an img2img chain. The linear
    grid is sliced by index. A Karras grid is anchored to the linear grid's
    noise level at t_start: "respace" (default) respaces the executed steps
    below that level; "suffix" runs the full Karras grid from the index
    nearest it; "suffix_exact" does the same with the first sigma replaced
    by the exact level."""
    if anchor not in ("respace", "suffix", "suffix_exact"):
        raise ValueError(f"unknown Karras slice anchor {anchor!r}")
    if karras and 0 < t_start < num_steps:
        _, sig_lin = _interp_sigmas(noise, num_steps)
        sig_start = float(sig_lin[t_start])
        if anchor in ("suffix", "suffix_exact"):
            t, sigmas = _karras_sigmas(noise, num_steps, rho=rho)
            idx = int(np.argmin(np.abs(sigmas[:-1] - sig_start)))
            t, sigmas = t[idx:].copy(), sigmas[idx:].copy()
            if anchor == "suffix_exact":
                acp = noise.alphas_cumprod
                sigmas_full = ((1 - acp) / acp) ** 0.5
                sigmas[0] = sig_start
                t[0] = float(np.interp(
                    np.log(sig_start), np.log(sigmas_full), np.arange(len(sigmas_full))
                ))
            return t, sigmas
        return _karras_sigmas(noise, num_steps - t_start, rho=rho, sigma_max=sig_start)
    if karras:
        t, sigmas = _karras_sigmas(noise, num_steps, rho=rho)
    else:
        t, sigmas = _interp_sigmas(noise, num_steps)
    return t[t_start:], sigmas[t_start:]


# ---------------------------------------------------------------------- DDIM


def _make_ddim_plan(noise: NoiseConfig, num_steps: int, t_start: int = 0) -> SchedulerPlan:
    """DDIM (eta 0) on the PNDM timestep grid, without its duplicate."""
    step = noise.num_train_timesteps // num_steps
    timesteps = (np.arange(0, num_steps) * step + noise.steps_offset)[::-1].astype(np.int64)
    timesteps = timesteps[t_start:]
    acp = noise.alphas_cumprod
    prev_ts = timesteps - step
    alpha_t = acp[timesteps]
    alpha_prev = np.where(prev_ts >= 0, acp[np.maximum(prev_ts, 0)], noise.final_alpha_cumprod)
    return SchedulerPlan(
        name="ddim",
        num_inference_steps=num_steps,
        timesteps=timesteps.astype(np.int32),
        coeffs={"alpha_t": alpha_t.astype(np.float32),
                "alpha_prev": alpha_prev.astype(np.float32)},
    )


def _no_state(plan, shape, dtype, device, ancestral=None):
    return {}


def _ddim_step(plan, state, i, model_output, sample):
    """x0 from eps, then the deterministic step to alpha_prev; the square
    roots in float32, as the JAX step takes them."""
    f32 = np.float32
    a_t, a_prev = f32(plan.coeffs["alpha_t"][i]), f32(plan.coeffs["alpha_prev"][i])
    x0 = (sample - float(np.sqrt(f32(1) - a_t)) * model_output) / float(np.sqrt(a_t))
    prev = float(np.sqrt(a_prev)) * x0 + float(np.sqrt(f32(1) - a_prev)) * model_output
    return prev, state


# ---------------------------------------------------------------------- PNDM


def _make_pndm_plan(noise: NoiseConfig, num_steps: int, t_start: int = 0) -> SchedulerPlan:
    """PLMS (PNDM with skip_prk_steps=True, the SD/riffusion configuration).
    `t_start` slices the global timestep sequence (img2img starts partway
    down); the warmup behaviour stays relative to the executed suffix."""
    n = noise.num_train_timesteps
    step = n // num_steps
    ts_asc = (np.arange(0, num_steps) * step + noise.steps_offset).astype(np.int64)
    # the PLMS timestep sequence duplicates the second step (counter 1 re-uses it)
    seq = np.concatenate([ts_asc[:-1], ts_asc[-2:-1], ts_asc[-1:]])[::-1].copy()
    seq = seq[t_start:]

    acp = noise.alphas_cumprod
    s = len(seq)
    t_used = np.empty(s, np.int64)
    t_prev = np.empty(s, np.int64)
    weights = np.zeros((s, 4), np.float64)
    push = np.zeros(s, bool)
    avg_with_last = np.zeros(s, bool)
    use_cur_sample = np.zeros(s, bool)

    ets_len = 0
    for i in range(s):
        t = int(seq[i])
        if i == 1:
            # counter==1: average with the last et, reuse the stored sample,
            # step from t+step down to t
            t_used[i], t_prev[i] = t + step, t
            avg_with_last[i] = True
            use_cur_sample[i] = True
            weights[i, 0] = 1.0
        else:
            t_used[i], t_prev[i] = t, t - step
            push[i] = True
            ets_len = min(ets_len + 1, 4)
            if ets_len == 1:
                weights[i, :1] = [1.0]
            elif ets_len == 2:
                weights[i, :2] = [3 / 2, -1 / 2]
            elif ets_len == 3:
                weights[i, :3] = [23 / 12, -16 / 12, 5 / 12]
            else:
                weights[i, :4] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]

    alpha_t = acp[np.clip(t_used, 0, n - 1)]
    alpha_prev = np.where(t_prev >= 0, acp[np.clip(t_prev, 0, n - 1)], noise.final_alpha_cumprod)
    sample_coeff = (alpha_prev / alpha_t) ** 0.5
    denom = alpha_t * (1 - alpha_prev) ** 0.5 + (alpha_t * (1 - alpha_t) * alpha_prev) ** 0.5
    output_coeff = (alpha_prev - alpha_t) / denom

    return SchedulerPlan(
        name="pndm",
        num_inference_steps=num_steps,
        timesteps=seq.astype(np.int32),
        coeffs={
            "weights": weights.astype(np.float32),
            "push": push.astype(np.float32),
            "avg_with_last": avg_with_last.astype(np.float32),
            "use_cur_sample": use_cur_sample.astype(np.float32),
            "sample_coeff": sample_coeff.astype(np.float32),
            "output_coeff": output_coeff.astype(np.float32),
        },
        history=4,
    )


def _pndm_init_state(plan, shape, dtype, device, ancestral=None):
    """The eps ring (newest at index 0) and the sample stored at step 0 for
    reuse at step 1."""
    return {
        "ets": torch.zeros((4,) + tuple(shape), dtype=dtype, device=device),
        "cur_sample": torch.zeros(tuple(shape), dtype=dtype, device=device),
    }


def _pndm_step(plan, state, i, model_output, sample):
    c = plan.coeffs
    ets = state["ets"]
    cur_sample = sample if i == 0 else state["cur_sample"]
    sample_eff = cur_sample if c["use_cur_sample"][i] > 0 else sample
    if c["push"][i] > 0:
        ets = torch.cat([model_output[None], ets[:-1]], dim=0)
    if c["avg_with_last"][i] > 0:
        e_eff = 0.5 * (model_output + ets[0])
    else:
        e_eff = torch.tensordot(plan.device_table("weights", ets)[i], ets, dims=1)
    prev = float(c["sample_coeff"][i]) * sample_eff - float(c["output_coeff"][i]) * e_eff
    return prev, {"ets": ets, "cur_sample": cur_sample}


# -------------------------------------------------------- LMS, Euler, Euler-a


def _make_lms_plan(
    noise: NoiseConfig, num_steps: int, t_start: int = 0, order: int = 4
) -> SchedulerPlan:
    """k-diffusion's linear multistep: per step, the integrals over
    [sigma_i, sigma_i+1] of the Lagrange basis over the last `order` sigmas
    (fewer while the history fills), newest first."""
    from scipy import integrate

    t, sigmas = _sliced_grid(noise, num_steps, t_start, karras=False)
    n_exec = len(t)
    coeffs = np.zeros((n_exec, order), np.float64)
    for i in range(n_exec):
        cur_order = min(i + 1, order)
        for j in range(cur_order):

            def lms_derivative(tau, j=j, i=i, cur_order=cur_order):
                prod = 1.0
                for k in range(cur_order):
                    if j == k:
                        continue
                    prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
                return prod

            coeffs[i, j] = integrate.quad(
                lms_derivative, sigmas[i], sigmas[i + 1], epsrel=1e-4
            )[0]

    return SchedulerPlan(
        name="lms",
        num_inference_steps=num_steps,
        timesteps=np.round(t).astype(np.int32),
        coeffs={"sigmas": sigmas.astype(np.float32), "lms": coeffs.astype(np.float32),
                "t_float": t.astype(np.float32)},
        init_noise_sigma=float(np.max(sigmas)),
        history=order,
    )


def _lms_init_state(plan, shape, dtype, device, ancestral=None):
    """The derivative ring, newest at index 0."""
    return {"derivs": torch.zeros((plan.history,) + tuple(shape), dtype=dtype, device=device)}


def _derivative(plan, i, model_output, sample):
    """d = (x - x0) / sigma_i, formed as the JAX steps form it."""
    sigma = float(plan.coeffs["sigmas"][i])
    x0 = sample - sigma * model_output
    return (sample - x0) / sigma


def _lms_step(plan, state, i, model_output, sample):
    d = _derivative(plan, i, model_output, sample)
    derivs = torch.cat([d[None], state["derivs"][:-1]], dim=0)
    prev = sample + torch.tensordot(plan.device_table("lms", derivs)[i], derivs, dims=1)
    return prev, {"derivs": derivs}


def _make_euler_plan(
    noise: NoiseConfig, num_steps: int, t_start: int = 0, ancestral: bool = False
) -> SchedulerPlan:
    """Euler on the linear sigma grid; `ancestral` adds each step's split
    of the target sigma into a deterministic part (sigma_down) and fresh
    noise (sigma_up), both clamped at 0."""
    t, sigmas = _sliced_grid(noise, num_steps, t_start, karras=False)
    coeffs: T.Dict[str, np.ndarray] = {"sigmas": sigmas.astype(np.float32),
                                       "t_float": t.astype(np.float32)}
    if ancestral:
        s_from, s_to = sigmas[:-1], sigmas[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma_up = np.sqrt(
                np.maximum(s_to**2 * (s_from**2 - s_to**2) / np.maximum(s_from**2, 1e-20), 0)
            )
            sigma_down = np.sqrt(np.maximum(s_to**2 - sigma_up**2, 0))
        coeffs["sigma_up"] = sigma_up.astype(np.float32)
        coeffs["sigma_down"] = sigma_down.astype(np.float32)
    return SchedulerPlan(
        name="euler_a" if ancestral else "euler",
        num_inference_steps=num_steps,
        timesteps=np.round(t).astype(np.int32),
        coeffs=coeffs,
        init_noise_sigma=float(np.max(sigmas)),
    )


def _euler_step(plan, state, i, model_output, sample):
    sigmas = plan.coeffs["sigmas"]
    d = _derivative(plan, i, model_output, sample)
    return sample + d * float(sigmas[i + 1] - sigmas[i]), state


def _euler_a_init_state(plan, shape, dtype, device, ancestral=None):
    """Every step's noise for the N items, (S, N, C, h, w)."""
    want = (plan.num_steps,) + tuple(shape)
    if ancestral is None or tuple(ancestral.shape) != want:
        got = None if ancestral is None else tuple(ancestral.shape)
        raise ValueError(f"euler_a needs its per-step noise of shape {want}, got {got}")
    return {"ancestral": ancestral.to(device=device, dtype=dtype)}


def _euler_a_step(plan, state, i, model_output, sample):
    c = plan.coeffs
    d = _derivative(plan, i, model_output, sample)
    prev = sample + d * float(c["sigma_down"][i] - c["sigmas"][i])
    return prev + state["ancestral"][i] * float(c["sigma_up"][i]), state


# ------------------------------------------------------------- DPM-Solver++ 2M


def _make_dpmpp_plan(
    noise: NoiseConfig, num_steps: int, t_start: int = 0, karras: bool = False,
    rho: float = 7.0, anchor: str = "respace",
) -> SchedulerPlan:
    """DPM-Solver++(2M) plan; `karras=True` is the "dpmpp_k" grid."""
    t, sigmas = _sliced_grid(noise, num_steps, t_start, karras, rho=rho, anchor=anchor)
    lam = -np.log(np.maximum(sigmas, 1e-10))
    # The last step reaches sigma 0 (h -> inf): first order there, as
    # k-diffusion's dpmpp_2m does.
    first_order = (sigmas[1:] == 0.0).astype(np.float32)
    return SchedulerPlan(
        name="dpmpp",
        num_inference_steps=num_steps,
        timesteps=np.round(t).astype(np.int32),
        coeffs={"sigmas": sigmas.astype(np.float32), "lam": lam.astype(np.float32),
                "t_float": t.astype(np.float32), "first_order": first_order},
        init_noise_sigma=float(np.max(sigmas)),
        history=2,
    )


def _dpmpp_init_state(plan, shape, dtype, device, ancestral=None):
    return {"x0_prev": torch.zeros(tuple(shape), dtype=dtype, device=device), "has_prev": False}


def _dpmpp_step(plan, state, i, model_output, sample):
    """DPM-Solver++(2M) in k-diffusion sigma space (data prediction). The
    scalar coefficients are computed in float32, as the JAX step does."""
    f32 = np.float32
    sigmas = plan.coeffs["sigmas"]
    sigma, sigma_next = sigmas[i], sigmas[i + 1]
    x0 = sample - float(sigma) * model_output

    def t_fn(s):
        return -np.log(np.maximum(s, f32(1e-10)))

    t_cur, t_next = t_fn(sigma), t_fn(sigma_next)
    h = t_next - t_cur
    h_last = t_cur - t_fn(sigmas[max(i - 1, 0)])
    r = h_last / (f32(1.0) if h == 0 else h)
    if state["has_prev"] and plan.coeffs["first_order"][i] == 0:
        inv = f32(1) / (f32(2) * np.maximum(r, f32(1e-5)))
        x0_d = float(f32(1) + inv) * x0 - float(inv) * state["x0_prev"]
    else:
        x0_d = x0
    ratio = sigma_next / np.maximum(sigma, f32(1e-10))
    prev = float(ratio) * sample - float(np.expm1(-h)) * x0_d
    return prev, {"x0_prev": x0, "has_prev": True}


# ------------------------------------------------------ UniPC (predictor-corrector)


def _exp_lagrange_weights(t_nodes: np.ndarray, t_a: float, t_b: float) -> np.ndarray:
    """w_j = int_{t_a}^{t_b} e^{s - t_b} L_j(s) ds over the Lagrange basis of
    `t_nodes`: the exponential-integrator quadrature weights for
    x' = x0(t) - x in lambda = -log(sigma) space."""
    from scipy import integrate

    k = len(t_nodes)
    w = np.zeros(k, np.float64)
    for j in range(k):

        def basis(s, j=j):
            prod = np.exp(s - t_b)
            for m in range(k):
                if m == j:
                    continue
                prod *= (s - t_nodes[m]) / (t_nodes[j] - t_nodes[m])
            return prod

        w[j] = integrate.quad(basis, t_a, t_b, epsrel=1e-10)[0]
    return w


def _make_unipc_plan(
    noise: NoiseConfig, num_steps: int, t_start: int = 0, karras: bool = False,
    order: int = 2, rho: float = 7.0, anchor: str = "respace",
) -> SchedulerPlan:
    """Exponential Adams predictor of order `order` over the x0 history,
    and at the next model evaluation an order+1 corrector that
    re-integrates the step just taken (no extra UNet evaluation). All
    weights depend on the sigma grid only (newest-first ring layout)."""
    t, sigmas = _sliced_grid(noise, num_steps, t_start, karras, rho=rho, anchor=anchor)
    s = len(t)
    lam = -np.log(np.maximum(sigmas, 1e-10))

    ring = order + 1
    pred_w = np.zeros((s, ring), np.float64)
    corr_w = np.zeros((s, ring), np.float64)
    pred_ratio = np.zeros(s, np.float64)
    corr_ratio = np.zeros(s, np.float64)
    corr_on = np.zeros(s, np.float64)

    for i in range(s):
        pred_ratio[i] = sigmas[i + 1] / sigmas[i]
        if sigmas[i + 1] == 0.0:
            # h -> inf: the exact limit is the newest x0
            pred_w[i, 0] = 1.0
        else:
            k_p = min(i + 1, order)
            nodes = lam[i - np.arange(k_p)]
            pred_w[i, :k_p] = _exp_lagrange_weights(nodes, lam[i], lam[i + 1])
        if i >= 1:
            corr_on[i] = 1.0
            corr_ratio[i] = sigmas[i] / sigmas[i - 1]
            k_c = min(i + 1, ring)
            nodes = lam[i - np.arange(k_c)]
            corr_w[i, :k_c] = _exp_lagrange_weights(nodes, lam[i - 1], lam[i])

    return SchedulerPlan(
        name="unipc",
        num_inference_steps=num_steps,
        timesteps=np.round(t).astype(np.int32),
        coeffs={
            "sigmas": sigmas.astype(np.float32),
            "t_float": t.astype(np.float32),
            "pred_w": pred_w.astype(np.float32),
            "corr_w": corr_w.astype(np.float32),
            "pred_ratio": pred_ratio.astype(np.float32),
            "corr_ratio": corr_ratio.astype(np.float32),
            "corr_on": corr_on.astype(np.float32),
        },
        init_noise_sigma=float(np.max(sigmas)),
        history=ring,
    )


def _unipc_init_state(plan, shape, dtype, device, ancestral=None):
    def zeros(lead=()):
        return torch.zeros(lead + tuple(shape), dtype=dtype, device=device)

    return {"x0_ring": zeros((plan.history,)), "sample_prev": zeros(), "x_pred_prev": zeros()}


def _unipc_step(plan, state, i, model_output, sample):
    """Correct the previous step with the fresh x0, then predict the next.
    The correction is a delta on the incoming `sample`, so an edit made
    between steps (mask re-noising) survives it."""
    c = plan.coeffs
    x0 = sample - float(c["sigmas"][i]) * model_output
    ring = torch.cat([x0[None], state["x0_ring"][:-1]], dim=0)
    x_i = sample
    if c["corr_on"][i] > 0:
        corrected = float(c["corr_ratio"][i]) * state["sample_prev"] + torch.tensordot(
            plan.device_table("corr_w", ring)[i], ring, dims=1
        )
        x_i = sample + (corrected - state["x_pred_prev"])
    x_next = float(c["pred_ratio"][i]) * x_i + torch.tensordot(
        plan.device_table("pred_w", ring)[i], ring, dims=1
    )
    return x_next, {"x0_ring": ring, "sample_prev": x_i, "x_pred_prev": x_next}


# ----------------------------------------------------------------- interface


_MAKERS: T.Dict[str, T.Callable[..., SchedulerPlan]] = {
    "pndm": _make_pndm_plan,
    "ddim": _make_ddim_plan,
    "lms": _make_lms_plan,
    "euler": _make_euler_plan,
    "euler_a": functools.partial(_make_euler_plan, ancestral=True),
    "dpmpp": _make_dpmpp_plan,
    "dpmpp_k": functools.partial(_make_dpmpp_plan, karras=True),
    "unipc": _make_unipc_plan,
    "unipc_k": functools.partial(_make_unipc_plan, karras=True),
}

_FAMILIES = {
    "pndm": (_pndm_init_state, _pndm_step),
    "ddim": (_no_state, _ddim_step),
    "lms": (_lms_init_state, _lms_step),
    "euler": (_no_state, _euler_step),
    "euler_a": (_euler_a_init_state, _euler_a_step),
    "dpmpp": (_dpmpp_init_state, _dpmpp_step),
    "unipc": (_unipc_init_state, _unipc_step),
}


def parse_scheduler(name: str) -> T.Tuple[str, T.Dict[str, str]]:
    """"unipc_k:rho=3,anchor=suffix" -> ("unipc_k", {"rho": "3", "anchor": "suffix"})."""
    base, _, opts_s = name.partition(":")
    opts: T.Dict[str, str] = {}
    for tok in opts_s.split(","):
        if tok:
            k, _, v = tok.partition("=")
            opts[k] = v
    return base, opts


@functools.lru_cache(maxsize=64)
def make_plan(
    name: str, num_steps: int, t_start: int = 0, noise: NoiseConfig = NoiseConfig()
) -> SchedulerPlan:
    """Build (cached) the plan for `num_steps` inference steps, starting at
    position `t_start` of the global sequence (img2img). Karras-grid names
    take grid options after a colon (`rho`, `anchor`)."""
    base, opts = parse_scheduler(name)
    if base not in _MAKERS:
        raise ValueError(f"Unknown scheduler {base!r}; choose from {SCHEDULER_NAMES}")
    kwargs: T.Dict[str, T.Any] = {}
    if opts:
        if base not in KARRAS_GRID:
            raise ValueError(f"grid options {opts} only apply to {KARRAS_GRID}")
        unknown = set(opts) - {"rho", "anchor"}
        if unknown:
            raise ValueError(f"unknown scheduler options {sorted(unknown)}")
        if "rho" in opts:
            kwargs["rho"] = float(opts["rho"])
        if "anchor" in opts:
            kwargs["anchor"] = opts["anchor"]
    return _MAKERS[base](noise, num_steps, t_start, **kwargs)


def slice_anchor_timesteps(
    name: str, num_steps: int, noise: NoiseConfig = NoiseConfig()
) -> np.ndarray:
    """Timesteps in the space that `t_start` slices for `name`. Karras-grid
    schedulers re-anchor the sliced suffix to the linear grid's sigma at
    t_start, so a caller choosing t_start from a timestep bound (MagicMix's
    kmax) must search the LINEAR grid; every other plan slices its own
    timesteps."""
    base = parse_scheduler(name)[0]
    if base in KARRAS_GRID:
        t, _ = _interp_sigmas(noise, num_steps)
        return np.round(t).astype(np.int32)
    return np.asarray(make_plan(base, num_steps, 0, noise).timesteps)


def draws_noise(plan: SchedulerPlan) -> bool:
    """Whether the plan's steps add fresh noise (an ancestral sampler, whose
    plan splits each step's sigma into sigma_down and sigma_up)."""
    return "sigma_up" in plan.coeffs


def init_state(
    plan: SchedulerPlan, shape, dtype: torch.dtype, device: T.Union[str, torch.device],
    ancestral: T.Optional[torch.Tensor] = None,
) -> T.Dict[str, T.Any]:
    """The stepper's initial state for latents of `shape` on `device`. A plan
    that `draws_noise` takes `ancestral`, every step's noise, (S,) + shape;
    the other samplers draw nothing."""
    if ancestral is not None and not draws_noise(plan):
        raise ValueError(f"{plan.name} takes no per-step noise")
    return _FAMILIES[plan.name][0](plan, shape, dtype, device, ancestral)


def step(plan: SchedulerPlan, state, i: int, model_output: torch.Tensor, sample: torch.Tensor):
    """One update at loop index i. Returns (prev_sample, new_state)."""
    return _FAMILIES[plan.name][1](plan, state, i, model_output, sample)


def scale_model_input(plan: SchedulerPlan, sample: torch.Tensor, i: int) -> torch.Tensor:
    """Pre-UNet latent scaling: sample / sqrt(sigma^2 + 1) for the
    sigma-space samplers, identity for PNDM and DDIM."""
    if plan.name in SIGMA_BASED:
        sigma = plan.coeffs["sigmas"][i]
        return sample / float(np.sqrt(sigma * sigma + np.float32(1.0)))
    return sample


def add_noise(
    noise_cfg: NoiseConfig, sample: torch.Tensor, noise: torch.Tensor,
    timestep: T.Union[int, torch.Tensor], table: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Forward-process noising at an integer train timestep (DDPM), one for
    the whole batch or, as a (B,) integer tensor, one per batch element (the
    training step's). `table`, for a tensor timestep: `alphas_cumprod_table`
    already on the sample's device (a captured program cannot upload it)."""
    acp = noise_cfg.alphas_cumprod.astype(np.float32)
    # both coefficients in fp32, as the JAX function computes them
    if isinstance(timestep, torch.Tensor):
        if table is None:
            table = alphas_cumprod_table(noise_cfg, sample.device)
        a = table[timestep.long()]
        a = a.view(-1, *([1] * (sample.dim() - 1)))
        return torch.sqrt(a) * sample + torch.sqrt(1.0 - a) * noise
    a = acp[int(timestep)]
    sqrt_a = float(np.sqrt(a))
    sqrt_1ma = float(np.sqrt(np.float32(1.0) - a))
    return sqrt_a * sample + sqrt_1ma * noise


def alphas_cumprod_table(noise_cfg: NoiseConfig, device: torch.device) -> torch.Tensor:
    """The fp32 cumulative alphas on `device`, indexed by train timestep."""
    return torch.from_numpy(noise_cfg.alphas_cumprod.astype(np.float32)).to(device)


def add_noise_sigma(
    plan: SchedulerPlan, sample: torch.Tensor, noise: torch.Tensor, i: int
) -> torch.Tensor:
    """Sigma-space noising at plan index i (the img2img start of the
    k-diffusion samplers)."""
    return sample + noise * float(plan.coeffs["sigmas"][i])


def add_noise_at_index(
    plan: SchedulerPlan, noise_cfg: NoiseConfig, sample: torch.Tensor, noise: torch.Tensor, i: int
) -> torch.Tensor:
    """Noise `sample` for use at plan index `i` (mask re-noising), in the
    scheduler's own working space."""
    if plan.name in SIGMA_BASED:
        return add_noise_sigma(plan, sample, noise, i)
    return add_noise(noise_cfg, sample, noise, int(plan.timesteps[i]))
