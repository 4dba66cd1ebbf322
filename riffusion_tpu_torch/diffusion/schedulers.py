"""
PNDM (PLMS) scheduling on tensors.

The counterpart of the PNDM part of riffusion_tpu/diffusion/schedulers.py:
a host-side *plan* (numpy per-step timesteps and coefficients, computed once
per (steps, t_start)) and a pure `step(plan, state, i, model_output, sample)`
with a fixed four-entry history ring. The plan builder is a copy of the JAX
package's numpy code (it cannot be imported without jax); the denoise loop
that calls `step` is a plain Python loop in the pipeline.

The other samplers of the JAX package (ddim, lms, euler, euler_a, dpmpp,
dpmpp_k, unipc, unipc_k) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as T

import numpy as np
import torch

SCHEDULER_NAMES = ("pndm",)


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Training-time noise schedule (SD v1 defaults)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    set_alpha_to_one: bool = False  # DDIM/PNDM final-alpha convention

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
    `timesteps[i]` is what the UNet sees at loop index i."""

    name: str
    num_inference_steps: int
    timesteps: np.ndarray  # (S,) int32
    coeffs: T.Dict[str, np.ndarray]

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


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
    )


@functools.lru_cache(maxsize=64)
def make_plan(
    name: str, num_steps: int, t_start: int = 0, noise: NoiseConfig = NoiseConfig()
) -> SchedulerPlan:
    """Build (cached) the plan for `num_steps` inference steps, starting at
    position `t_start` of the global sequence (img2img)."""
    if name != "pndm":
        raise ValueError(f"Scheduler {name!r} is not ported yet; choose from {SCHEDULER_NAMES}")
    return _make_pndm_plan(noise, num_steps, t_start)


def init_state(plan: SchedulerPlan, shape, dtype=torch.float32, device="cpu") -> T.Dict[str, T.Any]:
    """The PNDM state: the eps ring (newest at index 0) and the sample
    stored at step 0 for reuse at step 1. The plan's weights say how many
    ring entries a step reads."""
    return {
        "ets": torch.zeros((4,) + tuple(shape), dtype=dtype, device=device),
        "cur_sample": torch.zeros(tuple(shape), dtype=dtype, device=device),
    }


def step(plan: SchedulerPlan, state, i: int, model_output: torch.Tensor, sample: torch.Tensor):
    """One PLMS update at loop index i. Returns (prev_sample, new_state)."""
    c = plan.coeffs
    ets = state["ets"]
    cur_sample = sample if i == 0 else state["cur_sample"]
    sample_eff = cur_sample if c["use_cur_sample"][i] > 0 else sample
    if c["push"][i] > 0:
        ets = torch.cat([model_output[None], ets[:-1]], dim=0)
    if c["avg_with_last"][i] > 0:
        e_eff = 0.5 * (model_output + ets[0])
    else:
        w = torch.as_tensor(c["weights"][i], dtype=ets.dtype, device=ets.device)
        e_eff = torch.tensordot(w, ets, dims=1)
    prev = float(c["sample_coeff"][i]) * sample_eff - float(c["output_coeff"][i]) * e_eff
    return prev, {"ets": ets, "cur_sample": cur_sample}


def scale_model_input(plan: SchedulerPlan, sample: torch.Tensor, i: int) -> torch.Tensor:
    """Pre-UNet latent scaling: identity for PNDM."""
    return sample


def add_noise(
    noise_cfg: NoiseConfig, sample: torch.Tensor, noise: torch.Tensor, timestep: int
) -> torch.Tensor:
    """Forward-process noising at an integer train timestep (DDPM)."""
    a = noise_cfg.alphas_cumprod.astype(np.float32)[int(timestep)]
    # both coefficients in fp32, as the JAX function computes them
    sqrt_a = float(np.sqrt(a))
    sqrt_1ma = float(np.sqrt(np.float32(1.0) - a))
    return sqrt_a * sample + sqrt_1ma * noise


def add_noise_at_index(
    plan: SchedulerPlan, noise_cfg: NoiseConfig, sample: torch.Tensor, noise: torch.Tensor, i: int
) -> torch.Tensor:
    """Noise `sample` for use at plan index `i` (mask re-noising): PNDM keeps
    the DDPM convention."""
    return add_noise(noise_cfg, sample, noise, int(plan.timesteps[i]))
