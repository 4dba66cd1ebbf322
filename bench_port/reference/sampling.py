"""
Plain reference of the samplers a served request runs, written from the
diffusers schedulers' published steps: PNDM (PLMS, skip_prk_steps, the
SD v1 scheduler config) with riffusion's img2img start, the DDPM forward
noising, and the seed-noise slerp of the riffusion pipeline.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch

NUM_TRAIN_TIMESTEPS = 1000
BETA_START, BETA_END = 0.00085, 0.012
STEPS_OFFSET = 1


def alphas_cumprod() -> np.ndarray:
    """SD v1's scaled-linear schedule, float64."""
    betas = np.linspace(BETA_START ** 0.5, BETA_END ** 0.5, NUM_TRAIN_TIMESTEPS) ** 2
    return np.cumprod(1.0 - betas)


def img2img_start(num_steps: int, strength: float) -> T.Tuple[int, int]:
    """riffusion's img2img: (t_start, init_timestep)."""
    init_timestep = min(int(num_steps * strength) + STEPS_OFFSET, num_steps)
    return max(num_steps - init_timestep + STEPS_OFFSET, 0), init_timestep


class PNDM:
    """diffusers' PNDMScheduler with skip_prk_steps=True, steps_offset 1 and
    set_alpha_to_one False: `timesteps`, and `step` with its counter, eps
    list and stored sample."""

    def __init__(self, num_steps: int):
        self.num_steps = num_steps
        self.ratio = NUM_TRAIN_TIMESTEPS // num_steps
        ts = np.arange(0, num_steps) * self.ratio + STEPS_OFFSET
        self.timesteps = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1].copy()
        self.acp = alphas_cumprod()
        self.final = float(self.acp[0])
        self.ets: T.List[torch.Tensor] = []
        self.counter = 0
        self.cur_sample: T.Optional[torch.Tensor] = None

    def step(self, eps: torch.Tensor, timestep: int, sample: torch.Tensor) -> torch.Tensor:
        prev_t = timestep - self.ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [eps]
        else:
            prev_t, timestep = timestep, timestep + self.ratio
        ets = self.ets
        if len(ets) == 1 and self.counter == 0:
            e, self.cur_sample = eps, sample
        elif len(ets) == 1 and self.counter == 1:
            e, sample, self.cur_sample = (eps + ets[-1]) / 2, self.cur_sample, None
        elif len(ets) == 2:
            e = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            e = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            e = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3] - 9 * ets[-4]) / 24
        a_t = self.acp[timestep]
        a_prev = self.acp[prev_t] if prev_t >= 0 else self.final
        sample_coeff = (a_prev / a_t) ** 0.5
        denom = a_t * (1 - a_prev) ** 0.5 + (a_t * (1 - a_t) * a_prev) ** 0.5
        self.counter += 1
        return sample_coeff * sample - (a_prev - a_t) * e / denom


def add_noise(sample: torch.Tensor, noise: torch.Tensor, timestep: int) -> torch.Tensor:
    a = alphas_cumprod()[timestep]
    return a ** 0.5 * sample + (1 - a) ** 0.5 * noise


def slerp(t: float, v0: torch.Tensor, v1: torch.Tensor, threshold: float = 0.9995):
    """riffusion's slerp, in float64, with a lerp where the two are nearly
    parallel."""
    a, b = v0.double(), v1.double()
    dot = float((a * b).sum() / (a.norm() * b.norm()))
    if abs(dot) > threshold:
        out = (1 - t) * a + t * b
    else:
        theta_0 = np.arccos(dot)
        theta_t = theta_0 * t
        out = (np.sin(theta_0 - theta_t) * a + np.sin(theta_t) * b) / np.sin(theta_0)
    return out.to(v0.dtype)
