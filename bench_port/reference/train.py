"""
Plain reference of the fine-tuning loop's first steps: riffusion's latent
dataset stream (epoch permutations, posterior samples), the noise
prediction objective (t uniform over the training steps, DDPM noising, the
float32 mean squared error of the UNet's eps), AdamW with decoupled weight
decay (torch.optim.AdamW's update, written out), the warm-up and cosine
learning-rate schedule, and the EMA update of the parameters.

A step's random draws follow the fine-tuning driver's documented rule: one
torch Generator on the device, reseeded before each step from
SeedSequence([seed, step]), draws t (randint over [0, 1000), one per batch
row) and then the noise (randn of the latents' (B, H, W, C) shape).
"""

from __future__ import annotations

import math
import typing as T

import numpy as np
import torch

from bench_port.reference import sampling, sd


class Fp8Round(torch.autograd.Function):
    """Rounds a tensor to float8 e4m3 at a per-tensor scale on the way
    forward, and its gradient the same way on the way back."""

    @staticmethod
    def forward(ctx, x):
        return sd.Fp8Numerics().operand(x)

    @staticmethod
    def backward(ctx, grad):
        return sd.Fp8Numerics().operand(grad)


class Fp8TrainNumerics(sd.Numerics):
    """Products with float8 operands forward and backward: the step below
    bfloat16 compute, for training."""

    name = "fp8"

    def operand(self, x):
        return Fp8Round.apply(x)

    def linear(self, x, w, b=None):
        return self.operand(super().linear(x, w, b))

    def conv(self, x, w, b=None, stride=1, padding=1):
        return self.operand(super().conv(x, w, b, stride=stride, padding=padding))

    def matmul(self, a, b):
        return self.operand(super().matmul(a, b))


def batches(mean: np.ndarray, logvar: np.ndarray, ctx: np.ndarray, contexts: np.ndarray,
            scale: float, batch_size: int, seed: int) -> T.Iterator[T.Tuple[np.ndarray,
                                                                            np.ndarray]]:
    """The dataset's stream: per epoch a permutation from
    numpy.random.default_rng(seed), whole batches only, each latent sampled
    from its posterior (mean + exp(logvar / 2) * a standard normal draw
    from the same generator) and scaled; float32."""
    rng = np.random.default_rng(seed)
    mean, logvar = mean.astype(np.float32), logvar.astype(np.float32)
    contexts = contexts.astype(np.float32)
    while True:
        order = rng.permutation(len(mean))
        for lo in range(0, len(mean) - batch_size + 1, batch_size):
            idx = order[lo:lo + batch_size]
            z = mean[idx] + np.exp(0.5 * logvar[idx]) * rng.standard_normal(
                mean[idx].shape).astype(np.float32)
            yield z * scale, contexts[ctx[idx]]


def step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


def learning_rate(step: int, peak: float, warmup: int, steps: int) -> float:
    """Linear warm-up from 0 over min(warmup, steps) steps, then a cosine
    decay to a tenth of the peak."""
    warm = min(warmup, steps)
    if step < warm:
        return peak * step / warm
    decay = max(steps - warmup, 1)
    count = min(step - warm, decay)
    return peak * (0.9 * 0.5 * (1 + math.cos(math.pi * count / decay)) + 0.1)


def ema_update(ema: torch.Tensor, param: torch.Tensor, decay: float,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ema * decay + param * (1 - decay), computed in `dtype`, as float32."""
    e, p = ema.to(dtype), param.to(dtype)
    return (e * decay + p * (1 - decay)).float()


class Trainer:
    """The reference's own training state: float32 parameters by diffusers
    name and AdamW's moments; each step's gradient norms by leaf."""

    def __init__(self, params: T.Mapping[str, torch.Tensor], cfg: T.Mapping[str, T.Any],
                 nx: sd.Numerics = sd.FP32, keep_rows: T.Optional[int] = None):
        """`nx` computes the products; `keep_rows` takes the loss over that
        many rows of each batch only (a planted fault: the draws are still
        the whole batch's)."""
        self.cfg, self.nx, self.keep = cfg, nx, keep_rows
        self.params = {k: v.detach().float().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.grad_norms: T.List[T.Dict[str, float]] = []

    def loss(self, latents: np.ndarray, contexts: np.ndarray, generator: torch.Generator):
        device = next(iter(self.params.values())).device
        lat = torch.from_numpy(latents).to(device)
        b = lat.shape[0]
        t = torch.randint(0, sampling.NUM_TRAIN_TIMESTEPS, (b,), generator=generator,
                          device=device)
        noise = torch.randn(lat.shape, generator=generator, device=device)
        acp = torch.from_numpy(sampling.alphas_cumprod()).to(device)[t].view(-1, 1, 1, 1)
        noisy = (acp.sqrt() * lat + (1 - acp).sqrt() * noise).float()
        rows = slice(0, self.keep)
        eps = sd.unet(self.params, self.cfg["unet"], noisy[rows].permute(0, 3, 1, 2), t[rows],
                      torch.from_numpy(contexts[rows]).to(device), self.nx)
        return torch.mean(torch.square(eps.float() - noise[rows].permute(0, 3, 1, 2)))

    def step(self, latents, contexts, generator) -> float:
        ft = self.cfg["finetune"]
        loss = self.loss(latents, contexts, generator)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        lr = learning_rate(self.count, ft["learning_rate"], ft["warmup_steps"], ft["steps"])
        b1, b2 = ft["betas"]
        self.count += 1
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads]).tolist()
            self.grad_norms.append(dict(zip(self.params, norms)))
            for (k, p), g in zip(self.params.items(), grads):
                p.mul_(1 - lr * ft["weight_decay"])
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.count)
                v_hat = self.v[k] / (1 - b2 ** self.count)
                p.sub_(lr * m_hat / (v_hat.sqrt() + ft["eps"]))
        return float(loss.detach())
