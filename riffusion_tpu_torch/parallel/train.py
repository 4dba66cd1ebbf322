"""
Diffusion fine-tuning of the UNet on one device: the counterpart of
riffusion_tpu/parallel/train.py's `DiffusionTrainer` (its dp/tp/sp mesh is
not ported: multi-device training is later work).

The objective is the JAX package's: sample t uniform in [0, 1000) and
noise N(0, 1) per batch element, noise the clean latents (DDPM add_noise),
and take the mean squared error of the UNet's noise prediction in fp32.
The optimizer is AdamW with optax.adamw's defaults (b1 0.9, b2 0.999, eps
1e-8, the decay on every parameter), the learning rate read from a schedule
at the update's step count (optax's convention: step 0 takes schedule(0)).

Precision. The masters are fp32. At a bf16 compute dtype the trainer holds
a working copy of the UNet whose Linear and Conv2d layers are bf16 and
whose norms and conv_out stay fp32: what flax's cast at each Dense/Conv
call gives the JAX trainer (its GroupNorm/LayerNorm scales and conv_out
compute in fp32). Each step copies the masters into the working copy, runs
forward and backward there, and hands its gradients to the masters in fp32,
so a bf16 layer's gradient is the bf16 gradient widened, as the transpose of
flax's cast gives it. At SD v1 width (859.5M parameters) the copy costs
1.7 GB of bf16 weights and, during the backward, 1.7 GB of bf16 gradients,
beside 3.4 GB of fp32 masters, 3.4 GB of fp32 gradients and 6.9 GB of Adam
moments. At fp32 compute the masters are the working module.

Checkpoints are one torch.save file per step (`state_{step}/state.pt`,
written to a temporary name and renamed): the masters, the optimizer state,
the step, and the EMA when the fine-tune driver keeps one.

Each part of a step runs inside a `torch.profiler.record_function` span
(riffusion.train.copy, .forward, .backward, .grads, .optimizer), which a
profiler attributes device time to (`python -m riffusion_tpu_torch.profile_train`);
with no profiler running a span costs a few microseconds.
"""

from __future__ import annotations

import copy
import os
import typing as T
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.models.unet import UNet2DCondition
from riffusion_tpu_torch.util import torch_util

Schedule = T.Callable[[int], float]


def compute_copy(master: UNet2DCondition, dtype: torch.dtype) -> UNet2DCondition:
    """A working copy of `master` whose Linear and Conv2d layers hold
    `dtype`; the norms and conv_out keep fp32 (the dtypes flax computes
    them in at a bf16 compute dtype)."""
    work = copy.deepcopy(master)
    for name, module in work.named_modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)) and name != "conv_out":
            module.to(dtype)
    return work


class DiffusionTrainer:
    """Noise-prediction fine-tuning of the UNet on spectrogram latents."""

    def __init__(
        self,
        device: T.Union[str, torch.device] = "cuda",
        learning_rate: T.Union[float, Schedule] = 1e-5,
        weight_decay: float = 1e-2,
        noise_config: sched.NoiseConfig = sched.NoiseConfig(),
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.device = torch_util.check_device(str(device))
        if self.device.type == "cuda":
            torch_util.configure_numerics()
        self.schedule: Schedule = (
            learning_rate if callable(learning_rate) else (lambda step: float(learning_rate))
        )
        self.weight_decay = weight_decay
        self.noise_config = noise_config
        self.dtype = dtype
        self.master: T.Optional[UNet2DCondition] = None
        self.unet: T.Optional[UNet2DCondition] = None
        self.optimizer: T.Optional[torch.optim.AdamW] = None
        self.step_count = 0

    def init_from(self, unet: UNet2DCondition) -> None:
        """Adopt a UNet's weights as fp32 masters on this trainer's device
        (a copy: `unet` is left as it is), with fresh optimizer state."""
        self.master = copy.deepcopy(unet).to(self.device, torch.float32).train()
        self.unet = (self.master if self.dtype == torch.float32
                     else compute_copy(self.master, self.dtype))
        self.optimizer = torch.optim.AdamW(
            self.master.parameters(), lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )
        self.step_count = 0

    def loss_and_grads(
        self,
        latents: T.Any,
        context: T.Any,
        *,
        t: T.Optional[T.Any] = None,
        noise: T.Optional[T.Any] = None,
        generator: T.Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The loss on clean latents (B, H, W, C) (the JAX layout) and text
        embeddings (B, L, D), with its gradient left in the masters' `.grad`
        in fp32; returns the loss (a 0-d fp32 tensor on the device, not
        synchronized). `t` (B,) integer timesteps and `noise` (B, H, W, C)
        are drawn from `generator` when not given."""
        if self.master is None:
            raise RuntimeError("DiffusionTrainer used before init_from")
        dev = self.device

        def on_device(x, dtype):
            x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
            return x.to(dev, dtype)

        latents = on_device(latents, torch.float32)
        context = on_device(context, torch.float32)
        b = latents.shape[0]
        if t is None:
            t = torch.randint(0, self.noise_config.num_train_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev)
        t = on_device(t, torch.int64)
        noise = on_device(noise, torch.float32)
        noisy = sched.add_noise(self.noise_config, latents, noise, t)

        if self.unet is not self.master:
            with record_function("riffusion.train.copy"), torch.no_grad():
                for work, master in zip(self.unet.parameters(), self.master.parameters()):
                    work.copy_(master)
        with record_function("riffusion.train.forward"):
            eps = self.unet(noisy.permute(0, 3, 1, 2), t, context)
            loss = torch.mean(torch.square(eps.float() - noise.permute(0, 3, 1, 2)))
        self.optimizer.zero_grad(set_to_none=True)
        with record_function("riffusion.train.backward"):
            loss.backward()
        if self.unet is not self.master:
            with record_function("riffusion.train.grads"):
                for work, master in zip(self.unet.parameters(), self.master.parameters()):
                    master.grad = work.grad.to(torch.float32)
                    work.grad = None
        return loss.detach()

    def step(
        self,
        latents: T.Any,
        context: T.Any,
        *,
        t: T.Optional[T.Any] = None,
        noise: T.Optional[T.Any] = None,
        generator: T.Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One update: `loss_and_grads`, then AdamW at the schedule's rate
        for this step; returns the loss."""
        loss = self.loss_and_grads(latents, context, t=t, noise=noise, generator=generator)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step_count)
        with record_function("riffusion.train.optimizer"):
            self.optimizer.step()
        self.step_count += 1
        return loss

    # ----------------------------------------------------------- checkpoints

    def save_checkpoint(
        self, path: T.Union[str, Path], step: int,
        ema: T.Optional[T.Dict[str, torch.Tensor]] = None,
    ) -> Path:
        """Write `path/state_{step}/state.pt`: the fp32 masters, the
        optimizer state, the step and `ema` (when given)."""
        out = Path(path) / f"state_{step}"
        out.mkdir(parents=True, exist_ok=True)
        state = {"params": self.master.state_dict(), "opt_state": self.optimizer.state_dict(),
                 "step": step}
        if ema is not None:
            state["ema"] = ema
        tmp = out / f"state.pt.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, out / "state.pt")
        return out / "state.pt"

    def restore_checkpoint(
        self, path: T.Union[str, Path], step: int
    ) -> T.Tuple[int, T.Optional[T.Dict[str, torch.Tensor]]]:
        """Load what save_checkpoint wrote into this trainer (after
        init_from); returns (step, ema or None)."""
        state = torch.load(Path(path) / f"state_{step}" / "state.pt", map_location=self.device,
                           weights_only=True)
        self.master.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step_count = int(state["step"])
        return self.step_count, state.get("ema")
