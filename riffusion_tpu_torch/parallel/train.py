"""
Diffusion fine-tuning of the UNet on one device: the counterpart of
riffusion_tpu/parallel/train.py's `DiffusionTrainer` (its dp/tp/sp mesh is
not ported: the sharded step is later work), and the tensor-parallel
layout of the UNet's linear layers that the JAX trainer and its
tensor-parallel server share (`param_spec`, `shard_params`).

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
import dataclasses
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

# The JAX package's Megatron-style rule (riffusion_tpu/parallel/train.py):
# column-split layers (the output dim over "model") feed head-wise or
# elementwise work, so nothing is exchanged until the paired row-split
# layer (the input dim over "model"), whose partial sums are all-reduced.
# fc1 / fc2 / out_proj are CLIP's names.
_COLUMN_SPLIT = ("to_q", "to_k", "to_v", "fc1", "linear_1")
_ROW_SPLIT = ("to_out", "fc2", "linear_2", "out_proj", "proj_out")


@dataclasses.dataclass(frozen=True)
class Split:
    """How a tensor is cut over the "model" axis: along `dim` of its torch
    layout, each of its `halves` equal parts cut alike (GEGLU's proj_in
    holds [value | gate] and is cut half by half, so a rank's gate is the
    gate of its value)."""

    dim: int
    halves: int = 1


def param_spec(name: str, tensor: torch.Tensor) -> T.Optional[Split]:
    """The tensor-parallel cut of one UNet (or CLIP) parameter, by its
    state dict name, or None where it is replicated: the JAX package's
    `param_spec` in torch's layout (a flax Dense kernel is (in, out), a
    torch Linear weight (out, in)). Column-split weights (to_q, to_k, to_v,
    linear_1, and the feed-forward's proj_in) cut dim 0, row-split ones
    (to_out, linear_2, the feed-forward's proj_out) dim 1; column-split
    biases dim 0. Convolutions (Transformer2D's 1x1 proj_in / proj_out
    among them: 4-D), norms and embeddings stay whole. One difference in
    storage: JAX keeps GEGLU proj_in's bias whole and GSPMD slices it where
    it is added; here it is cut with its weight."""
    parts = name.split(".")
    module, leaf = (parts[-2] if len(parts) >= 2 else ""), parts[-1]
    if leaf == "weight" and tensor.dim() == 2:
        if module in _COLUMN_SPLIT or module.startswith("proj_in"):  # 2-D: the feed-forward's
            return Split(0, 2 if module.startswith("proj_in") else 1)
        if module in _ROW_SPLIT:
            return Split(1)
    if leaf == "bias" and tensor.dim() == 1:
        if module in _COLUMN_SPLIT:
            return Split(0)
        if module == "proj_in" and len(parts) >= 3 and parts[-3] == "ff":
            return Split(0, 2)
    return None


def shard_tensor(tensor: torch.Tensor, split: Split, rank: int, size: int) -> torch.Tensor:
    """Rank `rank`'s slice of `tensor` cut `split` over `size` ranks."""
    if tensor.shape[split.dim] % (split.halves * size):
        raise ValueError(f"dim {split.dim} of {tuple(tensor.shape)} does not split into "
                         f"{split.halves} x {size}")
    parts = tensor.chunk(split.halves, dim=split.dim)
    return torch.cat([p.chunk(size, dim=split.dim)[rank] for p in parts], dim=split.dim)


def shard_params(module: nn.Module, mesh, axis: str = "model") -> T.Dict[str, torch.Tensor]:
    """This rank's slice of each of `module`'s split parameters (by state
    dict name), cut over the mesh axis `axis` by `param_spec`; the
    replicated parameters are not in the result."""
    from riffusion_tpu_torch.parallel.mesh import axis_size

    size, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
    out = {}
    for name, tensor in module.state_dict().items():
        split = param_spec(name, tensor)
        if split is not None:
            out[name] = shard_tensor(tensor, split, rank, size)
    return out


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
