"""
Diffusion fine-tuning of the UNet: the counterpart of
riffusion_tpu/parallel/train.py's `DiffusionTrainer`, on one device or
sharded over a ("data", "model", "seq") mesh, with `dryrun_train_step`,
and the tensor-parallel layout of the UNet's linear layers that the JAX
trainer and its tensor-parallel server share (`param_spec`,
`shard_params`).

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
forward and backward there, and updates the masters from its gradients
widened to fp32, so a bf16 layer's gradient is the bf16 gradient widened,
as the transpose of flax's cast gives it. On one card the optimizer
(ops.adamw.OnePassAdamW) reads the working copy's gradients itself and
widens them in registers, so no fp32 gradient is materialised; on the CPU
and over a mesh (which all-reduces fp32 gradients) the step hands them to
the masters' `.grad` in fp32 first (the `riffusion.train.grads` stage), as
the public `loss_and_grads` always does. At SD v1 width (859.5M parameters)
the copy costs 1.7 GB of bf16 weights and, during the backward, 1.7 GB of
bf16 gradients, beside 3.4 GB of fp32 masters and 6.9 GB of Adam moments,
and where the hand-off runs 3.4 GB of fp32 gradients. At fp32 compute the
masters are the working module; at fp64 (the wiring tests) the masters are
fp64 and the working module.

Checkpoints are one torch.save file per step (`state_{step}/state.pt`,
written to a temporary name and renamed): the masters, the optimizer state,
the step, and the EMA when the fine-tune driver keeps one.

The mesh (`mesh=`, a parallel.mesh.make_mesh DeviceMesh; an axis it lacks
has size 1) is SPMD: every rank calls `step` with the same global batch
and draws, as JAX's single controller is called once.
- dp: each rank takes its contiguous share of the batch over "data"
  (mesh.data_share).
- tp: the masters are the rank's cut over "model"
  (tp_serving.tensor_parallel_unet, trainable), with the differentiable
  copies and sums of parallel/comm.py around the cut layers.
- sp: the rank's block of latent rows over "seq" (parallel/seq.py), the
  height of the noisy latents and of the noise prediction, as JAX's
  P("data", "seq", None, None) constraint.
The loss is the mean over the global batch's elements: each rank sums its
squared errors over the global count, and every gradient is summed over
"seq" and "data" (an all-reduce per parameter), so replicated parameters
stay bit-equal on every rank. t and noise are drawn for the whole batch,
alike on every rank, and sliced. The attention sites route at the global
batch (ops.attention.route_batch). AdamW and the schedule run on each
rank's parameters. Checkpoints hold the unsharded state: the split tensors
and their Adam moments are gathered over "model", global rank 0 writes
them in the single-device layout and every rank waits for it, and a
restore cuts the state for the trainer's own mesh, so a checkpoint resumes
on another mesh or on one device (JAX's restore onto the template).

A step is split as the serving programs are (riffusion_pipeline.py, aot.py):
- the host part (`_host_inputs`, and in `step` the schedule): the batch
  moved to the device, t and then the noise drawn from the caller's
  generator when not given, and the learning rate for this step's count as
  a 0-d tensor;
- the device program (`_train_step`, JAX's jitted `_train_step`), a
  function of those tensors that updates the trainer's state in place, as
  JAX's step donates its params and optimizer state: the masters copied
  into the working copy, add_noise, the forward and the fp32 MSE, the
  backward, the gradients handed to the masters (not on one card), AdamW;
  it returns the loss as a 0-d device tensor and reads nothing back to the
  host.
On the card, without a mesh and with the store on (aot.captures), the
device program runs through the trainer's own GraphStore (`graph_store`,
made at init_from, with its own pool) under the key "train_step": the
first call of an input signature is a real step run eagerly (the warm-up,
which also creates AdamW's state), then captured; every later call
replays. `program(key, fn)` gives other programs over the trainer's state
the same treatment (training/finetune.py's "ema_update"). On the CPU,
under RIFFUSION_TPU_NO_AOT=1 and over a mesh (any), the same programs run
eagerly. A capture that fails raises aot.CaptureError; nothing falls back.
On one card the optimizer is ops.adamw.OnePassAdamW(capturable=True), a
torch AdamW whose step is one hand-written pass over the parameters (the
gradient's widening and the update), its step counts on the device and its
lr the program's tensor, eager or replayed alike; on the CPU (capturable is
CUDA-only) and over a mesh, which never captures, it is torch's AdamW with
a Python float lr and its step counts on the host. The kernels a trainer
launches on the card (ops.kernels.TRAIN_KERNELS) are built in one round
at init_from.

A graph replays addresses, so `restore_checkpoint`, whose optimizer load
replaces the moments and step counts with new tensors, drops the trainer's
graphs: the next call captures again.

Spans (tracing.py, each a `torch.profiler.record_function` range). `step`
runs inside `riffusion.train.step` (a new id per step), with children
`riffusion.train.upload` (the host part: its copies to the device wait for
the card's earlier work) and `riffusion.launch` (the device program
queued). The device program's stages are `riffusion.train.copy`,
`.forward`, `.backward`, `.grads` (not on one card), `.allreduce` over a
mesh and `.optimizer`: a profiler attributes an eager step's device time to them
(`python -m riffusion_tpu_torch.profile train`), and a graph captured with
RIFFUSION_TPU_TRACE=1 times each of them on the card at every replay
(aot.py). With the switch off and no profiler running a span costs a few
microseconds.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
import os
import typing as T
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from riffusion_tpu_torch import aot, tracing
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.models.layers import precise
from riffusion_tpu_torch.models.unet import UNet2DCondition
from riffusion_tpu_torch.ops import adamw as adamw_ops
from riffusion_tpu_torch.ops import attention as attention_ops
from riffusion_tpu_torch.ops import kernels
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


def unshard_tensor(slices: T.Sequence[torch.Tensor], split: Split) -> torch.Tensor:
    """The whole tensor from every rank's slice (in rank order): the
    inverse of shard_tensor."""
    parts = [s.chunk(split.halves, dim=split.dim) for s in slices]
    return torch.cat([torch.cat([p[h] for p in parts], dim=split.dim)
                      for h in range(split.halves)], dim=split.dim)


def _size_and_rank(mesh, axis: str) -> T.Tuple[int, int]:
    """(size, this rank's index) of the mesh axis, (1, 0) without it."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1, 0
    from riffusion_tpu_torch.parallel.mesh import axis_size

    return axis_size(mesh, axis), mesh.get_local_rank(axis)


def shard_state(tensors: T.Mapping[str, torch.Tensor], mesh,
                axis: str = "model") -> T.Dict[str, torch.Tensor]:
    """This rank's cut of a whole state (by state dict name): each tensor
    param_spec splits, sliced over the mesh axis `axis`; the rest as given."""
    size, rank = _size_and_rank(mesh, axis)
    out = {}
    for name, tensor in tensors.items():
        split = param_spec(name, tensor) if size > 1 else None
        out[name] = tensor if split is None else shard_tensor(tensor, split, rank, size)
    return out


def unshard_state(tensors: T.Mapping[str, torch.Tensor], mesh,
                  axis: str = "model") -> T.Dict[str, torch.Tensor]:
    """The whole state on the CPU from each rank's cut (`shard_state`'s
    inverse), on every rank of the axis: a collective over it, one
    all-reduce per split tensor."""
    from riffusion_tpu_torch.parallel.mesh import gather_rows

    size, _ = _size_and_rank(mesh, axis)
    out = {}
    for name, tensor in tensors.items():
        split = param_spec(name, tensor) if size > 1 else None
        if split is not None:
            tensor = unshard_tensor(gather_rows(tensor.detach()[None], mesh, axis), split)
        out[name] = tensor.detach().cpu()
    return out


def shard_params(module: nn.Module, mesh, axis: str = "model") -> T.Dict[str, torch.Tensor]:
    """This rank's slice of each of `module`'s split parameters (by state
    dict name), cut over the mesh axis `axis` by `param_spec`; the
    replicated parameters are not in the result."""
    state = module.state_dict()
    return {name: tensor for name, tensor in shard_state(state, mesh, axis).items()
            if param_spec(name, state[name]) is not None}


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
    """Noise-prediction fine-tuning of the UNet on spectrogram latents, on
    one device or over `mesh` (module docstring)."""

    def __init__(
        self,
        device: T.Union[str, torch.device] = "cuda",
        learning_rate: T.Union[float, Schedule] = 1e-5,
        weight_decay: float = 1e-2,
        noise_config: sched.NoiseConfig = sched.NoiseConfig(),
        dtype: torch.dtype = torch.bfloat16,
        mesh=None,
    ):
        self.device = torch_util.check_device(str(device))
        if self.device.type == "cuda":
            torch_util.configure_numerics()
        self.schedule: Schedule = (
            learning_rate if callable(learning_rate) else (lambda step: float(learning_rate))
        )
        self.weight_decay = weight_decay
        self.noise_config = noise_config
        # on the device once: the step's program indexes it (no upload in a graph)
        self._alphas_cumprod = sched.alphas_cumprod_table(noise_config, self.device)
        self.dtype = dtype
        self.mesh = mesh
        self.master: T.Optional[UNet2DCondition] = None
        self.unet: T.Optional[UNet2DCondition] = None
        self.optimizer: T.Optional[torch.optim.AdamW] = None
        self.graph_store: T.Optional[aot.GraphStore] = None
        self.step_count = 0

    def _axis(self, name: str):
        """The mesh axis `name` as a comm.MeshAxis, or None where the
        trainer has no mesh, or the mesh no such axis or one of size 1."""
        size, _ = _size_and_rank(self.mesh, name)
        if size == 1:
            return None
        from riffusion_tpu_torch.parallel.comm import MeshAxis

        return MeshAxis.of(self.mesh, name)

    def init_from(self, unet: UNet2DCondition) -> None:
        """Adopt a UNet's weights as masters (fp32; fp64 at an fp64 compute
        dtype; NCHW, also from a serving pipeline's channels_last UNet) on
        this trainer's device (a copy: `unet` is left as it is), cut for
        this rank where there is a mesh, with fresh optimizer state."""
        master = copy.deepcopy(unet).to(self.device, precise(self.dtype),
                                        memory_format=torch.contiguous_format).train()
        if self._axis("model") is not None:
            from riffusion_tpu_torch.parallel.tp_serving import tensor_parallel_unet

            master = tensor_parallel_unet(master, self.mesh, trainable=True)
        if self._axis("seq") is not None:
            from riffusion_tpu_torch.parallel.seq import seq_parallel_unet

            master = seq_parallel_unet(master, self.mesh)
        self.master = master
        self.unet = (self.master if self.dtype == precise(self.dtype)
                     else compute_copy(self.master, self.dtype))
        hyper = dict(lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=self.weight_decay, capturable=self._capturable)
        self.optimizer = (
            adamw_ops.OnePassAdamW(self.master.parameters(), working=self.unet.parameters(),
                                   **hyper)
            if self._capturable else torch.optim.AdamW(self.master.parameters(), **hyper))
        self.graph_store = aot.GraphStore()
        self.step_count = 0
        if self.device.type == "cuda":
            kernels.build_kernels(kernels.TRAIN_KERNELS)

    @property
    def _capturable(self) -> bool:
        """Whether the optimizer runs in a graph, and is the one pass that
        reads the working copy's gradients: on one card (a mesh stays eager,
        on the optimizer it had before graphs)."""
        return self.device.type == "cuda" and self.mesh is None

    def program(self, key: str, fn: T.Callable) -> T.Callable:
        """`fn` (a device program over the trainer's state) as the program
        of `key`: captured and replayed through the trainer's GraphStore on
        the card without a mesh while the store is on, `fn` run eagerly
        (`aot.eager`) otherwise; either way each call opens a
        `riffusion.launch` span. The store keeps the `fn` of a key's first
        call until `restore_checkpoint` drops it."""
        if self.mesh is None and aot.captures(self.device):
            return self.graph_store.program(key, fn)
        return aot.eager(fn)

    def _share(self, latents: torch.Tensor, *batched: torch.Tensor) -> T.List[torch.Tensor]:
        """This rank's share of the global batch tensors: its rows of the
        batch over "data", and of `latents` and the first of `batched` (the
        noise), its block of latent rows over "seq"."""
        from riffusion_tpu_torch.parallel.mesh import data_share

        lo, hi = data_share(self.mesh, latents.shape[0]) if self._axis("data") else (0, None)
        out = [x[lo:hi] for x in (latents,) + batched]
        seq = self._axis("seq")
        if seq is not None:
            h = latents.shape[1]
            if h % seq.size:
                raise ValueError(f"latent height {h} not divisible by seq axis {seq.size}")
            for i in (0, 1):
                out[i] = out[i].narrow(1, seq.rank * (h // seq.size), h // seq.size)
        return out

    def _sum_over_shares(self, tensors: T.Iterable[torch.Tensor]) -> None:
        """Sum each tensor in place over "seq" and then "data"."""
        groups = [a.group for a in (self._axis("seq"), self._axis("data")) if a is not None]
        for x in tensors:
            for group in groups:
                dist.all_reduce(x, group=group)
                tracing.count("allreduce_calls")

    def _host_inputs(
        self, latents: T.Any, context: T.Any, t: T.Optional[T.Any], noise: T.Optional[T.Any],
        generator: T.Optional[torch.Generator],
    ) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The step's host part: latents, context, t and noise on the device
        in their dtypes, t and then the noise drawn from `generator` where
        not given."""
        if self.master is None:
            raise RuntimeError("DiffusionTrainer used before init_from")
        dev, p = self.device, precise(self.dtype)

        def on_device(x, dtype):
            x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
            return x.to(dev, dtype)

        latents = on_device(latents, p)
        context = on_device(context, p)
        b = latents.shape[0]
        if t is None:
            t = torch.randint(0, self.noise_config.num_train_timesteps, (b,),
                              generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, device=dev)
        return latents, context, on_device(t, torch.int64), on_device(noise, p)

    def _loss_and_grads(self, latents: torch.Tensor, context: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor, hand_off: T.Optional[bool] = None) -> torch.Tensor:
        """The loss and the gradients from the host part's tensors (the device
        part of `loss_and_grads`): in the masters' `.grad` where `hand_off`,
        else left in the working copy for the optimizer to read. By default
        the hand-off runs where the optimizer is torch's AdamW, which reads
        `.grad`: everywhere but on one card."""
        p = precise(self.dtype)
        b = latents.shape[0]
        count = latents.numel()
        routing = contextlib.nullcontext()
        if self.mesh is not None:
            latents, noise, t, context = self._share(latents, noise, t, context)
            routing = attention_ops.route_batch(b)
        noisy = sched.add_noise(self.noise_config, latents, noise, t, self._alphas_cumprod)

        if self.unet is not self.master:
            with tracing.stage("riffusion.train.copy"), torch.no_grad():
                for work, master in zip(self.unet.parameters(), self.master.parameters()):
                    work.copy_(master)
        with tracing.stage("riffusion.train.forward"), routing:
            eps = self.unet(noisy.permute(0, 3, 1, 2), t, context)
            err = torch.square(eps.to(p) - noise.permute(0, 3, 1, 2))
            loss = torch.mean(err) if self.mesh is None else torch.sum(err) / count
        self.optimizer.zero_grad(set_to_none=True)
        with tracing.stage("riffusion.train.backward"):
            loss.backward()
        if hand_off is None:
            hand_off = not self._capturable
        if hand_off:
            self._hand_off_grads()
        loss = loss.detach()
        if self.mesh is not None:
            with tracing.stage("riffusion.train.allreduce"):
                loss = loss.reshape(1)
                self._sum_over_shares([m.grad for m in self.master.parameters()] + [loss])
                loss = loss[0]
        return loss

    def _hand_off_grads(self) -> None:
        """The working copy's gradients handed to the masters' `.grad` in the
        masters' dtype (a bf16 layer's widened); nothing where the masters
        are the working module."""
        if self.unet is self.master:
            return
        p = precise(self.dtype)
        with tracing.stage("riffusion.train.grads"):
            for work, master in zip(self.unet.parameters(), self.master.parameters()):
                master.grad = work.grad.to(p)
                work.grad = None

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
        in their dtype; returns the loss (a 0-d tensor on the device, not
        synchronized without a mesh). `t` (B,) integer timesteps and `noise`
        (B, H, W, C) are drawn from `generator` when not given. Over a mesh
        every argument is the global batch's and the loss is the global
        mean, on every rank. Always eager (no graph)."""
        return self._loss_and_grads(*self._host_inputs(latents, context, t, noise, generator),
                                    hand_off=True)

    def _train_step(self, latents: torch.Tensor, context: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor, lr: torch.Tensor) -> torch.Tensor:
        """The step's device program: the loss and gradients, then AdamW at
        `lr` (a 0-d tensor: the capturable optimizer reads it on the card,
        the others take its value from the host); returns the loss. On one
        card the optimizer reads the working copy's gradients, which go once
        it has."""
        loss = self._loss_and_grads(latents, context, t, noise)
        for group in self.optimizer.param_groups:
            group["lr"] = lr if self._capturable else float(lr)
        with tracing.stage("riffusion.train.optimizer"):
            self.optimizer.step()
        if self._capturable and self.unet is not self.master:
            for work in self.unet.parameters():
                work.grad = None
        return loss

    def step(
        self,
        latents: T.Any,
        context: T.Any,
        *,
        t: T.Optional[T.Any] = None,
        noise: T.Optional[T.Any] = None,
        generator: T.Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """One update: the host part, then the device program (`_train_step`
        through `program("train_step")`: a captured graph on the card), with
        AdamW at the schedule's rate for this step; returns the loss (a 0-d
        device tensor)."""
        with tracing.span("riffusion.train.step", root=True):
            with tracing.span("riffusion.train.upload"):
                inputs = self._host_inputs(latents, context, t, noise, generator)
                # fp32 on the card is what the capturable optimizer computes in; the
                # others read a float64 on the host back exactly, with no sync
                lr = (torch.full((), self.schedule(self.step_count), dtype=torch.float32,
                                 device=self.device)
                      if self._capturable else
                      torch.full((), self.schedule(self.step_count), dtype=torch.float64))
            program = functools.partial(DiffusionTrainer._train_step, weakref.proxy(self))
            loss = self.program("train_step", program)(*inputs, lr)
        self.step_count += 1  # after the program: a step that raised is retried at its own lr
        return loss

    # ----------------------------------------------------------- checkpoints

    def unsharded(self, tensors: T.Mapping[str, torch.Tensor]) -> T.Dict[str, torch.Tensor]:
        """The whole of a state held as this rank's cut (the masters, their
        moments or an EMA, by parameter name), on the CPU; a collective over
        "model" where the trainer has a mesh, the tensors as given without."""
        return dict(tensors) if self.mesh is None else unshard_state(tensors, self.mesh)

    def save_checkpoint(
        self, path: T.Union[str, Path], step: int,
        ema: T.Optional[T.Dict[str, torch.Tensor]] = None,
    ) -> Path:
        """Write `path/state_{step}/state.pt`: the fp32 masters, the
        optimizer state, the step and `ema` (when given); over a mesh the
        unsharded state, written by global rank 0 while every rank waits."""
        out = Path(path) / f"state_{step}"
        opt = self.optimizer.state_dict()
        for group in opt["param_groups"]:  # a copy; the layout keeps a float lr
            group["lr"] = float(group["lr"])
        if self.mesh is not None:  # the moments, by parameter name, made whole
            names = [n for n, _ in self.master.named_parameters()]
            opt["state"] = {i: {k: (self.unsharded({names[i]: v})[names[i]] if v.dim() else v)
                                for k, v in s.items()} for i, s in opt["state"].items()}
        state = {"params": self.unsharded(self.master.state_dict()), "opt_state": opt,
                 "step": step}
        if ema is not None:
            state["ema"] = self.unsharded(ema)
        if self.mesh is None or dist.get_rank() == 0:
            out.mkdir(parents=True, exist_ok=True)
            tmp = out / f"state.pt.{os.getpid()}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, out / "state.pt")
        if self.mesh is not None:
            dist.barrier()
        return out / "state.pt"

    def restore_checkpoint(
        self, path: T.Union[str, Path], step: int
    ) -> T.Tuple[int, T.Optional[T.Dict[str, torch.Tensor]]]:
        """Load what save_checkpoint wrote, on any mesh or none, into this
        trainer (after init_from), cut for its own mesh; returns (step, ema
        or None), the EMA cut alike on this trainer's device."""
        state = torch.load(Path(path) / f"state_{step}" / "state.pt", map_location="cpu",
                           weights_only=True)
        self.master.load_state_dict(shard_state(state["params"], self.mesh))
        opt = state["opt_state"]
        names = [n for n, _ in self.master.named_parameters()]
        opt["state"] = {i: {k: (shard_state({names[i]: v}, self.mesh)[names[i]] if v.dim() else v)
                            for k, v in s.items()} for i, s in opt["state"].items()}
        for group in opt["param_groups"]:  # this device's optimizer, wherever it was written
            group["capturable"] = self._capturable
        self.optimizer.load_state_dict(opt)
        self.graph_store.clear()  # the graphs read the state tensors the load replaced
        self.step_count = int(state["step"])
        ema = state.get("ema")
        if ema is not None:
            ema = {k: v.to(self.device) for k, v in shard_state(ema, self.mesh).items()}
        return self.step_count, ema


# The JAX package's tiny UNet config trains on 8x8 latents (its sample_size).
TINY_SAMPLE_SIZE = 8


def dryrun_train_step(n_devices: int, mesh_axes: T.Tuple[str, ...] = ("data", "model", "seq"),
                      device: str = "cuda") -> float:
    """One sharded train step of the tiny UNet in fp32, on every rank of an
    initialized world of n_devices (parallel/dryrun.py): the mesh
    factor_mesh_shape(n_devices, 3) over `mesh_axes`, JAX's shapes (8x8
    latents, batch max(2 * data, 2)); returns the loss, finite or raises."""
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.mesh import factor_mesh_shape, make_mesh

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need a world of {n_devices}, have {dist.get_world_size()}")
    shape = factor_mesh_shape(n_devices, len(mesh_axes))
    mesh = make_mesh(shape, mesh_axes, device_type=torch.device(device).type)
    unet = random_bundle("tiny", seed=0, device=device).unet
    trainer = DiffusionTrainer(device=device, dtype=torch.float32, mesh=mesh)
    trainer.init_from(unet)
    data = dict(zip(mesh_axes, shape)).get("data", 1)
    batch, s = max(2 * data, 2), TINY_SAMPLE_SIZE
    gen = torch.Generator(device=device).manual_seed(0)
    latents = torch.randn(batch, s, s, unet.cfg.in_channels, generator=gen, device=device)
    context = torch.randn(batch, 77, unet.cfg.cross_attention_dim, generator=gen, device=device)
    loss = float(trainer.step(latents, context, generator=gen))
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite training loss: {loss}")
    return loss
