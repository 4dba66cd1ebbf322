"""
Tensor-parallel single-request serving: the counterpart of
riffusion_tpu/parallel/tp_serving.py.

Data parallelism (`riffuse_audio_batch(mesh=...)`) scales throughput: N
ranks serve N clips in the wall time of one. This scales latency: one
request's UNet runs with its attention and feed-forward projections split
over the mesh "model" axis, in the layout of parallel/train.py
`param_spec` (the Megatron-style rule the JAX trainer and server share).

Where GSPMD derives the collectives from the layout, each rank here holds
a copy of the UNet whose column-split projections (to_q, to_k, to_v, the
feed-forward's proj_in, the time embedding's linear_1) keep the rank's
output columns, so that its `Attention` holds num_heads / tp heads and its
GEGLU its share of [value | gate], and whose row-split projections
(to_out, proj_out, linear_2) multiply the rank's input columns and
all-reduce the partial sums over the "model" group (in fp32, or fp64 for
fp64 modules), adding the bias once, after the sum. Convolutions and norms
run whole on every rank. The attention sites call the same kernels, at the
rank's head count: K1 at (2, 4096, 4*40) and (2, 1024, 4*80) at tp 2.

Every rank of the mesh calls `riffuse_audio_tp` with the same arguments
(its noise draws are the same on every rank) and returns the same clip.
"""

from __future__ import annotations

import copy
import typing as T
import weakref

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from PIL import Image
from torch import nn

from riffusion_tpu_torch.datatypes import InferenceInput
from riffusion_tpu_torch.models.layers import Attention, precise
from riffusion_tpu_torch.parallel.mesh import axis_size
from riffusion_tpu_torch.parallel.train import param_spec, shard_params

if T.TYPE_CHECKING:  # pragma: no cover
    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.riffusion_pipeline import NoiseSource, RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

# The tensor-parallel UNet of each (pipeline, mesh), built once. Keyed
# weakly by the pipeline, for the JAX package's reason: an id() key could
# alias a new pipeline after garbage collection (serving stale weights),
# and a strong key would pin the copy's device memory forever.
_TP_CACHE: "weakref.WeakKeyDictionary[T.Any, T.Dict[T.Any, nn.Module]]" = (
    weakref.WeakKeyDictionary()
)


class RowParallelLinear(nn.Module):
    """A Linear layer cut along its input dim: this rank's columns of the
    weight, the whole bias. The rank's partial product is all-reduced over
    `group` in precise(dtype) and the bias added once, after the sum."""

    def __init__(self, weight: torch.Tensor, bias: T.Optional[torch.Tensor], group):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = precise(x.dtype)
        out = F.linear(x, self.weight).to(p)
        dist.all_reduce(out, group=self.group)
        if self.bias is not None:
            out = out + self.bias.to(p)
        return out.to(x.dtype)


def tensor_parallel_unet(unet: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """A copy of `unet` cut over the mesh axis `axis` by param_spec: the
    column-split Linear layers hold this rank's slices, the row-split ones
    become RowParallelLinear, every Attention holds num_heads / tp heads.
    Raises where a head count does not divide by tp."""
    tp = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    shards = shard_params(unet, mesh, axis)
    work = copy.deepcopy(unet)
    for name, module in list(work.named_modules()):
        if isinstance(module, Attention):
            if module.num_heads % tp:
                raise ValueError(f"{name} has {module.num_heads} heads, which do not split "
                                 f"over {tp} ranks")
            module.num_heads //= tp
        if not isinstance(module, nn.Linear) or f"{name}.weight" not in shards:
            continue
        weight = shards[f"{name}.weight"]
        if param_spec(f"{name}.weight", module.weight).dim == 1:  # row-split
            parent, _, child = name.rpartition(".")
            setattr(work.get_submodule(parent), child,
                    RowParallelLinear(weight, module.bias, group))
        else:
            module.weight = nn.Parameter(weight, requires_grad=False)
            if module.bias is not None:
                module.bias = nn.Parameter(shards[f"{name}.bias"], requires_grad=False)
            module.out_features = weight.shape[0]
    return work.eval()


def _tp_unet(pipeline: "RiffusionPipeline", mesh) -> nn.Module:
    per_pipe = _TP_CACHE.setdefault(pipeline, {})
    if mesh not in per_pipe:
        per_pipe[mesh] = tensor_parallel_unet(pipeline.unet, mesh)
    return per_pipe[mesh]


def riffuse_audio_tp(
    pipeline: "RiffusionPipeline",
    inputs: InferenceInput,
    init_image: Image.Image,
    mesh,
    params: T.Optional["SpectrogramParams"] = None,
    mask_image: T.Optional[Image.Image] = None,
    use_reweighting: bool = True,
    apply_filters: bool = True,
    scheduler: T.Optional[str] = None,
    *,
    noise: T.Optional["NoiseSource"] = None,
) -> T.Tuple[Image.Image, "AudioSegment"]:
    """One riffuse_audio request with the UNet tensor-parallel over `mesh`'s
    "model" axis; every rank of the mesh calls it with the same arguments.
    Returns (PIL image, AudioSegment) on every rank, with the argument
    surface of `RiffusionPipeline.riffuse_audio` (mask, reweighting,
    filters, scheduler, and the port's `noise`)."""
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    pipeline._check_mesh(mesh)
    params = params or SpectrogramParams()
    wait = pipeline._dispatch(
        [inputs], [init_image], mask_image, use_reweighting, params,
        None if noise is None else [noise], scheduler, unet=_tp_unet(pipeline, mesh),
    )
    images_np, waveforms_np = wait()
    return pipeline._results(images_np, waveforms_np, params, apply_filters)[0]


def dryrun_tp_serving(n_devices: int, device: str = "cuda") -> float:
    """One tensor-parallel riffuse_audio on tiny shapes, on every rank of an
    initialized world of n_devices (parallel/dryrun.py); returns the clip's
    seconds. The JAX package lays all n devices on "model"; the tiny UNet
    has 2 heads, which split over at most 2 ranks here, so the mesh is
    ("data", "model") with "model" the largest divisor of n that divides
    the heads, and the ranks along "data" serve the request alike."""
    from riffusion_tpu_torch.datatypes import PromptInput
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need a world of {n_devices}, have {dist.get_world_size()}")
    pipe = RiffusionPipeline.load_checkpoint("random:tiny", device=device)
    heads = min(m.num_heads for m in pipe.unet.modules() if isinstance(m, Attention))
    tp = max(t for t in range(1, n_devices + 1) if n_devices % t == 0 and heads % t == 0)
    mesh = make_mesh((n_devices // tp, tp), ("data", "model"),
                     device_type=torch.device(device).type)
    rng = np.random.default_rng(0)
    init = Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8))
    inputs = InferenceInput(
        start=PromptInput(prompt="tp check", seed=1),
        end=PromptInput(prompt="target", seed=2),
        alpha=0.4,
        num_inference_steps=2,
    )
    _, segment = riffuse_audio_tp(
        pipe, inputs, init, mesh, params=SpectrogramParams(num_frequencies=64)
    )
    data = segment.raw_data.astype(np.float64)
    if not (np.isfinite(data).all() and np.abs(data).max() > 0):
        raise RuntimeError("the tensor-parallel clip is silent or not finite")
    return segment.duration_seconds
