"""
The sequence-parallel UNet: the latent height cut over the mesh "seq" axis,
the counterpart of the JAX trainer's sharding constraint
P("data", "seq", None, None) on the noisy latents and the noise prediction
(riffusion_tpu/parallel/train.py), where GSPMD derives every exchange.

`seq_parallel_unet(unet, mesh)` returns a copy of the UNet with modules
swapped (models/layers.py and models/unet.py stay as they are). Each rank
holds a contiguous block of latent rows, and its forward takes and returns
that block:

- 3x3 convolutions (conv_in, conv_out, the ResNet convolutions,
  Upsample2D.conv) exchange one halo row on each side (comm.halo_exchange)
  and convolve without row padding: the rows of the whole convolution.
- Downsample2D's 3x3 stride-2 convolution needs only the row above, when
  the local row count is even.
- Upsample2D is a nearest resize, local at exactly twice the rows; its
  `out_size` is the skip's, already the local share.
- GroupNorm takes its statistics over the global group: the sums and sums
  of squares all-reduced over "seq" (comm.all_sum) in precise(dtype), the
  variance E[x^2] - mean^2 (the JAX package's one-pass variance).
- Self-attention keeps its queries local and gathers K and V over "seq", so
  K1 runs at (b, S / seq, S) queries against keys; it routes at the global
  query count (ops.attention.route), as JAX's trace sees the site.
- Cross-attention, the 1x1 convolutions, LayerNorm, GEGLU and the time
  embedding are local or replicated.

A level whose rows do not split runs whole. Level 0 splits (the caller
cuts rows that divide by "seq"); a downsampled level splits when the level
above it split into an even local row count. A level that does not split
runs whole on every "seq" rank: the rows are gathered before its
downsampling, every rank computes the whole level, and the way back up
takes the rank's rows after the upsampling into a level that splits. JAX's
own dryrun needs this: 8x8 latents at seq 2 reach a 1-row level. A whole
level's parameters take on each rank the gradient of that rank's rows'
loss; the trainer's sum over "seq" completes them.

The attention swap (`ParallelAttention`) serves the tensor-parallel cut too
(tp_serving.tensor_parallel_unet): over "model" it copies its input
(comm.copy_to) before the column-split projections.
"""

from __future__ import annotations

import copy
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from riffusion_tpu_torch.models import layers
from riffusion_tpu_torch.models.layers import Attention, GroupNorm, precise, timestep_embedding
from riffusion_tpu_torch.models.unet import UNet2DCondition
from riffusion_tpu_torch.ops import attention as attention_ops
from riffusion_tpu_torch.parallel import comm
from riffusion_tpu_torch.parallel.comm import MeshAxis


class SeqState:
    """The "seq" axis of one sequence-parallel UNet, and whether the level
    its forward is at holds the rank's rows (`split`) or the whole."""

    def __init__(self, axis: MeshAxis):
        self.axis = axis
        self.split = False


def swap_class(module: nn.Module, cls: type, **attrs) -> nn.Module:
    """Make `module` an instance of its subclass `cls` in place (its
    parameters, names and order kept) and set `attrs` on it."""
    if not isinstance(module, cls):
        module.__class__ = cls
    for name, value in attrs.items():
        setattr(module, name, value)
    return module


def halo_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: T.Optional[torch.Tensor],
                stride: int, pad_w: int, axis: MeshAxis) -> torch.Tensor:
    """A 3x3 convolution padded by 1 of a block of rows, equal to those rows
    of the whole convolution: the halo rows from the neighbours, no row
    padding. At stride 2 (an even row count) the window reads only the row
    above the block."""
    x = comm.halo_exchange(x, axis, 2)
    if stride == 2:
        x = x[:, :, :-1]
    return F.conv2d(x, weight, bias, stride, (0, pad_w))


class HaloConv2d(nn.Conv2d):
    seq: SeqState

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.seq.split:
            return super().forward(x)
        return halo_conv2d(x, self.weight, self.bias, self.stride[0], self.padding[1],
                           self.seq.axis)


class SeqGroupNorm(GroupNorm):
    seq: SeqState

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if not self.seq.split:
            return super().forward(x, silu)
        p = precise(x.dtype)
        b, c = x.shape[:2]
        xg = x.to(p).reshape(b, self.num_groups, -1)
        sums = comm.all_sum(torch.stack([xg.sum(-1), xg.square().sum(-1)]), self.seq.axis)
        count = xg.shape[-1] * self.seq.axis.size
        mean = sums[0] / count
        var = sums[1] / count - mean.square()
        y = ((xg - mean[..., None]) * torch.rsqrt(var + self.eps)[..., None]).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (y * self.weight.to(p).view(shape) + self.bias.to(p).view(shape)).to(x.dtype)
        return F.silu(y) if silu else y


class ParallelAttention(Attention):
    """Attention with its input copied over "model" (`model`, when the
    projections are cut) and, at a level split over "seq" (`seq`), K and V
    of self-attention gathered over the rows; routed at the global query
    count and (through ops.attention.route_batch) the global batch."""

    model: T.Optional[MeshAxis] = None
    seq: T.Optional[SeqState] = None

    def forward(self, x: torch.Tensor, context: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.model is not None:
            x = comm.copy_to(x, self.model)
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        seq_q = q.shape[1]
        if context is None and self.seq is not None and self.seq.split:
            axis = self.seq.axis
            k, v = comm.gather(k, axis, 1), comm.gather(v, axis, 1)
            seq_q *= axis.size
        scale = 1.0 / math.sqrt(self.head_dim)
        op = layers._ATTENTION_OPS[
            attention_ops.route(attention_ops.routed_batch(q.shape[0]), seq_q, self.head_dim,
                                context is None)
        ]
        return self.to_out(op(q, k, v, num_heads=self.num_heads, scale=scale))


def _level_splits(local_rows: int, levels: int) -> T.List[bool]:
    """Whether each UNet level holds a block of rows (True) or runs whole,
    from level 0's local row count: a level splits when the one above split
    into an even count."""
    splits = [True]
    for _ in range(levels - 1):
        splits.append(splits[-1] and local_rows % 2 == 0)
        local_rows //= 2
    return splits


class SeqParallelUNet(UNet2DCondition):
    """UNet2DCondition.forward over a block of latent rows (module
    docstring); takes and returns the rank's rows."""

    seq: SeqState

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        cfg, dtype, state = self.cfg, self.dtype, self.seq
        axis = state.axis
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        context = encoder_hidden_states.to(dtype)
        t_emb = timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift, dtype=precise(dtype),
        )
        temb = self.time_embedding(t_emb)
        n = len(cfg.block_out_channels)
        splits = _level_splits(sample.shape[2], n)

        state.split = True
        x = self.conv_in(sample.to(dtype))
        skips: T.List[torch.Tensor] = [x]
        for b in range(n):
            block = getattr(self, f"down_blocks_{b}")
            state.split = splits[b]
            for i in range(block.n):
                x = getattr(block, f"resnets_{i}")(x, temb)
                if block.has_attn:
                    x = getattr(block, f"attentions_{i}")(x, context)
                skips.append(x)
            if block.add_downsample:
                if splits[b] and not splits[b + 1]:
                    x = comm.gather(x, axis, 2)
                state.split = splits[b + 1]
                x = block.downsamplers_0(x)
                skips.append(x)

        x = self.mid_block(x, temb, context)

        for i in range(n):
            level, take = n - 1 - i, cfg.layers_per_block + 1
            block_skips, skips = skips[-take:], skips[:-take]
            block = getattr(self, f"up_blocks_{i}")
            state.split = splits[level]
            for j in range(block.n):
                x = torch.cat([x, block_skips.pop()], dim=1)
                x = getattr(block, f"resnets_{j}")(x, temb)
                if block.has_attn:
                    x = getattr(block, f"attentions_{j}")(x, context)
            if block.add_upsample:
                rows, cols = skips[-1].shape[2:4]  # the next level's skip: a block or the whole
                if splits[level] or not splits[level - 1]:
                    x = block.upsamplers_0(x, (rows, cols))
                else:  # a whole level into one that splits: upsample whole, keep the rows
                    x = block.upsamplers_0(x, (rows * axis.size, cols))
                    x = x.narrow(2, axis.rank * rows, rows)

        state.split = True
        x = F.silu(self.conv_norm_out(x)).to(dtype)
        p = precise(dtype)
        return halo_conv2d(x.to(p), self.conv_out.weight.to(p), self.conv_out.bias.to(p), 1, 1,
                           axis)


def seq_parallel_unet(unet: UNet2DCondition, mesh, axis: str = "seq") -> SeqParallelUNet:
    """A copy of `unet` whose forward runs on the rank's block of latent
    rows, cut over the mesh axis `axis` (module docstring)."""
    state = SeqState(MeshAxis.of(mesh, axis))
    work = copy.deepcopy(unet)
    for module in list(work.modules()):
        if isinstance(module, nn.Conv2d) and module.kernel_size == (3, 3):
            swap_class(module, HaloConv2d, seq=state)
        elif isinstance(module, GroupNorm):
            swap_class(module, SeqGroupNorm, seq=state)
        elif isinstance(module, Attention):
            swap_class(module, ParallelAttention, seq=state)
    return swap_class(work, SeqParallelUNet, seq=state)
