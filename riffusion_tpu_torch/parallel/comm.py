"""
Differentiable collectives over one mesh axis: what the sharded training
step exchanges (parallel/train.py), each a torch.autograd.Function whose
backward is the exchange's transpose.

The two kinds of axis differ in what a rank's loss is. Over "model" every
rank computes the same loss (the activations are replicated, only the
weights are cut); over "seq" and "data" each rank computes its share of a
sum. Hence:

- `copy_to(x, axis)` ("model"): identity forward, all-reduce backward. It
  goes before a column-split layer, whose rank sees a replicated input and
  returns that input's gradient through its own columns only.
- `reduce_from(x, axis)` ("model"): all-reduce forward in precise(dtype),
  identity backward. It comes after a row-split layer; the caller adds the
  bias once, after the sum.
- `halo_exchange(x, axis, dim)` ("seq"): the rows of a rank's neighbours
  above and below its block (zeros at the global edges), concatenated on
  either side of it; the backward adds each halo's gradient back onto the
  row it came from.
- `gather(x, axis, dim)` ("seq"): the ranks' blocks concatenated in axis
  order; the backward sums the gradient over the ranks and keeps the rank's
  own block.
- `all_sum(x, axis)` ("seq"): the sum over the ranks, forward and backward
  (GroupNorm's statistics over the global rows).

Every exchange is an all-reduce. gloo runs only all_reduce and broadcast on
CUDA tensors (no send/recv, all_gather or reduce_scatter), and ranks that
share one card must use gloo (NCCL refuses two ranks on a card). So a gather
or a halo is an all-reduce of a zero buffer holding each rank's rows at its
place: exact in any dtype (each element is one value plus zeros), as
mesh.gather_rows. The same code runs over NCCL unchanged. `dist.all_reduce`
works in place and records nothing for autograd, and
torch.distributed.nn.functional needs all_gather, hence these Functions.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.distributed as dist
from torch.autograd import Function

from riffusion_tpu_torch.models.layers import precise
from riffusion_tpu_torch.parallel.mesh import axis_size


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One axis of a mesh as the collectives use it: its process group, its
    size and this rank's index along it. A module that holds one shares it
    with its deep copies (a process group cannot be copied)."""

    group: T.Any
    size: int
    rank: int

    @classmethod
    def of(cls, mesh, name: str) -> "MeshAxis":
        return cls(mesh.get_group(name), axis_size(mesh, name), mesh.get_local_rank(name))

    def __deepcopy__(self, memo) -> "MeshAxis":
        return self


def _summed(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """A contiguous copy of x summed over the axis (x is left as it is)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=axis.group)
    return out


class _CopyTo(Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.axis), None


class _ReduceFrom(Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.dtype = x.dtype
        return _summed(x.to(precise(x.dtype)), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _AllSum(Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.axis), None


def _placed(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """(size, *x.shape) zeros with x at this rank's place."""
    buf = x.new_zeros((axis.size,) + tuple(x.shape))
    buf[axis.rank] = x
    return buf


class _Gather(Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.rows = axis, dim, x.shape[dim]
        buf = _placed(x, axis)
        dist.all_reduce(buf, group=axis.group)
        return torch.cat(buf.unbind(0), dim)

    @staticmethod
    def backward(ctx, grad):
        total = _summed(grad, ctx.axis)
        return total.narrow(ctx.dim, ctx.axis.rank * ctx.rows, ctx.rows), None, None


class _Halo(Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.rows = axis, dim, x.shape[dim]
        n, r, h = axis.size, axis.rank, x.shape[dim]
        edges = _placed(torch.stack([x.narrow(dim, 0, 1), x.narrow(dim, h - 1, 1)]), axis)
        dist.all_reduce(edges, group=axis.group)  # (n, 2, ...): each rank's first and last row
        zero = torch.zeros_like(edges[0, 0])
        above = edges[r - 1, 1] if r > 0 else zero
        below = edges[r + 1, 0] if r < n - 1 else zero
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, grad):
        axis, dim, h = ctx.axis, ctx.dim, ctx.rows
        n, r = axis.size, axis.rank
        edge_shape = list(grad.shape)
        edge_shape[dim] = 1
        back = grad.new_zeros([n, 2] + edge_shape)
        if r > 0:  # the row above came from the previous rank's last row
            back[r - 1, 1] = grad.narrow(dim, 0, 1)
        if r < n - 1:  # the row below from the next rank's first row
            back[r + 1, 0] = grad.narrow(dim, h + 1, 1)
        dist.all_reduce(back, group=axis.group)
        out = grad.narrow(dim, 1, h).clone()
        out.narrow(dim, 0, 1).add_(back[r, 0])
        out.narrow(dim, h - 1, 1).add_(back[r, 1])
        return out, None, None


def copy_to(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """x, whose gradient is summed over the axis in the backward."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of the ranks' x in precise(x.dtype); the gradient passes
    back unchanged (cast to x's dtype)."""
    return _ReduceFrom.apply(x, axis)


def all_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of the ranks' x, on every rank; its gradient is summed too."""
    return _AllSum.apply(x, axis)


def gather(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """The ranks' x (one shape on every rank) concatenated along `dim` in
    axis order, on every rank."""
    return _Gather.apply(x, axis, dim)


def halo_exchange(x: torch.Tensor, axis: MeshAxis, dim: int) -> torch.Tensor:
    """x with one row more on each side along `dim`: the previous rank's
    last row above, the next rank's first row below, zeros at the ends."""
    return _Halo.apply(x, axis, dim)
