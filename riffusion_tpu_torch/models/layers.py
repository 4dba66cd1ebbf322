"""
Shared building blocks of the diffusion stack (resnet blocks, attention,
transformer blocks, up/downsampling, timestep embeddings), as nn.Modules.

The counterpart of riffusion_tpu/models/layers.py. Module and parameter
names follow the JAX package (`to_q`, `norm1`, `time_emb_proj`, ...) so
models/weights.py can carry a JAX parameter tree across by name. Inside,
tensors are NCHW. A module computes in the dtype of its parameters (bf16 for
the UNet on the card); GroupNorm, LayerNorm statistics, the softmax and the
timestep embedding run in `precise(dtype)` (fp32, or fp64 for fp64
modules), as in the JAX package.
"""

from __future__ import annotations

import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from riffusion_tpu_torch.ops import attention as attention_ops


def precise(dtype: torch.dtype) -> torch.dtype:
    """Accumulation / softmax dtype for a compute dtype: fp32, or fp64."""
    return torch.promote_types(torch.float32, dtype)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sinusoidal timestep embedding, (B,) -> (B, dim), SD v1 convention."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=dtype, device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.to(dtype)[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in precise(dtype), returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = precise(x.dtype)
        return F.group_norm(
            x.to(p), self.num_groups, self.weight.to(p), self.bias.to(p), self.eps
        ).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in precise(dtype), returned in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = precise(x.dtype)
        return F.layer_norm(
            x.to(p), self.normalized_shape, self.weight.to(p), self.bias.to(p), self.eps
        ).to(x.dtype)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP lifting the sinusoidal embedding to the temb dimension."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        x = self.linear_1(t_emb.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(x))


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv -> (+temb) -> GN -> silu -> conv, with skip. eps is
    1e-5 in the UNet and 1e-6 in the VAE."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        temb_dim: T.Optional[int] = None,
        groups: int = 32,
        eps: float = 1e-5,
    ):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb).to(dtype))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        residual = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return (residual + h).to(dtype)


class Attention(nn.Module):
    """Multi-head attention over (b, s, c) tokens (self when context is None).

    ops.attention.route picks the attention at each call, in the JAX
    package's order: K2's kernel (ops.attention.row_attention) at
    self-attention with at least 2048 queries at a batch above 8 (the
    batched path's seq-4096 sites), K1's (ops.attention.attention) at the
    other self-attention sites with at least 256 queries, and the plain
    einsum composition with fp32 softmax elsewhere (cross-attention with 77
    keys, the head_dim-160 sites). Both kernel wrappers take their plain
    version for CPU tensors.
    """

    def __init__(self, query_dim: int, num_heads: int, head_dim: int, out_dim: int,
                 context_dim: T.Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, out_dim)

    def forward(self, x: torch.Tensor, context: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        scale = 1.0 / math.sqrt(self.head_dim)
        op = _ATTENTION_OPS[
            attention_ops.route(q.shape[0], q.shape[1], self.head_dim, context is None)
        ]
        out = op(q, k, v, num_heads=self.num_heads, scale=scale)
        return self.to_out(out)


_ATTENTION_OPS = {
    "row": attention_ops.row_attention,
    "flash": attention_ops.attention,
    "plain": attention_ops.attention_reference,
}


class GEGLUFeedForward(nn.Module):
    """GEGLU feed-forward: Linear(8x) split into value/gate, exact (erf)
    gelu on the gate, Linear back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj_in = nn.Linear(dim, inner * 2)
        self.proj_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(value * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> GEGLU ff, each pre-LayerNorm + residual."""

    def __init__(self, dim: int, num_heads: int, context_dim: int):
        super().__init__()
        head_dim = dim // num_heads
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, num_heads, head_dim, dim)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, num_heads, head_dim, dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: GN (eps 1e-6) -> 1x1 conv in -> transformer
    block(s) on flattened tokens -> 1x1 conv out, residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: int, depth: int = 1,
                 groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks_{i}", BasicTransformerBlock(channels, num_heads, context_dim))
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dtype = self.proj_in.weight.dtype
        y = self.proj_in(self.norm(x).to(dtype))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for i in range(self.depth):
            y = getattr(self, f"blocks_{i}")(y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return (self.proj_out(y) + x).to(dtype)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv. The UNet pads symmetrically by 1; the VAE encoder
    pads (0, 1) on each spatial dim, as diffusers does."""

    def __init__(self, in_channels: int, out_channels: int, symmetric: bool = True):
        super().__init__()
        self.symmetric = symmetric
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=1 if symmetric else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.symmetric:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest resize (half-pixel centers, like jax.image.resize) + 3x3 conv.
    `out_size` overrides the default 2x target for odd skip sizes."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, out_size: T.Optional[T.Tuple[int, int]] = None) -> torch.Tensor:
        size = tuple(out_size) if out_size is not None else (x.shape[2] * 2, x.shape[3] * 2)
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))
