"""
AutoencoderKL (VAE), SD v1 architecture, as an nn.Module.

The counterpart of riffusion_tpu/models/vae.py, with the same (flat) block
names (`encoder.down_blocks_0_resnets_0`, `decoder.up_blocks_0_upsamplers_0`,
...). NCHW inside and at its methods. The pipeline always runs it in fp32.
`sample` takes its noise as an argument, so a test can hand it the JAX draw.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from riffusion_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    precise,
)
from riffusion_tpu_torch.ops.attention import attention_reference


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: T.Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(32, 32, 32, 32), layers_per_block=1)


def _card_layout(x: torch.Tensor) -> torch.Tensor:
    """The VAE's input as its first convolution takes it. The pipeline hands
    over pixels and latents permuted from NHWC, with channels_last strides.
    On the card they are made NCHW-contiguous, so that every activation
    stays NCHW, where cuDNN's fp32 convolutions are native, and GroupNorm
    stays torch's (models/layers.py sends channels_last input to the NHWC
    kernel). The CPU keeps the layout it is given, as it always has: its
    convolutions and GroupNorm take either, and the JAX-parity tests hold
    its rounding."""
    return x.contiguous() if x.device.type == "cuda" else x


def _precise_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A conv the JAX package runs in precise(dtype) (conv_out, quant convs)."""
    p = precise(conv.weight.dtype)
    return F.conv2d(x.to(p), conv.weight.to(p), conv.bias.to(p), padding=conv.padding)


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (VAE mid block), the
    plain einsum composition with fp32 softmax."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(32, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = y.to(self.to_q.weight.dtype)
        out = attention_reference(
            self.to_q(y), self.to_k(y), self.to_v(y), num_heads=1, scale=1.0 / math.sqrt(c)
        )
        y = self.to_out(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + y


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, None, groups, eps=1e-6)
        self.attentions_0 = VAEAttention(channels)
        self.resnets_1 = ResnetBlock2D(channels, channels, None, groups, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets_1(self.attentions_0(self.resnets_0(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        prev = ch[0]
        for b, out_ch in enumerate(ch):
            for i in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{b}_resnets_{i}", ResnetBlock2D(
                    prev, out_ch, None, cfg.norm_num_groups, eps=1e-6
                ))
                prev = out_ch
            if b != len(ch) - 1:
                self.add_module(f"down_blocks_{b}_downsamplers_0",
                                Downsample2D(out_ch, out_ch, symmetric=False))
        self.mid_block = VAEMidBlock(ch[-1], cfg.norm_num_groups)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        x = self.conv_in(x.to(dtype))
        n = len(cfg.block_out_channels)
        for b in range(n):
            for i in range(cfg.layers_per_block):
                x = getattr(self, f"down_blocks_{b}_resnets_{i}")(x)
            if b != n - 1:
                x = getattr(self, f"down_blocks_{b}_downsamplers_0")(x)
        x = self.mid_block(x)
        x = F.silu(self.conv_norm_out(x)).to(dtype)
        return _precise_conv(self.quant_conv, _precise_conv(self.conv_out, x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = list(reversed(cfg.block_out_channels))
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1)
        self.mid_block = VAEMidBlock(ch[0], cfg.norm_num_groups)
        prev = ch[0]
        for b, out_ch in enumerate(ch):
            for i in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{b}_resnets_{i}", ResnetBlock2D(
                    prev, out_ch, None, cfg.norm_num_groups, eps=1e-6
                ))
                prev = out_ch
            if b != len(ch) - 1:
                self.add_module(f"up_blocks_{b}_upsamplers_0", Upsample2D(out_ch, out_ch))
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        z = _precise_conv(self.post_quant_conv, z)
        x = self.mid_block(self.conv_in(z.to(dtype)))
        n = len(cfg.block_out_channels)
        for b in range(n):
            for i in range(cfg.layers_per_block + 1):
                x = getattr(self, f"up_blocks_{b}_resnets_{i}")(x)
            if b != n - 1:
                x = getattr(self, f"up_blocks_{b}_upsamplers_0")(x)
        x = F.silu(self.conv_norm_out(x)).to(dtype)
        return _precise_conv(self.conv_out, x)


class AutoencoderKL(nn.Module):
    """VAE with `encode_moments` / `sample` / `decode`, all NCHW.

    encode_moments returns (mean, logvar), each (B, latent_channels, H/8, W/8).
    """

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode_moments(self, x: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.encoder(_card_layout(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    @staticmethod
    def sample(mean: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterized draw, mean + exp(logvar / 2) * eps."""
        return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(_card_layout(z))
