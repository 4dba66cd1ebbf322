"""
UNet2DCondition — the Stable Diffusion v1 denoiser, as an nn.Module.

The counterpart of riffusion_tpu/models/unet.py, with the same block and
parameter names (`down_blocks_0.attentions_0.blocks_0.attn1.to_q`, ...) and
the same config dataclass. `UNetXLConfig` widens it to Stable Diffusion XL
base 1.0's UNet, which the JAX package does not have: a head count and a
transformer depth a level (the mid block takes the last level's), linear
projections into and out of each transformer's tokens, and the "text_time"
added embedding (the pooled text embedding and six micro-conditioning ids
through a second MLP, added to the time embedding).

`forward` takes NCHW latents and returns NCHW-contiguous ones, the JAX
package's layout at the port's public functions. Inside, its tensors take
the layout of its weights: the serving pipeline puts the UNet in
channels_last (NHWC storage, what cuDNN's bf16 convolutions read on the
card), so the latents are converted once on the way in and every activation
stays NHWC through the skips' concatenations, the resizes, the residual
adds and the transformers' token views, with GroupNorm on
ops/group_norm.py's NHWC kernel; the trainer's NCHW copy runs as it always
has. conv_out and the timestep embedding run in fp32 whatever the compute
dtype, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from riffusion_tpu_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    precise,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD v1 geometry by default; `tiny()` for tests."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: T.Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # number of heads (diffusers v1 naming quirk)
    cross_attn_blocks: T.Tuple[bool, ...] = (True, True, True, False)
    norm_num_groups: int = 32
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(32, 64, 64, 64),
            layers_per_block=1,
            cross_attention_dim=64,
            attention_head_dim=2,
        )

    def heads(self, level: int) -> int:
        """The head count of a level's transformers (the mid block: the last
        level's)."""
        heads = self.attention_head_dim
        return heads[level] if isinstance(heads, tuple) else heads

    def depth(self, level: int) -> int:
        """The transformer blocks in each of a level's transformers."""
        return 1

    @property
    def linear_projection(self) -> bool:
        return False

    @property
    def text_time(self) -> bool:
        """Whether the model adds SDXL's text_time embedding."""
        return False


@dataclasses.dataclass(frozen=True)
class UNetXLConfig(UNetConfig):
    """Stable Diffusion XL base 1.0's UNet (unet/config.json) by default:
    `attention_head_dim` and `transformer_layers_per_block` hold one value a
    level, the transformers project with linear layers, and with
    `addition_embed_type` "text_time" the model takes the pooled text
    embedding and the time ids: each id as `addition_time_embed_dim`
    sinusoids, after the pooled vector, through a
    `projection_class_embeddings_input_dim` -> temb MLP."""

    block_out_channels: T.Tuple[int, ...] = (320, 640, 1280)
    cross_attention_dim: int = 2048
    attention_head_dim: T.Tuple[int, ...] = (5, 10, 20)
    cross_attn_blocks: T.Tuple[bool, ...] = (False, True, True)
    transformer_layers_per_block: T.Tuple[int, ...] = (1, 2, 10)
    use_linear_projection: bool = True
    addition_embed_type: T.Optional[str] = "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816

    def depth(self, level: int) -> int:
        return self.transformer_layers_per_block[level]

    @property
    def linear_projection(self) -> bool:
        return self.use_linear_projection

    @property
    def text_time(self) -> bool:
        return self.addition_embed_type == "text_time"


def _transformer(cfg: UNetConfig, channels: int, level: int) -> Transformer2D:
    return Transformer2D(channels, cfg.heads(level), cfg.cross_attention_dim,
                         depth=cfg.depth(level), groups=cfg.norm_num_groups,
                         linear=cfg.linear_projection)


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int, temb_dim: int,
                 add_downsample: bool, has_attn: bool, level: int = 0):
        super().__init__()
        self.n = cfg.layers_per_block
        self.has_attn = has_attn
        self.add_downsample = add_downsample
        for i in range(self.n):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                in_channels if i == 0 else out_channels, out_channels, temb_dim,
                cfg.norm_num_groups,
            ))
            if has_attn:
                self.add_module(f"attentions_{i}", _transformer(cfg, out_channels, level))
        if add_downsample:
            self.downsamplers_0 = Downsample2D(out_channels, out_channels)

    def forward(self, x, temb, context):
        skips = []
        for i in range(self.n):
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attn:
                x = getattr(self, f"attentions_{i}")(x, context)
            skips.append(x)
        if self.add_downsample:
            x = self.downsamplers_0(x)
            skips.append(x)
        return x, skips


class CrossAttnUpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, skip_channels: T.List[int],
                 out_channels: int, temb_dim: int, add_upsample: bool, has_attn: bool,
                 level: int = 0):
        super().__init__()
        self.n = cfg.layers_per_block + 1
        self.has_attn = has_attn
        self.add_upsample = add_upsample
        ch = in_channels
        for i in range(self.n):
            self.add_module(f"resnets_{i}", ResnetBlock2D(
                ch + skip_channels[i], out_channels, temb_dim, cfg.norm_num_groups
            ))
            ch = out_channels
            if has_attn:
                self.add_module(f"attentions_{i}", _transformer(cfg, out_channels, level))
        if add_upsample:
            self.upsamplers_0 = Upsample2D(out_channels, out_channels)

    def forward(self, x, skips, temb, context, upsample_to=None):
        for i in range(self.n):
            x = torch.cat([x, skips.pop()], dim=1)
            x = getattr(self, f"resnets_{i}")(x, temb)
            if self.has_attn:
                x = getattr(self, f"attentions_{i}")(x, context)
        if self.add_upsample:
            x = self.upsamplers_0(x, out_size=upsample_to)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, temb_dim: int):
        super().__init__()
        self.resnets_0 = ResnetBlock2D(channels, channels, temb_dim, cfg.norm_num_groups)
        self.attentions_0 = _transformer(cfg, channels, len(cfg.block_out_channels) - 1)
        self.resnets_1 = ResnetBlock2D(channels, channels, temb_dim, cfg.norm_num_groups)

    def forward(self, x, temb, context):
        x = self.resnets_0(x, temb)
        x = self.attentions_0(x, context)
        return self.resnets_1(x, temb)


class UNet2DCondition(nn.Module):
    """forward(latents (B, C, H, W), timesteps (B,) or scalar,
    encoder_hidden_states (B, seq, cross_dim)) -> noise prediction (B, C, H, W)
    in precise(dtype), NCHW-contiguous whatever the layout of the weights.
    A text_time model (SDXL) also takes `text_embeds` (B, pooled dim), the
    pooled text embedding, and `time_ids` (B, 6): the original height and
    width, the crop's top and left, the target height and width."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.block_out_channels
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        if cfg.text_time:
            self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim,
                                                   temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        n = len(ch)
        skip_channels = [ch[0]]
        prev = ch[0]
        for b in range(n):
            self.add_module(f"down_blocks_{b}", CrossAttnDownBlock(
                cfg, prev, ch[b], temb_dim, add_downsample=(b != n - 1),
                has_attn=cfg.cross_attn_blocks[b], level=b,
            ))
            skip_channels += [ch[b]] * cfg.layers_per_block + ([ch[b]] if b != n - 1 else [])
            prev = ch[b]

        self.mid_block = MidBlock(cfg, ch[-1], temb_dim)

        prev = ch[-1]
        for i, b in enumerate(reversed(range(n))):
            take = cfg.layers_per_block + 1
            block_skips, skip_channels = skip_channels[-take:], skip_channels[:-take]
            self.add_module(f"up_blocks_{i}", CrossAttnUpBlock(
                cfg, prev, list(reversed(block_skips)), ch[b], temb_dim,
                add_upsample=(b != 0), has_attn=cfg.cross_attn_blocks[b], level=b,
            ))
            prev = ch[b]

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, text_embeds: T.Optional[torch.Tensor] = None,
                time_ids: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        context = encoder_hidden_states.to(dtype)

        t_emb = timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift, dtype=precise(dtype),
        )
        temb = self.time_embedding(t_emb)
        if cfg.text_time:
            if text_embeds is None or time_ids is None:
                raise ValueError("this UNet takes the added conditions text_embeds and time_ids "
                                 "(SDXL's text_time embedding)")
            ids = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim,
                flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
                dtype=precise(dtype),
            ).reshape(time_ids.shape[0], -1)
            temb = temb + self.add_embedding(torch.cat([text_embeds.to(ids.dtype), ids], dim=-1))
        nhwc = self.conv_in.weight.is_contiguous(memory_format=torch.channels_last)
        x = self.conv_in(sample.to(dtype, memory_format=torch.channels_last if nhwc
                                   else torch.preserve_format))

        n = len(cfg.block_out_channels)
        skips: T.List[torch.Tensor] = [x]
        for b in range(n):
            x, block_skips = getattr(self, f"down_blocks_{b}")(x, temb, context)
            skips.extend(block_skips)

        x = self.mid_block(x, temb, context)

        for i in range(n):
            take = cfg.layers_per_block + 1
            block_skips, skips = skips[-take:], skips[:-take]
            # upsample to the next block's skip size (odd intermediate dims)
            upsample_to = tuple(skips[-1].shape[2:4]) if skips else None
            x = getattr(self, f"up_blocks_{i}")(x, list(block_skips), temb, context, upsample_to)

        x = self.conv_norm_out(x, silu=True).to(dtype)
        # in NCHW, where cuDNN's fp32 convolution is native: the casts to
        # fp32 make the NCHW copies, and no layout transpose runs
        p, nchw = precise(dtype), torch.contiguous_format
        out = F.conv2d(x.to(p, memory_format=nchw), self.conv_out.weight.to(p, memory_format=nchw),
                       self.conv_out.bias.to(p), padding=1)
        return out.contiguous()
