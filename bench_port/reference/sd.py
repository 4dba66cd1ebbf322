"""
Plain PyTorch reference of Stable Diffusion v1: the UNet, the VAE and the
CLIP text encoder as functions of a diffusers-layout state dict, and the
shapes of those state dicts.

Written against the published diffusers / transformers semantics (the UNet
and VAE are a frozen copy of the repository's test oracle
tests/torch_sd_reference.py), with every product going through a
`Numerics` object: full float32 by default (the caller turns TF32 off), or
a lower precision for the benchmark's control (`Fp8Numerics`). Nothing here
imports the program under test.

* UNet2DConditionModel: sinusoidal time embedding (flip_sin_to_cos, shift 0)
  -> 2-layer MLP; conv_in; down blocks (resnet [+ spatial transformer]) with
  a skip after every layer and after each downsampler; mid resnet /
  transformer / resnet; up blocks popping skips in reverse, concatenated
  after x before each resnet; nearest-2x upsample + conv; GroupNorm -> silu
  -> conv_out.
* Transformer2DModel: GN(eps 1e-6) -> 1x1 proj_in -> tokens ->
  BasicTransformerBlock (pre-LN self-attention, cross-attention, GEGLU with
  exact erf gelu) -> 1x1 proj_out, residual.
* AutoencoderKL: encoder (downsamplers pad (0, 1, 0, 1)), mid block with
  one-head attention, quant_conv / post_quant_conv, decoder with
  layers_per_block + 1 resnets per up block.
* CLIPTextModel: token + position embedding, pre-LN layers with a causal
  mask, quick-gelu MLP, final LayerNorm; the last hidden state.
"""

from __future__ import annotations

import math
import typing as T

import numpy as np
import torch
import torch.nn.functional as F

SD = T.Mapping[str, torch.Tensor]


# ------------------------------------------------------------------ numerics


class Numerics:
    """Full-precision products: float32 operands, float32 results."""

    name = "fp32"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def linear(self, x, w, b=None):
        return F.linear(self.operand(x), self.operand(w), b)

    def conv(self, x, w, b=None, stride=1, padding=1):
        return F.conv2d(self.operand(x), self.operand(w), b, stride=stride, padding=padding)

    def matmul(self, a, b):
        return self.operand(a) @ self.operand(b)


class Fp8Numerics(Numerics):
    """Every operand of a product rounded to float8 e4m3 at a per-tensor
    scale (its largest magnitude at e4m3's largest finite value, 448), the
    product then taken in float32: the step below bfloat16."""

    name = "fp8"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = 448.0 / amax
        q = (x.float() * scale).to(torch.float8_e4m3fn).float()
        return (q / scale).to(x.dtype)


FP32 = Numerics()


# ------------------------------------------------------------- state shapes


class Leaf(T.NamedTuple):
    shape: T.Tuple[int, ...]
    kind: str  # "weight", "bias" or "norm"
    fan_in: int


def _conv_leaves(out: T.Dict[str, Leaf], p: str, cin: int, cout: int, k: int = 3) -> None:
    out[f"{p}.weight"] = Leaf((cout, cin, k, k), "weight", cin * k * k)
    out[f"{p}.bias"] = Leaf((cout,), "bias", 0)


def _linear_leaves(out, p, cin, cout, bias=True) -> None:
    out[f"{p}.weight"] = Leaf((cout, cin), "weight", cin)
    if bias:
        out[f"{p}.bias"] = Leaf((cout,), "bias", 0)


def _norm_leaves(out, p, c) -> None:
    out[f"{p}.weight"] = Leaf((c,), "norm", 0)
    out[f"{p}.bias"] = Leaf((c,), "bias", 0)


def _resnet_leaves(out, p, cin, cout, temb: T.Optional[int]) -> None:
    _norm_leaves(out, f"{p}.norm1", cin)
    _conv_leaves(out, f"{p}.conv1", cin, cout)
    if temb is not None:
        _linear_leaves(out, f"{p}.time_emb_proj", temb, cout)
    _norm_leaves(out, f"{p}.norm2", cout)
    _conv_leaves(out, f"{p}.conv2", cout, cout)
    if cin != cout:
        _conv_leaves(out, f"{p}.conv_shortcut", cin, cout, k=1)


def _transformer_leaves(out, p, c, cross) -> None:
    _norm_leaves(out, f"{p}.norm", c)
    _conv_leaves(out, f"{p}.proj_in", c, c, k=1)
    b = f"{p}.transformer_blocks.0"
    for i, ctx in ((1, c), (2, cross)):
        _norm_leaves(out, f"{b}.norm{i}", c)
        _linear_leaves(out, f"{b}.attn{i}.to_q", c, c, bias=False)
        _linear_leaves(out, f"{b}.attn{i}.to_k", ctx, c, bias=False)
        _linear_leaves(out, f"{b}.attn{i}.to_v", ctx, c, bias=False)
        _linear_leaves(out, f"{b}.attn{i}.to_out.0", c, c)
    _norm_leaves(out, f"{b}.norm3", c)
    _linear_leaves(out, f"{b}.ff.net.0.proj", c, 8 * c)
    _linear_leaves(out, f"{b}.ff.net.2", 4 * c, c)
    _conv_leaves(out, f"{p}.proj_out", c, c, k=1)


def unet_leaves(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, Leaf]:
    """The diffusers UNet2DConditionModel state dict's keys and shapes."""
    bo = list(cfg["block_out_channels"])
    lpb, cross = cfg["layers_per_block"], cfg["cross_attention_dim"]
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    temb = 4 * bo[0]
    out: T.Dict[str, Leaf] = {}
    _linear_leaves(out, "time_embedding.linear_1", bo[0], temb)
    _linear_leaves(out, "time_embedding.linear_2", temb, temb)
    _conv_leaves(out, "conv_in", cfg["in_channels"], bo[0])
    skips = [bo[0]]
    c = bo[0]
    for b, cout in enumerate(bo):
        for i in range(lpb):
            _resnet_leaves(out, f"down_blocks.{b}.resnets.{i}", c, cout, temb)
            c = cout
            if attn[b]:
                _transformer_leaves(out, f"down_blocks.{b}.attentions.{i}", c, cross)
            skips.append(c)
        if b != len(bo) - 1:
            _conv_leaves(out, f"down_blocks.{b}.downsamplers.0.conv", c, c)
            skips.append(c)
    _resnet_leaves(out, "mid_block.resnets.0", c, c, temb)
    _transformer_leaves(out, "mid_block.attentions.0", c, cross)
    _resnet_leaves(out, "mid_block.resnets.1", c, c, temb)
    for u, b in enumerate(reversed(range(len(bo)))):
        cout = bo[b]
        for i in range(lpb + 1):
            _resnet_leaves(out, f"up_blocks.{u}.resnets.{i}", c + skips.pop(), cout, temb)
            c = cout
            if attn[b]:
                _transformer_leaves(out, f"up_blocks.{u}.attentions.{i}", c, cross)
        if b != 0:
            _conv_leaves(out, f"up_blocks.{u}.upsamplers.0.conv", c, c)
    _norm_leaves(out, "conv_norm_out", c)
    _conv_leaves(out, "conv_out", c, cfg["out_channels"])
    return out


def _vae_attention_leaves(out, p, c) -> None:
    _norm_leaves(out, f"{p}.group_norm", c)
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        _linear_leaves(out, f"{p}.{name}", c, c)


def vae_leaves(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, Leaf]:
    """The diffusers AutoencoderKL state dict's keys and shapes."""
    bo = list(cfg["block_out_channels"])
    lpb, lat = cfg["layers_per_block"], cfg["latent_channels"]
    out: T.Dict[str, Leaf] = {}
    _conv_leaves(out, "encoder.conv_in", cfg["in_channels"], bo[0])
    c = bo[0]
    for b, cout in enumerate(bo):
        for i in range(lpb):
            _resnet_leaves(out, f"encoder.down_blocks.{b}.resnets.{i}", c, cout, None)
            c = cout
        if b != len(bo) - 1:
            _conv_leaves(out, f"encoder.down_blocks.{b}.downsamplers.0.conv", c, c)
    for side in ("encoder", "decoder"):
        if side == "decoder":
            _conv_leaves(out, "post_quant_conv", lat, lat, k=1)
            _conv_leaves(out, "decoder.conv_in", lat, bo[-1])
        _resnet_leaves(out, f"{side}.mid_block.resnets.0", bo[-1], bo[-1], None)
        _vae_attention_leaves(out, f"{side}.mid_block.attentions.0", bo[-1])
        _resnet_leaves(out, f"{side}.mid_block.resnets.1", bo[-1], bo[-1], None)
        if side == "encoder":
            _norm_leaves(out, "encoder.conv_norm_out", bo[-1])
            _conv_leaves(out, "encoder.conv_out", bo[-1], 2 * lat)
            _conv_leaves(out, "quant_conv", 2 * lat, 2 * lat, k=1)
    c = bo[-1]
    for u, cout in enumerate(reversed(bo)):
        for i in range(lpb + 1):
            _resnet_leaves(out, f"decoder.up_blocks.{u}.resnets.{i}", c, cout, None)
            c = cout
        if u != len(bo) - 1:
            _conv_leaves(out, f"decoder.up_blocks.{u}.upsamplers.0.conv", c, c)
    _norm_leaves(out, "decoder.conv_norm_out", c)
    _conv_leaves(out, "decoder.conv_out", c, cfg["out_channels"])
    return out


def clip_leaves(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, Leaf]:
    """The transformers CLIPTextModel state dict's keys and shapes."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    out: T.Dict[str, Leaf] = {}
    vocab, pos = cfg["vocab_size"], cfg["max_position_embeddings"]
    out["text_model.embeddings.token_embedding.weight"] = Leaf((vocab, d), "weight", vocab)
    out["text_model.embeddings.position_embedding.weight"] = Leaf((pos, d), "weight", pos)
    for i in range(cfg["num_hidden_layers"]):
        p = f"text_model.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear_leaves(out, f"{p}.self_attn.{name}", d, d)
        _norm_leaves(out, f"{p}.layer_norm1", d)
        _linear_leaves(out, f"{p}.mlp.fc1", d, ff)
        _linear_leaves(out, f"{p}.mlp.fc2", ff, d)
        _norm_leaves(out, f"{p}.layer_norm2", d)
    _norm_leaves(out, "text_model.final_layer_norm", d)
    return out


@torch.no_grad()
def make_weights(leaves: T.Mapping[str, Leaf], seed: int, device: T.Union[str, torch.device],
                 dtype: torch.dtype) -> T.Dict[str, torch.Tensor]:
    """A state dict drawn from `seed` on `device` in a few large calls:
    weights N(0, 1/fan_in), zero biases, unit norm scales, in `dtype`. The
    tensors are views of one flat buffer."""
    total = sum(math.prod(leaf.shape) for leaf in leaves.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    views, offset = {}, 0
    for key, leaf in leaves.items():
        n = math.prod(leaf.shape)
        views[key] = flat[offset:offset + n].view(leaf.shape)
        offset += n
    weights = [k for k, leaf in leaves.items() if leaf.kind == "weight"]
    torch._foreach_mul_([views[k] for k in weights],
                        [1.0 / math.sqrt(max(leaves[k].fan_in, 1)) for k in weights])
    torch._foreach_zero_([views[k] for k, leaf in leaves.items() if leaf.kind == "bias"])
    norms = [views[k] for k, leaf in leaves.items() if leaf.kind == "norm"]
    if norms:
        torch._foreach_mul_(norms, 0.0)
        torch._foreach_add_(norms, 1.0)
    if dtype != torch.float32:
        flat = flat.to(dtype)
        offset = 0
        for key, leaf in leaves.items():
            n = math.prod(leaf.shape)
            views[key] = flat[offset:offset + n].view(leaf.shape)
            offset += n
    return views


def widened(state: SD) -> T.Dict[str, torch.Tensor]:
    """Every tensor of `state` in float32 (the same values, exactly)."""
    return {k: v.float() for k, v in state.items()}


# ---------------------------------------------------------------- primitives


def _conv(nx: Numerics, sd: SD, p: str, x, stride=1, padding=1):
    return nx.conv(x, sd[f"{p}.weight"], sd[f"{p}.bias"], stride=stride, padding=padding)


def _linear(nx: Numerics, sd: SD, p: str, x):
    return nx.linear(x, sd[f"{p}.weight"], sd.get(f"{p}.bias"))


def _gn(sd: SD, p: str, x, groups: int, eps: float):
    return F.group_norm(x, groups, sd[f"{p}.weight"], sd[f"{p}.bias"], eps)


def _ln(sd: SD, p: str, x, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], sd[f"{p}.weight"], sd[f"{p}.bias"], eps)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0):
    """diffusers' get_timestep_embedding with flip_sin_to_cos and shift 0."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device) / half
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _resnet(nx, sd: SD, p: str, x, temb, groups: int, eps: float):
    h = _conv(nx, sd, f"{p}.conv1", F.silu(_gn(sd, f"{p}.norm1", x, groups, eps)))
    if temb is not None:
        h = h + _linear(nx, sd, f"{p}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = _conv(nx, sd, f"{p}.conv2", F.silu(_gn(sd, f"{p}.norm2", h, groups, eps)))
    if f"{p}.conv_shortcut.weight" in sd:
        x = _conv(nx, sd, f"{p}.conv_shortcut", x, padding=0)
    return x + h


def _attention(nx, sd: SD, p: str, x, context, heads: int):
    ctx = x if context is None else context
    q, k, v = (_linear(nx, sd, f"{p}.{n}", src)
               for n, src in (("to_q", x), ("to_k", ctx), ("to_v", ctx)))
    b, lq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, -1, heads, d).permute(0, 2, 1, 3)

    q, k, v = split(q), split(k), split(v)
    weights = (nx.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)).softmax(dim=-1)
    out = nx.matmul(weights, v).permute(0, 2, 1, 3).reshape(b, lq, inner)
    return _linear(nx, sd, f"{p}.to_out.0", out)


def _transformer(nx, sd: SD, p: str, x, context, heads: int, groups: int):
    b, c, h, w = x.shape
    y = _conv(nx, sd, f"{p}.proj_in", _gn(sd, f"{p}.norm", x, groups, 1e-6), padding=0)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    t = f"{p}.transformer_blocks.0"
    y = y + _attention(nx, sd, f"{t}.attn1", _ln(sd, f"{t}.norm1", y), None, heads)
    y = y + _attention(nx, sd, f"{t}.attn2", _ln(sd, f"{t}.norm2", y), context, heads)
    value, gate = _linear(nx, sd, f"{t}.ff.net.0.proj", _ln(sd, f"{t}.norm3", y)).chunk(2, -1)
    y = y + _linear(nx, sd, f"{t}.ff.net.2", value * F.gelu(gate))
    y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return _conv(nx, sd, f"{p}.proj_out", y, padding=0) + x


# ---------------------------------------------------------------------- UNet


def unet(sd: SD, cfg: T.Mapping[str, T.Any], sample, timesteps, context,
         nx: Numerics = FP32):
    """eps prediction (B, C, H, W) of `sample` (B, C, H, W) at integer
    `timesteps` (B,) under `context` (B, L, cross_attention_dim)."""
    bo = list(cfg["block_out_channels"])
    lpb, groups, heads = cfg["layers_per_block"], cfg["norm_num_groups"], cfg["attention_head_dim"]
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    temb = _linear(nx, sd, "time_embedding.linear_1", timestep_embedding(timesteps, bo[0]))
    temb = _linear(nx, sd, "time_embedding.linear_2", F.silu(temb))
    x = _conv(nx, sd, "conv_in", sample)
    skips = [x]
    for b in range(len(bo)):
        for i in range(lpb):
            x = _resnet(nx, sd, f"down_blocks.{b}.resnets.{i}", x, temb, groups, 1e-5)
            if attn[b]:
                x = _transformer(nx, sd, f"down_blocks.{b}.attentions.{i}", x, context, heads,
                                 groups)
            skips.append(x)
        if b != len(bo) - 1:
            x = _conv(nx, sd, f"down_blocks.{b}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = _resnet(nx, sd, "mid_block.resnets.0", x, temb, groups, 1e-5)
    x = _transformer(nx, sd, "mid_block.attentions.0", x, context, heads, groups)
    x = _resnet(nx, sd, "mid_block.resnets.1", x, temb, groups, 1e-5)
    for u, b in enumerate(reversed(range(len(bo)))):
        for i in range(lpb + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = _resnet(nx, sd, f"up_blocks.{u}.resnets.{i}", x, temb, groups, 1e-5)
            if attn[b]:
                x = _transformer(nx, sd, f"up_blocks.{u}.attentions.{i}", x, context, heads,
                                 groups)
        if b != 0:
            x = F.interpolate(x, size=skips[-1].shape[-2:], mode="nearest")
            x = _conv(nx, sd, f"up_blocks.{u}.upsamplers.0.conv", x)
    x = F.silu(_gn(sd, "conv_norm_out", x, groups, 1e-5))
    return _conv(nx, sd, "conv_out", x)


# ------------------------------------------------------------------------ VAE


def _vae_mid(nx, sd: SD, p: str, x, groups: int):
    x = _resnet(nx, sd, f"{p}.resnets.0", x, None, groups, 1e-6)
    b, c, h, w = x.shape
    y = _gn(sd, f"{p}.attentions.0.group_norm", x, groups, 1e-6)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    y = _attention(nx, sd, f"{p}.attentions.0", y, None, 1)
    x = x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return _resnet(nx, sd, f"{p}.resnets.1", x, None, groups, 1e-6)


def vae_encode_moments(sd: SD, cfg: T.Mapping[str, T.Any], image, nx: Numerics = FP32):
    """(mean, logvar clamped to [-30, 20]) of images (B, 3, H, W) in [-1, 1]."""
    bo, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
    groups = cfg["norm_num_groups"]
    x = _conv(nx, sd, "encoder.conv_in", image)
    for b in range(len(bo)):
        for i in range(lpb):
            x = _resnet(nx, sd, f"encoder.down_blocks.{b}.resnets.{i}", x, None, groups, 1e-6)
        if b != len(bo) - 1:
            x = _conv(nx, sd, f"encoder.down_blocks.{b}.downsamplers.0.conv",
                      F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    x = _vae_mid(nx, sd, "encoder.mid_block", x, groups)
    x = _conv(nx, sd, "encoder.conv_out", F.silu(_gn(sd, "encoder.conv_norm_out", x, groups, 1e-6)))
    mean, logvar = _conv(nx, sd, "quant_conv", x, padding=0).chunk(2, dim=1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_decode(sd: SD, cfg: T.Mapping[str, T.Any], latents, nx: Numerics = FP32):
    """Images (B, 3, H, W), about [-1, 1], of unscaled latents (B, C, h, w)."""
    bo, lpb = list(cfg["block_out_channels"]), cfg["layers_per_block"]
    groups = cfg["norm_num_groups"]
    x = _conv(nx, sd, "decoder.conv_in", _conv(nx, sd, "post_quant_conv", latents, padding=0))
    x = _vae_mid(nx, sd, "decoder.mid_block", x, groups)
    for u in range(len(bo)):
        for i in range(lpb + 1):
            x = _resnet(nx, sd, f"decoder.up_blocks.{u}.resnets.{i}", x, None, groups, 1e-6)
        if u != len(bo) - 1:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = _conv(nx, sd, f"decoder.up_blocks.{u}.upsamplers.0.conv", x)
    x = F.silu(_gn(sd, "decoder.conv_norm_out", x, groups, 1e-6))
    return _conv(nx, sd, "decoder.conv_out", x)


# ----------------------------------------------------------------------- CLIP


def clip_text(sd: SD, cfg: T.Mapping[str, T.Any], ids: torch.Tensor, nx: Numerics = FP32):
    """The last hidden state (B, L, hidden) of token ids (B, L)."""
    b, length = ids.shape
    heads = cfg["num_attention_heads"]
    tm = "text_model"
    x = (sd[f"{tm}.embeddings.token_embedding.weight"][ids]
         + sd[f"{tm}.embeddings.position_embedding.weight"][:length][None])
    mask = torch.full((length, length), float("-inf"), device=ids.device).triu(1)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{tm}.encoder.layers.{i}"
        h = _ln(sd, f"{p}.layer_norm1", x)
        q, k, v = (_linear(nx, sd, f"{p}.self_attn.{n}_proj", h).reshape(b, length, heads, -1)
                   .transpose(1, 2) for n in "qkv")
        logits = nx.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + mask
        attn = nx.matmul(logits.softmax(-1), v).transpose(1, 2).reshape(b, length, -1)
        x = x + _linear(nx, sd, f"{p}.self_attn.out_proj", attn)
        h = _linear(nx, sd, f"{p}.mlp.fc1", _ln(sd, f"{p}.layer_norm2", x))
        x = x + _linear(nx, sd, f"{p}.mlp.fc2", h * torch.sigmoid(1.702 * h))
    return _ln(sd, f"{tm}.final_layer_norm", x)


def parameter_count(leaves: T.Mapping[str, Leaf]) -> int:
    return int(sum(np.prod(leaf.shape) for leaf in leaves.values()))

