"""
Pure-torch reference of Stable Diffusion XL base 1.0 for the tests, written
against the published diffusers / transformers semantics as functions of
their state dicts (`torch.nn.functional` only, float32 unless the caller
hands in another dtype; no diffusers, transformers, JAX or port import).
The SD v1 primitives and the KL VAE come from tests/torch_sd_reference.py.

* UNet2DConditionModel (unet/config.json): the v1 wiring with
  `attention_head_dim` as one head count a level and
  `transformer_layers_per_block` as one depth a level (the mid block takes
  the last level's, the up blocks their level's), linear `proj_in` /
  `proj_out` on the tokens (use_linear_projection), and the "text_time"
  added embedding: each of the six time ids as `addition_time_embed_dim`
  sinusoids (flip_sin_to_cos, shift 0), after the pooled text embedding,
  through add_embedding's linear -> silu -> linear, added to the time
  embedding.
* CLIPTextModel / CLIPTextModelWithProjection: token + position embedding,
  pre-LN layers with a causal mask, the config's activation (quick_gelu for
  ViT-L/14, exact gelu for OpenCLIP ViT-bigG/14), every hidden state kept;
  the pooled output is the final-LayerNormed last state at the
  end-of-text token, through the bias-free `text_projection`.
* The text conditioning (the SDXL pipeline's encode_prompt): both towers'
  penultimate hidden states concatenated (768 + 1280), the pooled vector
  from the second tower.
* EulerDiscreteScheduler (scheduler/scheduler_config.json): scaled-linear
  betas 0.00085-0.012, epsilon prediction, "leading" spacing with
  steps_offset 1, sigmas interpolated linearly at those timesteps, the model
  input scaled by 1/sqrt(sigma^2 + 1), x += eps * (sigma_next - sigma).

Departures from the published description, each a choice of the repo's
random-weight configuration:
* the pooling position is the first end-of-text token id, not
  transformers' legacy `argmax` of the ids: the hashing tokenizer's ids are
  not BPE ids, and its end-of-text id is not the largest;
* both towers read the same ids (SDXL's second tokenizer pads with "!", a
  BPE detail the hashing tokenizer does not have);
* the img2img start is riffusion's (init_timestep = int(steps * strength)
  + steps_offset, capped at steps; start index steps - init_timestep +
  steps_offset), which for 50 steps at 0.75 runs the 37 steps that
  diffusers' SDXL img2img runs.

Both TF32 switches are turned off here.
"""

from __future__ import annotations

import math
import typing as T

import numpy as np
import torch
import torch.nn.functional as F

from torch_sd_reference import (
    _attention,
    _conv,
    _gn,
    _linear,
    _ln,
    _resnet,
    timestep_embedding,
    vae_decode,
    vae_encode_moments,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SD = T.Mapping[str, torch.Tensor]

__all__ = ["unet_forward", "clip_hidden_states", "text_conditioning", "euler_sigmas",
           "img2img_start", "riffuse_image", "vae_decode", "vae_encode_moments",
           "unet_shapes", "vae_shapes", "clip_shapes", "random_state"]


# ------------------------------------------------------------ state shapes
#
# The published state dicts' keys and shapes, each with its kind: "weight"
# (with its fan-in), "bias" or "norm".

Shapes = T.Dict[str, T.Tuple[T.Tuple[int, ...], str, int]]


def _conv_shape(out: Shapes, p: str, cin: int, cout: int, k: int = 3) -> None:
    out[f"{p}.weight"] = ((cout, cin, k, k), "weight", cin * k * k)
    out[f"{p}.bias"] = ((cout,), "bias", 0)


def _linear_shape(out: Shapes, p: str, cin: int, cout: int, bias: bool = True) -> None:
    out[f"{p}.weight"] = ((cout, cin), "weight", cin)
    if bias:
        out[f"{p}.bias"] = ((cout,), "bias", 0)


def _norm_shape(out: Shapes, p: str, c: int) -> None:
    out[f"{p}.weight"] = ((c,), "norm", 0)
    out[f"{p}.bias"] = ((c,), "bias", 0)


def _resnet_shape(out: Shapes, p: str, cin: int, cout: int, temb: T.Optional[int]) -> None:
    _norm_shape(out, f"{p}.norm1", cin)
    _conv_shape(out, f"{p}.conv1", cin, cout)
    if temb is not None:
        _linear_shape(out, f"{p}.time_emb_proj", temb, cout)
    _norm_shape(out, f"{p}.norm2", cout)
    _conv_shape(out, f"{p}.conv2", cout, cout)
    if cin != cout:
        _conv_shape(out, f"{p}.conv_shortcut", cin, cout, k=1)


def _transformer_shape(out: Shapes, p: str, c: int, cross: int, depth: int, linear: bool):
    _norm_shape(out, f"{p}.norm", c)
    for name in ("proj_in", "proj_out"):
        if linear:
            _linear_shape(out, f"{p}.{name}", c, c)
        else:
            _conv_shape(out, f"{p}.{name}", c, c, k=1)
    for d in range(depth):
        b = f"{p}.transformer_blocks.{d}"
        for i, ctx in ((1, c), (2, cross)):
            _norm_shape(out, f"{b}.norm{i}", c)
            _linear_shape(out, f"{b}.attn{i}.to_q", c, c, bias=False)
            _linear_shape(out, f"{b}.attn{i}.to_k", ctx, c, bias=False)
            _linear_shape(out, f"{b}.attn{i}.to_v", ctx, c, bias=False)
            _linear_shape(out, f"{b}.attn{i}.to_out.0", c, c)
        _norm_shape(out, f"{b}.norm3", c)
        _linear_shape(out, f"{b}.ff.net.0.proj", c, 8 * c)
        _linear_shape(out, f"{b}.ff.net.2", 4 * c, c)


def unet_shapes(cfg: T.Mapping[str, T.Any]) -> Shapes:
    """UNet2DConditionModel's state dict (SD v1 or SDXL geometry)."""
    bo = list(cfg["block_out_channels"])
    n, lpb, cross = len(bo), cfg["layers_per_block"], cfg["cross_attention_dim"]
    depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
    linear = bool(cfg.get("use_linear_projection", False))
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    temb = 4 * bo[0]
    out: Shapes = {}
    _linear_shape(out, "time_embedding.linear_1", bo[0], temb)
    _linear_shape(out, "time_embedding.linear_2", temb, temb)
    if cfg.get("addition_embed_type") == "text_time":
        _linear_shape(out, "add_embedding.linear_1", cfg["projection_class_embeddings_input_dim"],
                      temb)
        _linear_shape(out, "add_embedding.linear_2", temb, temb)
    _conv_shape(out, "conv_in", cfg["in_channels"], bo[0])
    skips, c = [bo[0]], bo[0]
    for b, cout in enumerate(bo):
        for i in range(lpb):
            _resnet_shape(out, f"down_blocks.{b}.resnets.{i}", c, cout, temb)
            c = cout
            if attn[b]:
                _transformer_shape(out, f"down_blocks.{b}.attentions.{i}", c, cross, depth[b],
                                   linear)
            skips.append(c)
        if b != n - 1:
            _conv_shape(out, f"down_blocks.{b}.downsamplers.0.conv", c, c)
            skips.append(c)
    _resnet_shape(out, "mid_block.resnets.0", c, c, temb)
    _transformer_shape(out, "mid_block.attentions.0", c, cross, depth[-1], linear)
    _resnet_shape(out, "mid_block.resnets.1", c, c, temb)
    for u, b in enumerate(reversed(range(n))):
        for i in range(lpb + 1):
            _resnet_shape(out, f"up_blocks.{u}.resnets.{i}", c + skips.pop(), bo[b], temb)
            c = bo[b]
            if attn[b]:
                _transformer_shape(out, f"up_blocks.{u}.attentions.{i}", c, cross, depth[b],
                                   linear)
        if b != 0:
            _conv_shape(out, f"up_blocks.{u}.upsamplers.0.conv", c, c)
    _norm_shape(out, "conv_norm_out", c)
    _conv_shape(out, "conv_out", c, cfg["out_channels"])
    return out


def vae_shapes(cfg: T.Mapping[str, T.Any]) -> Shapes:
    """AutoencoderKL's state dict."""
    bo, lpb, lat = list(cfg["block_out_channels"]), cfg["layers_per_block"], cfg["latent_channels"]
    out: Shapes = {}
    _conv_shape(out, "encoder.conv_in", cfg["in_channels"], bo[0])
    c = bo[0]
    for b, cout in enumerate(bo):
        for i in range(lpb):
            _resnet_shape(out, f"encoder.down_blocks.{b}.resnets.{i}", c, cout, None)
            c = cout
        if b != len(bo) - 1:
            _conv_shape(out, f"encoder.down_blocks.{b}.downsamplers.0.conv", c, c)
    for side in ("encoder", "decoder"):
        if side == "decoder":
            _conv_shape(out, "post_quant_conv", lat, lat, k=1)
            _conv_shape(out, "decoder.conv_in", lat, bo[-1])
        _resnet_shape(out, f"{side}.mid_block.resnets.0", bo[-1], bo[-1], None)
        p = f"{side}.mid_block.attentions.0"
        _norm_shape(out, f"{p}.group_norm", bo[-1])
        for name in ("to_q", "to_k", "to_v", "to_out.0"):
            _linear_shape(out, f"{p}.{name}", bo[-1], bo[-1])
        _resnet_shape(out, f"{side}.mid_block.resnets.1", bo[-1], bo[-1], None)
        if side == "encoder":
            _norm_shape(out, "encoder.conv_norm_out", bo[-1])
            _conv_shape(out, "encoder.conv_out", bo[-1], 2 * lat)
            _conv_shape(out, "quant_conv", 2 * lat, 2 * lat, k=1)
    c = bo[-1]
    for u, cout in enumerate(reversed(bo)):
        for i in range(lpb + 1):
            _resnet_shape(out, f"decoder.up_blocks.{u}.resnets.{i}", c, cout, None)
            c = cout
        if u != len(bo) - 1:
            _conv_shape(out, f"decoder.up_blocks.{u}.upsamplers.0.conv", c, c)
    _norm_shape(out, "decoder.conv_norm_out", c)
    _conv_shape(out, "decoder.conv_out", c, cfg["out_channels"])
    return out


def clip_shapes(cfg: T.Mapping[str, T.Any]) -> Shapes:
    """CLIPTextModel's state dict, with CLIPTextModelWithProjection's
    text_projection where the config names that architecture."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    vocab, pos = cfg["vocab_size"], cfg["max_position_embeddings"]
    out: Shapes = {"text_model.embeddings.token_embedding.weight": ((vocab, d), "weight", vocab),
                   "text_model.embeddings.position_embedding.weight": ((pos, d), "weight", pos)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"text_model.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear_shape(out, f"{p}.self_attn.{name}", d, d)
        _norm_shape(out, f"{p}.layer_norm1", d)
        _linear_shape(out, f"{p}.mlp.fc1", d, ff)
        _linear_shape(out, f"{p}.mlp.fc2", ff, d)
        _norm_shape(out, f"{p}.layer_norm2", d)
    _norm_shape(out, "text_model.final_layer_norm", d)
    if "CLIPTextModelWithProjection" in cfg.get("architectures", ()):
        _linear_shape(out, "text_projection", d, cfg["projection_dim"], bias=False)
    return out


def random_state(shapes: Shapes, seed: int, dtype=torch.float32,
                 norm_jitter: float = 0.0) -> T.Dict[str, torch.Tensor]:
    """Weights N(0, 1/fan_in), zero biases and unit norm scales, from `seed`;
    `norm_jitter` adds that much normal noise to the biases and the norm
    scales (so that a test sees every parameter)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for key, (shape, kind, fan_in) in shapes.items():
        noise = torch.randn(shape, generator=gen, dtype=torch.float64)
        if kind == "weight":
            value = noise / math.sqrt(max(fan_in, 1))
        else:
            value = (1.0 if kind == "norm" else 0.0) + norm_jitter * noise
        out[key] = value.to(dtype)
    return out


def _per_level(value, n: int) -> T.List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _transformer(sd: SD, p: str, x, context, heads: int, depth: int, groups: int,
                 linear: bool):
    b, c, h, w = x.shape
    y = _gn(sd, f"{p}.norm", x, groups, 1e-6)
    if linear:
        y = _linear(sd, f"{p}.proj_in", y.permute(0, 2, 3, 1).reshape(b, h * w, c))
    else:
        y = _conv(sd, f"{p}.proj_in", y, padding=0).permute(0, 2, 3, 1).reshape(b, h * w, c)
    for i in range(depth):
        t = f"{p}.transformer_blocks.{i}"
        y = y + _attention(sd, f"{t}.attn1", _ln(sd, f"{t}.norm1", y), heads=heads)
        y = y + _attention(sd, f"{t}.attn2", _ln(sd, f"{t}.norm2", y), context, heads=heads)
        value, gate = _linear(sd, f"{t}.ff.net.0.proj", _ln(sd, f"{t}.norm3", y)).chunk(2, -1)
        y = y + _linear(sd, f"{t}.ff.net.2", value * F.gelu(gate))
    if linear:
        y = _linear(sd, f"{p}.proj_out", y).reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        y = _conv(sd, f"{p}.proj_out", y.reshape(b, h, w, c).permute(0, 3, 1, 2), padding=0)
    return y + x


@torch.no_grad()
def unet_forward(sd: SD, cfg: T.Mapping[str, T.Any], sample, timesteps, context,
                 text_embeds, time_ids):
    """eps (B, C, H, W) of `sample` at `timesteps` (B,) under `context`
    (B, L, cross_attention_dim), `text_embeds` (B, pooled) and `time_ids`
    (B, 6); `cfg` is a diffusers unet/config.json."""
    dtype = sample.dtype
    bo = list(cfg["block_out_channels"])
    n, lpb, groups = len(bo), cfg["layers_per_block"], cfg["norm_num_groups"]
    heads = _per_level(cfg["attention_head_dim"], n)
    depth = _per_level(cfg.get("transformer_layers_per_block", 1), n)
    linear = bool(cfg.get("use_linear_projection", False))
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]

    def transformer(p, x, level):
        return _transformer(sd, p, x, context, heads[level], depth[level], groups, linear)

    temb = _linear(sd, "time_embedding.linear_1", timestep_embedding(timesteps, bo[0], dtype=dtype))
    temb = _linear(sd, "time_embedding.linear_2", F.silu(temb))
    if cfg.get("addition_embed_type") == "text_time":
        ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"], dtype=dtype)
        added = torch.cat([text_embeds, ids.reshape(time_ids.shape[0], -1)], dim=-1)
        added = _linear(sd, "add_embedding.linear_1", added)
        temb = temb + _linear(sd, "add_embedding.linear_2", F.silu(added))

    x = _conv(sd, "conv_in", sample)
    skips = [x]
    for b in range(n):
        for i in range(lpb):
            x = _resnet(sd, f"down_blocks.{b}.resnets.{i}", x, temb, groups)
            if attn[b]:
                x = transformer(f"down_blocks.{b}.attentions.{i}", x, b)
            skips.append(x)
        if b != n - 1:
            x = _conv(sd, f"down_blocks.{b}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = _resnet(sd, "mid_block.resnets.0", x, temb, groups)
    x = transformer("mid_block.attentions.0", x, n - 1)
    x = _resnet(sd, "mid_block.resnets.1", x, temb, groups)
    for u, b in enumerate(reversed(range(n))):
        for i in range(lpb + 1):
            x = _resnet(sd, f"up_blocks.{u}.resnets.{i}", torch.cat([x, skips.pop()], dim=1),
                        temb, groups)
            if attn[b]:
                x = transformer(f"up_blocks.{u}.attentions.{i}", x, b)
        if b != 0:
            x = F.interpolate(x, size=skips[-1].shape[-2:], mode="nearest")
            x = _conv(sd, f"up_blocks.{u}.upsamplers.0.conv", x)
    x = F.silu(_gn(sd, "conv_norm_out", x, groups, 1e-5))
    return _conv(sd, "conv_out", x)


_ACT = {"quick_gelu": lambda h: h * torch.sigmoid(1.702 * h), "gelu": F.gelu}


@torch.no_grad()
def clip_hidden_states(sd: SD, cfg: T.Mapping[str, T.Any], ids: torch.Tensor,
                       eos_token_id: int) -> T.Tuple[T.List[torch.Tensor], T.Optional[torch.Tensor]]:
    """(every hidden state: the embeddings', then each layer's output, the
    last one without the final LayerNorm; the pooled output, or None without
    a text_projection) of token ids (B, L); `cfg` a transformers
    text config."""
    b, length = ids.shape
    heads, act = cfg["num_attention_heads"], _ACT[cfg.get("hidden_act", "quick_gelu")]
    tm = "text_model"
    x = (sd[f"{tm}.embeddings.token_embedding.weight"][ids]
         + sd[f"{tm}.embeddings.position_embedding.weight"][:length][None])
    mask = torch.full((length, length), float("-inf"), dtype=x.dtype, device=ids.device).triu(1)
    states = [x]
    for i in range(cfg["num_hidden_layers"]):
        p = f"{tm}.encoder.layers.{i}"
        h = _ln(sd, f"{p}.layer_norm1", x)
        q, k, v = (_linear(sd, f"{p}.self_attn.{n}_proj", h).reshape(b, length, heads, -1)
                   .transpose(1, 2) for n in "qkv")
        logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + mask
        attn = (logits.softmax(-1) @ v).transpose(1, 2).reshape(b, length, -1)
        x = x + _linear(sd, f"{p}.self_attn.out_proj", attn)
        x = x + _linear(sd, f"{p}.mlp.fc2", act(_linear(sd, f"{p}.mlp.fc1",
                                                        _ln(sd, f"{p}.layer_norm2", x))))
        states.append(x)
    if "text_projection.weight" not in sd:
        return states, None
    last = _ln(sd, f"{tm}.final_layer_norm", x)
    eos = (ids == eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(b, device=ids.device), eos]
    return states, F.linear(pooled, sd["text_projection.weight"])


def text_conditioning(first: SD, first_cfg, second: SD, second_cfg, ids: torch.Tensor,
                      eos_token_id: int, hidden: int = -2) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """(context (B, L, 768 + 1280): both towers' penultimate hidden states,
    pooled (B, projection): the second tower's). `hidden` picks another
    hidden state (-1: the last, a planted fault)."""
    states_1, _ = clip_hidden_states(first, first_cfg, ids, eos_token_id)
    states_2, pooled = clip_hidden_states(second, second_cfg, ids, eos_token_id)
    return torch.cat([states_1[hidden], states_2[hidden]], dim=-1), pooled


# ----------------------------------------------------------------- sampling


def euler_sigmas(steps: int, offset: int = 1) -> T.Tuple[np.ndarray, np.ndarray]:
    """(timesteps (steps,) descending, sigmas (steps + 1,) with a final 0) of
    EulerDiscreteScheduler at "leading" spacing."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    full = ((1 - acp) / acp) ** 0.5
    t = (np.arange(steps) * (1000 // steps) + offset)[::-1].astype(np.float64)
    return t, np.concatenate([np.interp(t, np.arange(1000), full), [0.0]])


def img2img_start(steps: int, strength: float, offset: int = 1) -> int:
    init_timestep = min(int(steps * strength) + offset, steps)
    return max(steps - init_timestep + offset, 0)


def slerp(t: float, v0: torch.Tensor, v1: torch.Tensor, threshold: float = 0.9995):
    """riffusion's seed-noise slerp, in float64."""
    a, b = v0.double(), v1.double()
    dot = float((a * b).sum() / (a.norm() * b.norm()))
    if abs(dot) > threshold:
        out = (1 - t) * a + t * b
    else:
        theta = np.arccos(dot)
        out = (np.sin(theta * (1 - t)) * a + np.sin(theta * t) * b) / np.sin(theta)
    return out.to(v0.dtype)


@torch.no_grad()
def riffuse_image(states: T.Mapping[str, SD], cfgs: T.Mapping[str, T.Any],
                  ids: T.Mapping[str, torch.Tensor], alpha: float, image: torch.Tensor,
                  draws: T.Mapping[str, torch.Tensor], steps: int, strength: float,
                  guidance: float, eos_token_id: int, hidden: int = -2) -> np.ndarray:
    """The uint8 image (H, W, 3) of one riffusion request on SDXL: `ids`
    "start" and "end" (1, 77), an empty negative prompt (zeros for the
    context and the pooled vector), `image` (1, 3, H, W) in [-1, 1], the
    request's draws ("vae_eps", "noise_a", "noise_b"), Euler at `steps`
    from riffusion's img2img start, classifier-free guidance at `guidance`,
    time ids (H, W, 0, 0, H, W). `states` and `cfgs` by model: unet, vae,
    text_encoder, text_encoder_2; `hidden` as text_conditioning's."""
    conds = [text_conditioning(states["text_encoder"], cfgs["text_encoder"],
                               states["text_encoder_2"], cfgs["text_encoder_2"], ids[k],
                               eos_token_id, hidden) for k in ("start", "end")]
    context = conds[0][0] + alpha * (conds[1][0] - conds[0][0])
    pooled = conds[0][1] + alpha * (conds[1][1] - conds[0][1])
    context = torch.cat([torch.zeros_like(context), context])
    pooled = torch.cat([torch.zeros_like(pooled), pooled])
    h, w = image.shape[-2:]
    time_ids = torch.tensor([[h, w, 0, 0, h, w]] * 2, dtype=image.dtype)
    vcfg = cfgs["vae"]
    mean, logvar = vae_encode_moments(states["vae"], image, vcfg["block_out_channels"],
                                      vcfg["layers_per_block"], vcfg["norm_num_groups"])
    scale = vcfg["scaling_factor"]
    latents = scale * (mean + torch.exp(0.5 * logvar) * draws["vae_eps"])
    noise = slerp(alpha, draws["noise_a"], draws["noise_b"])
    ts, sigmas = euler_sigmas(steps)
    start = img2img_start(steps, strength)
    latents = latents + noise * float(sigmas[start])
    for i in range(start, steps):
        x_in = latents / math.sqrt(sigmas[i] ** 2 + 1)
        eps_u, eps_t = unet_forward(states["unet"], cfgs["unet"], torch.cat([x_in, x_in]),
                                    torch.full((2,), float(ts[i])), context, pooled,
                                    time_ids).chunk(2)
        latents = latents + (eps_u + guidance * (eps_t - eps_u)) * float(sigmas[i + 1] - sigmas[i])
    decoded = vae_decode(states["vae"], latents / scale, vcfg["block_out_channels"],
                         vcfg["layers_per_block"], vcfg["norm_num_groups"])
    out = torch.round(torch.clamp(decoded[0] / 2 + 0.5, 0, 1).permute(1, 2, 0) * 255)
    return out.to(torch.uint8).numpy()
