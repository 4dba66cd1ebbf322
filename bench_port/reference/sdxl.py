"""
Plain PyTorch reference of Stable Diffusion XL base 1.0 for the benchmark:
the UNet and the two text towers as functions of diffusers / transformers
state dicts, the text conditioning, the shapes of those state dicts,
EulerDiscreteScheduler at "leading" spacing, and one served riffusion
request on SDXL end to end up to its image. The KL VAE, the CLIP primitives
and the products come from sd.py, so every product goes through its
`Numerics` (float32, or `Fp8Numerics` for the control); the request's
draws, its tokens and its audio tail from riffuse.py. A copy of
tests/torch_sdxl_reference.py, the repository's test oracle, through
Numerics. Nothing here imports the program under test.

* UNet2DConditionModel (unet/config.json): sd.py's v1 wiring with
  `attention_head_dim` one head count a level and
  `transformer_layers_per_block` one depth a level (the mid block takes the
  last level's, the up blocks their level's), linear proj_in / proj_out on
  the tokens (use_linear_projection), and the "text_time" added embedding:
  each of the six time ids as `addition_time_embed_dim` sinusoids, after the
  pooled text embedding, through add_embedding (linear, silu, linear),
  added to the time embedding.
* CLIPTextModel / CLIPTextModelWithProjection: sd.py's tower with the
  config's activation (quick_gelu for ViT-L/14, exact gelu for OpenCLIP
  ViT-bigG/14); the penultimate hidden state, and the pooled output: the
  final-LayerNormed last state at the end-of-text token through the
  bias-free text_projection.
* The conditioning: both towers' penultimate states side by side
  (768 + 1280), the second tower's pooled vector; an empty negative prompt
  is zeros for both (force_zeros_for_empty_prompt); time ids (H, W, 0, 0,
  H, W) of the seed image.
* EulerDiscreteScheduler: scaled-linear betas 0.00085-0.012, epsilon
  prediction, timesteps every 1000 // steps from steps_offset 1 ("leading"),
  sigmas interpolated linearly at them, the model input over
  sqrt(sigma^2 + 1), x += eps * (sigma_next - sigma); the img2img start
  x0 + sigma_start * noise.

Departures from the published description (choices of the configuration,
its `assumed`): the pooled position is the first end-of-text token id, not
transformers' legacy argmax of the ids (the hashing tokenizer's ids are not
BPE ids); both towers read the same ids; the img2img start is riffusion's
(init_timestep = int(steps * strength) + 1, capped at steps; start index
steps - init_timestep + 1), 37 steps of 50 at 0.75 as diffusers' SDXL
img2img runs; the pooled vector walks in alpha with the context.
"""

from __future__ import annotations

import math
import typing as T

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import riffuse, sampling, sd

SD = T.Mapping[str, torch.Tensor]


# ------------------------------------------------------------- state shapes


def _per_level(value, n: int) -> T.List[int]:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def _transformer_leaves(out, p: str, c: int, cross: int, depth: int, linear: bool) -> None:
    sd._norm_leaves(out, f"{p}.norm", c)
    for name in ("proj_in", "proj_out"):
        if linear:
            sd._linear_leaves(out, f"{p}.{name}", c, c)
        else:
            sd._conv_leaves(out, f"{p}.{name}", c, c, k=1)
    for d in range(depth):
        b = f"{p}.transformer_blocks.{d}"
        for i, ctx in ((1, c), (2, cross)):
            sd._norm_leaves(out, f"{b}.norm{i}", c)
            sd._linear_leaves(out, f"{b}.attn{i}.to_q", c, c, bias=False)
            sd._linear_leaves(out, f"{b}.attn{i}.to_k", ctx, c, bias=False)
            sd._linear_leaves(out, f"{b}.attn{i}.to_v", ctx, c, bias=False)
            sd._linear_leaves(out, f"{b}.attn{i}.to_out.0", c, c)
        sd._norm_leaves(out, f"{b}.norm3", c)
        sd._linear_leaves(out, f"{b}.ff.net.0.proj", c, 8 * c)
        sd._linear_leaves(out, f"{b}.ff.net.2", 4 * c, c)


def unet_leaves(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, sd.Leaf]:
    """SDXL's UNet2DConditionModel state dict: keys and shapes."""
    bo = list(cfg["block_out_channels"])
    n, lpb, cross = len(bo), cfg["layers_per_block"], cfg["cross_attention_dim"]
    depth = _per_level(cfg["transformer_layers_per_block"], n)
    linear = bool(cfg["use_linear_projection"])
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
    temb = 4 * bo[0]
    out: T.Dict[str, sd.Leaf] = {}
    sd._linear_leaves(out, "time_embedding.linear_1", bo[0], temb)
    sd._linear_leaves(out, "time_embedding.linear_2", temb, temb)
    sd._linear_leaves(out, "add_embedding.linear_1", cfg["projection_class_embeddings_input_dim"],
                      temb)
    sd._linear_leaves(out, "add_embedding.linear_2", temb, temb)
    sd._conv_leaves(out, "conv_in", cfg["in_channels"], bo[0])
    skips, c = [bo[0]], bo[0]
    for b, cout in enumerate(bo):
        for i in range(lpb):
            sd._resnet_leaves(out, f"down_blocks.{b}.resnets.{i}", c, cout, temb)
            c = cout
            if attn[b]:
                _transformer_leaves(out, f"down_blocks.{b}.attentions.{i}", c, cross, depth[b],
                                    linear)
            skips.append(c)
        if b != n - 1:
            sd._conv_leaves(out, f"down_blocks.{b}.downsamplers.0.conv", c, c)
            skips.append(c)
    sd._resnet_leaves(out, "mid_block.resnets.0", c, c, temb)
    _transformer_leaves(out, "mid_block.attentions.0", c, cross, depth[-1], linear)
    sd._resnet_leaves(out, "mid_block.resnets.1", c, c, temb)
    for u, b in enumerate(reversed(range(n))):
        for i in range(lpb + 1):
            sd._resnet_leaves(out, f"up_blocks.{u}.resnets.{i}", c + skips.pop(), bo[b], temb)
            c = bo[b]
            if attn[b]:
                _transformer_leaves(out, f"up_blocks.{u}.attentions.{i}", c, cross, depth[b],
                                    linear)
        if b != 0:
            sd._conv_leaves(out, f"up_blocks.{u}.upsamplers.0.conv", c, c)
    sd._norm_leaves(out, "conv_norm_out", c)
    sd._conv_leaves(out, "conv_out", c, cfg["out_channels"])
    return out


def clip_leaves(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, sd.Leaf]:
    """A text tower's state dict, with CLIPTextModelWithProjection's
    text_projection where the config names that architecture."""
    out = sd.clip_leaves(cfg)
    if "CLIPTextModelWithProjection" in cfg.get("architectures", ()):
        sd._linear_leaves(out, "text_projection", cfg["hidden_size"], cfg["projection_dim"],
                          bias=False)
    return out


# ---------------------------------------------------------------------- UNet


def _transformer(nx, w: SD, p: str, x, context, heads: int, depth: int, groups: int,
                 linear: bool):
    b, c, h, wd = x.shape
    y = sd._gn(w, f"{p}.norm", x, groups, 1e-6)
    if linear:
        y = sd._linear(nx, w, f"{p}.proj_in", y.permute(0, 2, 3, 1).reshape(b, h * wd, c))
    else:
        y = sd._conv(nx, w, f"{p}.proj_in", y, padding=0).permute(0, 2, 3, 1).reshape(b, h * wd, c)
    for i in range(depth):
        t = f"{p}.transformer_blocks.{i}"
        y = y + sd._attention(nx, w, f"{t}.attn1", sd._ln(w, f"{t}.norm1", y), None, heads)
        y = y + sd._attention(nx, w, f"{t}.attn2", sd._ln(w, f"{t}.norm2", y), context, heads)
        value, gate = sd._linear(nx, w, f"{t}.ff.net.0.proj", sd._ln(w, f"{t}.norm3", y)).chunk(2, -1)
        y = y + sd._linear(nx, w, f"{t}.ff.net.2", value * F.gelu(gate))
    if linear:
        y = sd._linear(nx, w, f"{p}.proj_out", y).reshape(b, h, wd, c).permute(0, 3, 1, 2)
    else:
        y = sd._conv(nx, w, f"{p}.proj_out", y.reshape(b, h, wd, c).permute(0, 3, 1, 2),
                     padding=0)
    return y + x


def unet(w: SD, cfg: T.Mapping[str, T.Any], sample, timesteps, context, text_embeds, time_ids,
         nx: sd.Numerics = sd.FP32):
    """eps (B, C, H, W) of `sample` at `timesteps` (B,) under `context`
    (B, L, cross_attention_dim), `text_embeds` (B, pooled) and `time_ids`
    (B, 6)."""
    bo = list(cfg["block_out_channels"])
    n, lpb, groups = len(bo), cfg["layers_per_block"], cfg["norm_num_groups"]
    heads = _per_level(cfg["attention_head_dim"], n)
    depth = _per_level(cfg["transformer_layers_per_block"], n)
    linear = bool(cfg["use_linear_projection"])
    attn = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]

    def transformer(p, x, level):
        return _transformer(nx, w, p, x, context, heads[level], depth[level], groups, linear)

    temb = sd._linear(nx, w, "time_embedding.linear_1", sd.timestep_embedding(timesteps, bo[0]))
    temb = sd._linear(nx, w, "time_embedding.linear_2", F.silu(temb))
    ids = sd.timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"])
    added = torch.cat([text_embeds.float(), ids.reshape(time_ids.shape[0], -1)], dim=-1)
    added = sd._linear(nx, w, "add_embedding.linear_1", added)
    temb = temb + sd._linear(nx, w, "add_embedding.linear_2", F.silu(added))

    x = sd._conv(nx, w, "conv_in", sample)
    skips = [x]
    for b in range(n):
        for i in range(lpb):
            x = sd._resnet(nx, w, f"down_blocks.{b}.resnets.{i}", x, temb, groups, 1e-5)
            if attn[b]:
                x = transformer(f"down_blocks.{b}.attentions.{i}", x, b)
            skips.append(x)
        if b != n - 1:
            x = sd._conv(nx, w, f"down_blocks.{b}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = sd._resnet(nx, w, "mid_block.resnets.0", x, temb, groups, 1e-5)
    x = transformer("mid_block.attentions.0", x, n - 1)
    x = sd._resnet(nx, w, "mid_block.resnets.1", x, temb, groups, 1e-5)
    for u, b in enumerate(reversed(range(n))):
        for i in range(lpb + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = sd._resnet(nx, w, f"up_blocks.{u}.resnets.{i}", x, temb, groups, 1e-5)
            if attn[b]:
                x = transformer(f"up_blocks.{u}.attentions.{i}", x, b)
        if b != 0:
            x = F.interpolate(x, size=skips[-1].shape[-2:], mode="nearest")
            x = sd._conv(nx, w, f"up_blocks.{u}.upsamplers.0.conv", x)
    x = F.silu(sd._gn(w, "conv_norm_out", x, groups, 1e-5))
    return sd._conv(nx, w, "conv_out", x)


# ----------------------------------------------------------------------- text


def tower(w: SD, cfg: T.Mapping[str, T.Any], ids: torch.Tensor, eos_token_id: int,
          nx: sd.Numerics = sd.FP32) -> T.Tuple[torch.Tensor, T.Optional[torch.Tensor]]:
    """(the penultimate hidden state (B, L, hidden), the pooled output
    (B, projection) or None without a text_projection) of ids (B, L)."""
    b, length = ids.shape
    heads = cfg["num_attention_heads"]
    act = F.gelu if cfg["hidden_act"] == "gelu" else (lambda h: h * torch.sigmoid(1.702 * h))
    tm = "text_model"
    x = (w[f"{tm}.embeddings.token_embedding.weight"][ids]
         + w[f"{tm}.embeddings.position_embedding.weight"][:length][None])
    mask = torch.full((length, length), float("-inf"), device=ids.device).triu(1)
    penultimate = x
    for i in range(cfg["num_hidden_layers"]):
        penultimate = x
        p = f"{tm}.encoder.layers.{i}"
        h = sd._ln(w, f"{p}.layer_norm1", x)
        q, k, v = (sd._linear(nx, w, f"{p}.self_attn.{n}_proj", h).reshape(b, length, heads, -1)
                   .transpose(1, 2) for n in "qkv")
        logits = nx.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]) + mask
        attn = nx.matmul(logits.softmax(-1), v).transpose(1, 2).reshape(b, length, -1)
        x = x + sd._linear(nx, w, f"{p}.self_attn.out_proj", attn)
        h = sd._linear(nx, w, f"{p}.mlp.fc1", sd._ln(w, f"{p}.layer_norm2", x))
        x = x + sd._linear(nx, w, f"{p}.mlp.fc2", act(h))
    if "text_projection.weight" not in w:
        return penultimate, None
    last = sd._ln(w, f"{tm}.final_layer_norm", x)
    eos = (ids == eos_token_id).int().argmax(dim=-1)
    pooled = last[torch.arange(b, device=ids.device), eos]
    return penultimate, nx.linear(pooled, w["text_projection.weight"])


class Weights(T.NamedTuple):
    """The four state dicts in float32, with the configuration."""

    unet: SD
    vae: SD
    text_encoder: SD
    text_encoder_2: SD
    config: T.Mapping[str, T.Any]


#: The hashing tokenizer's end-of-text id (riffuse.hash_tokens).
EOS = 1


def conditioning(w: Weights, text: str, nx: sd.Numerics = sd.FP32
                 ) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """(context (1, 77, 768 + 1280), pooled (1, 1280)) of a prompt."""
    device = next(iter(w.unet.values())).device
    cfg = w.config
    ids = torch.tensor([riffuse.hash_tokens(text, cfg["text_encoder"]["vocab_size"])],
                       device=device)
    first, _ = tower(w.text_encoder, cfg["text_encoder"], ids, EOS, nx)
    second, pooled = tower(w.text_encoder_2, cfg["text_encoder_2"], ids, EOS, nx)
    return torch.cat([first, second], dim=-1), pooled


# ----------------------------------------------------------------- sampling


def euler_sigmas(steps: int, offset: int = 1) -> T.Tuple[np.ndarray, np.ndarray]:
    """(timesteps (steps,) descending, sigmas (steps + 1,) with a final 0)
    of EulerDiscreteScheduler at "leading" spacing."""
    acp = sampling.alphas_cumprod()
    full = ((1 - acp) / acp) ** 0.5
    t = (np.arange(steps) * (sampling.NUM_TRAIN_TIMESTEPS // steps) + offset)[::-1]
    t = t.astype(np.float64)
    return t, np.concatenate([np.interp(t, np.arange(len(full)), full), [0.0]])


def tiled(seed_image: np.ndarray, tile: int) -> np.ndarray:
    """A seed image (H, W, 3) repeated `tile` times along time (width)."""
    return np.ascontiguousarray(np.tile(seed_image, (1, tile, 1)))


@torch.no_grad()
def image(w: Weights, request: T.Mapping[str, T.Any], seed_image: np.ndarray, steps: int = 50,
          unet_nx: sd.Numerics = sd.FP32, vae_nx: sd.Numerics = sd.FP32,
          vae_tf32: bool = False) -> np.ndarray:
    """The served spectrogram image (H, W, 3) uint8 of one request, a
    `/run_inference/` body, on the weights' device, under Euler at `steps`.
    `unet_nx` computes the UNet and both towers, `vae_nx` (with TF32 where
    `vae_tf32`) the VAE: the control's precisions."""
    device = next(iter(w.unet.values())).device
    start, end, alpha = request["start"], request["end"], float(request["alpha"])
    cfg = w.config
    vcfg = cfg["vae"]
    scale = vcfg["scaling_factor"]
    with riffuse.tf32(False):
        (c_start, p_start), (c_end, p_end) = (conditioning(w, start["prompt"], unet_nx),
                                              conditioning(w, end["prompt"], unet_nx))
        context = c_start + alpha * (c_end - c_start)
        pooled = p_start + alpha * (p_end - p_start)
        negative = start.get("negative_prompt") if alpha < 0.5 else end.get("negative_prompt")
        if negative:
            c_neg, p_neg = conditioning(w, negative, unet_nx)
        else:  # force_zeros_for_empty_prompt
            c_neg, p_neg = torch.zeros_like(context), torch.zeros_like(pooled)
        context, pooled = torch.cat([c_neg, context]), torch.cat([p_neg, pooled])
    guidance = start.get("guidance", 7.0) * (1.0 - alpha) + end.get("guidance", 7.0) * alpha
    strength = (1.0 - alpha) * start.get("denoising", 0.75) + alpha * end.get("denoising", 0.75)

    pixels = torch.from_numpy(seed_image.astype(np.float32) / 255.0 * 2.0 - 1.0)
    pixels = pixels.permute(2, 0, 1)[None].to(device)
    height, width = pixels.shape[2], pixels.shape[3]
    time_ids = torch.tensor([[height, width, 0, 0, height, width]] * 2, dtype=torch.float32,
                            device=device)
    shape = (1, vcfg["latent_channels"], height // 8, width // 8)
    eps = torch.randn(shape, generator=riffuse._gen(riffuse.derived_seed(start["seed"], 11), device),
                      device=device)
    with riffuse.tf32(vae_tf32):
        mean, logvar = sd.vae_encode_moments(w.vae, vcfg, pixels, vae_nx)
    latents = scale * (mean + torch.exp(0.5 * logvar) * eps)
    noise_a = torch.randn(shape, generator=riffuse._gen(start["seed"], device), device=device)
    noise_b = torch.randn(shape, generator=riffuse._gen(end["seed"], device), device=device)
    noise = sampling.slerp(alpha, noise_a, noise_b)

    ts, sigmas = euler_sigmas(steps)
    t_start, _ = sampling.img2img_start(steps, strength)
    with riffuse.tf32(False):
        latents = latents + noise * float(sigmas[t_start])
        for i in range(t_start, steps):
            x_in = latents / math.sqrt(sigmas[i] ** 2 + 1)
            e_u, e_t = unet(w.unet, cfg["unet"], torch.cat([x_in, x_in]),
                            torch.full((2,), float(ts[i]), device=device), context, pooled,
                            time_ids, unet_nx).chunk(2)
            latents = latents + (e_u + guidance * (e_t - e_u)) * float(sigmas[i + 1] - sigmas[i])
    with riffuse.tf32(vae_tf32):
        decoded = sd.vae_decode(w.vae, vcfg, latents / scale, vae_nx)
    out = torch.round(torch.clamp(decoded[0] / 2 + 0.5, 0, 1).permute(1, 2, 0) * 255)
    return out.to(torch.uint8).cpu().numpy()
