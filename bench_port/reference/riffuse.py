"""
Plain reference of one served riffusion request (`POST /run_inference/`):
the prompts' tokens and CLIP embeddings, the VAE encode of the seed image
and its posterior sample, the slerp of the two seed noises, the img2img
start, the classifier-free-guided denoise loop, the VAE decode to a uint8
image, and the audio tail (dsp.py).

A request's random draws are defined by its two seeds, as the served
program documents them (its GeneratorNoise): the seed noises from torch
Generators seeded with each seed, the VAE's eps and the Griffin-Lim phase
from generators seeded by `derived_seed(start seed, 11)` and
`derived_seed(start seed, 7)`, all on the device the request runs on. The
reference draws them again by that rule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import typing as T

import numpy as np
import torch

from bench_port.reference import dsp, sampling, sd


def derived_seed(seed: int, salt: int) -> int:
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, salt]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def hash_tokens(text: str, vocab_size: int, length: int = 77) -> T.List[int]:
    """The random-weight checkpoint's tokenizer: each lower-cased word's
    FNV-1a hash into [2, vocab), between BOS 0 and EOS 1, EOS-padded to
    `length` (no real CLIP vocabulary is in the repository)."""
    ids = []
    for word in re.sub(r"\s+", " ", text).strip().lower().split(" "):
        if word:
            h = 2166136261
            for ch in word.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(2 + h % (vocab_size - 2))
    ids = [0] + ids[:length - 2] + [1]
    return ids + [1] * (length - len(ids))


@dataclasses.dataclass
class Weights:
    """The three state dicts in float32, with their configurations."""

    unet: T.Mapping[str, torch.Tensor]
    vae: T.Mapping[str, torch.Tensor]
    clip: T.Mapping[str, torch.Tensor]
    config: T.Mapping[str, T.Any]


def embed(w: Weights, text: str, nx: sd.Numerics) -> torch.Tensor:
    cfg = w.config["text_encoder"]
    device = next(iter(w.clip.values())).device
    ids = torch.tensor([hash_tokens(text, cfg["vocab_size"])], device=device)
    return sd.clip_text(w.clip, cfg, ids, nx)


@contextlib.contextmanager
def tf32(on: bool) -> T.Iterator[None]:
    """TF32 products on the card inside the block (the reference's own
    float32 runs with it off)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def image(w: Weights, request: T.Mapping[str, T.Any], seed_image: np.ndarray,
          steps: int = 50, unet_nx: sd.Numerics = sd.FP32,
          vae_nx: sd.Numerics = sd.FP32, vae_tf32: bool = False) -> np.ndarray:
    """The served spectrogram image (H, W, 3) uint8 of one request, a
    `/run_inference/` body, on the weights' device, under PNDM at `steps`
    (the checkpoint's scheduler). `unet_nx` computes
    the UNet and CLIP, `vae_nx` (with TF32 where `vae_tf32`) the VAE: the
    control's precisions."""
    device = next(iter(w.unet.values())).device
    start, end, alpha = request["start"], request["end"], float(request["alpha"])
    ucfg, vcfg = w.config["unet"], w.config["vae"]
    scale = vcfg["scaling_factor"]
    with tf32(False):
        e_start, e_end = embed(w, start["prompt"], unet_nx), embed(w, end["prompt"], unet_nx)
        negative = start.get("negative_prompt") if alpha < 0.5 else end.get("negative_prompt")
        cond = e_start + alpha * (e_end - e_start)
        context = torch.cat([embed(w, negative or "", unet_nx), cond])
    guidance = start.get("guidance", 7.0) * (1.0 - alpha) + end.get("guidance", 7.0) * alpha
    strength = (1.0 - alpha) * start.get("denoising", 0.75) + alpha * end.get("denoising", 0.75)

    pixels = torch.from_numpy(seed_image.astype(np.float32) / 255.0 * 2.0 - 1.0)
    pixels = pixels.permute(2, 0, 1)[None].to(device)
    shape = (1, vcfg["latent_channels"], pixels.shape[2] // 8, pixels.shape[3] // 8)
    eps = torch.randn(shape, generator=_gen(derived_seed(start["seed"], 11), device),
                      device=device)
    with tf32(vae_tf32):
        mean, logvar = sd.vae_encode_moments(w.vae, vcfg, pixels, vae_nx)
    init = scale * (mean + torch.exp(0.5 * logvar) * eps)

    noise_a = torch.randn(shape, generator=_gen(start["seed"], device), device=device)
    noise_b = torch.randn(shape, generator=_gen(end["seed"], device), device=device)
    noise = sampling.slerp(alpha, noise_a, noise_b)

    def eps(latents: torch.Tensor, t: int) -> torch.Tensor:
        ts = torch.full((2,), t, device=device)
        e_u, e_t = sd.unet(w.unet, ucfg, torch.cat([latents, latents]), ts, context,
                           unet_nx).chunk(2)
        return e_u + guidance * (e_t - e_u)

    with tf32(False):
        sched = sampling.PNDM(steps)
        t_start, init_timestep = sampling.img2img_start(steps, strength)
        latents = sampling.add_noise(init, noise, int(sched.timesteps[-init_timestep]))
        for t in sched.timesteps[t_start:]:
            latents = sched.step(eps(latents, int(t)), int(t), latents)
    with tf32(vae_tf32):
        decoded = sd.vae_decode(w.vae, vcfg, latents / scale, vae_nx)
    out = torch.round(torch.clamp(decoded[0] / 2 + 0.5, 0, 1).permute(1, 2, 0) * 255)
    return out.to(torch.uint8).cpu().numpy()


@torch.no_grad()
def audio(image_u8: np.ndarray, request: T.Mapping[str, T.Any], device,
          dsp_tf32: bool = False) -> np.ndarray:
    """The served clip's samples (L,) int16 from its spectrogram image, after
    riffusion's filters, with the request's Griffin-Lim phase draws."""
    height, width = image_u8.shape[:2]
    geo = dsp.Geometry(n_mels=height - height % 32)
    gl = _gen(derived_seed(request["start"]["seed"], 7), device)
    shape = (1, dsp.phase_bins(geo), width)
    real = torch.rand(shape, generator=gl, device=device)
    imag = torch.rand(shape, generator=gl, device=device)
    with tf32(dsp_tf32):
        samples = dsp.audio_from_image(torch.from_numpy(np.array(image_u8)).to(device), real, imag,
                                       geo)
    return dsp.served_filters(samples.cpu().numpy()[0])
