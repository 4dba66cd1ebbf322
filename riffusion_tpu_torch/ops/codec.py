"""
Spectrogram <-> uint8 image codec math on tensors.

The counterpart of riffusion_tpu/ops/codec.py (power curve, invert, Y-flip,
mono -> RGB / stereo -> (0, G, B) channel packing), so the VAE decode ->
audio path never round-trips through PIL.
"""

from __future__ import annotations

import torch


def quantize_image(spectrogram: torch.Tensor, power: float) -> torch.Tensor:
    """(C, F, T) magnitudes -> (C, F, T) uint8 codes (no flip/packing)."""
    data = spectrogram / torch.clamp(torch.max(spectrogram), min=1e-20)
    data = torch.pow(data, power)
    data = 255.0 - data * 255.0
    return torch.clamp(data, 0, 255).to(torch.uint8)


def spectrogram_from_codes(codes: torch.Tensor, power: float, max_value: float) -> torch.Tensor:
    """(C, F, T) uint8 codes -> (C, F, T) float32 magnitudes."""
    data = (255.0 - codes.to(torch.float32)) / 255.0
    data = torch.pow(data, 1.0 / power)
    return data * max_value


def rgb_image_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """(C, F, T) uint8 codes -> (F, T, 3) uint8 image, Y-flipped and packed."""
    c = codes.shape[0]
    if c == 1:
        rgb = codes.permute(1, 2, 0).repeat(1, 1, 3)
    elif c == 2:
        rgb = torch.stack([torch.zeros_like(codes[0]), codes[0], codes[1]], dim=-1)
    else:
        raise NotImplementedError(f"Unsupported number of channels: {c}")
    return torch.flip(rgb, dims=(0,))


def codes_from_rgb_image(image: torch.Tensor, stereo: bool) -> torch.Tensor:
    """(F, T, 3) uint8 image -> (C, F, T) uint8 codes (undo flip/packing)."""
    data = torch.flip(image, dims=(0,)).permute(2, 0, 1)
    return data[1:3] if stereo else data[0:1]


def image_u8_from_vae_output(decoded: torch.Tensor) -> torch.Tensor:
    """VAE decoder output in [-1, 1], NCHW (1, 3, F, T) -> (F, T, 3) uint8,
    the rounding of the reference's numpy -> PIL conversion."""
    img01 = torch.clamp(decoded[0] / 2.0 + 0.5, 0.0, 1.0)
    return torch.round(img01.permute(1, 2, 0) * 255.0).to(torch.uint8)


def codes_from_vae_output(decoded: torch.Tensor, stereo: bool) -> torch.Tensor:
    """VAE decoder output in [-1, 1], NCHW (1, 3, F, T) -> (C, F, T) uint8
    codes."""
    return codes_from_rgb_image(image_u8_from_vae_output(decoded), stereo=stereo)
