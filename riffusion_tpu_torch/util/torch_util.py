"""
Device selection and small tensor helpers.

`check_device` is the port's counterpart of riffusion_tpu/util/jax_util.py
`check_device`, with a stricter contract: a device string names exactly one
device. "cuda" without a CUDA device raises; the CPU is used only
when it is asked for. Nothing falls back silently, so a run that was meant
for the card can never carry on on the host.

`slerp` is jax_util.slerp on tensors.
"""

from __future__ import annotations

import torch


def check_device(device: str) -> torch.device:
    """Resolve "cuda", "cuda:N" or "cpu" to a torch.device, or raise."""
    name = str(device).lower()
    if name.startswith("cpu"):
        return torch.device("cpu")
    if name.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was requested but torch sees no CUDA device"
            )
        index = name.split(":", 1)[1] if ":" in name else "0"
        return torch.device(f"cuda:{int(index)}")
    raise ValueError(f"unknown device {device!r}: use 'cuda', 'cuda:N' or 'cpu'")


def configure_numerics() -> None:
    """The port's one place for the float32 matmul policy on the card.

    Both TF32 switches are off: the VAE and the DSP (STFT, mel, Griffin-Lim)
    run in full float32, as the JAX package runs them at HIGHEST precision.
    cuDNN would otherwise run float32 convolutions in TF32 by default. The
    UNet and CLIP run in bfloat16 and are not affected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def slerp(
    t: float, v0: torch.Tensor, v1: torch.Tensor, dot_threshold: float = 0.9995
) -> torch.Tensor:
    """Spherical interpolation between two tensors, with a lerp where they
    are nearly parallel (jax_util.slerp)."""
    norm = torch.linalg.vector_norm(v0) * torch.linalg.vector_norm(v1)
    dot = torch.sum(v0 * v1) / torch.clamp(norm, min=1e-20)
    lerp = (1.0 - t) * v0 + t * v1

    theta_0 = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta_0 = torch.sin(theta_0)
    theta_t = theta_0 * t
    safe_sin = torch.where(torch.abs(sin_theta_0) < 1e-12, torch.ones_like(sin_theta_0), sin_theta_0)
    s0 = torch.sin(theta_0 - theta_t) / safe_sin
    s1 = torch.sin(theta_t) / safe_sin
    slerped = s0 * v0 + s1 * v1
    return torch.where(torch.abs(dot) > dot_threshold, lerp, slerped)
