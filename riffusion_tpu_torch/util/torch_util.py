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

import typing as T

import torch


def check_device(device: str) -> torch.device:
    """Resolve "cuda", "cuda:N" or "cpu" to a torch.device, or raise.
    "cuda" is this process's current card: cuda:0 unless the process chose
    another (parallel.mesh.init_distributed gives each rank of a host its
    own, as torchrun's LOCAL_RANK says)."""
    name = str(device).lower()
    if name.startswith("cpu"):
        return torch.device("cpu")
    if name.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was requested but torch sees no CUDA device"
            )
        index = name.split(":", 1)[1] if ":" in name else torch.cuda.current_device()
        return torch.device(f"cuda:{int(index)}")
    raise ValueError(f"unknown device {device!r}: use 'cuda', 'cuda:N' or 'cpu'")


def configure_numerics() -> None:
    """The port's one place for the float32 matmul policy on the card.

    Both TF32 switches are off, so every float32 product on the card, the
    VAE's convolutions and the DSP's matmuls, runs in full float32. That is
    stricter than the JAX package on its TPU. There only the mel and
    inverse-mel einsums (riffusion_tpu/spectrogram_converter.py:124, :137)
    and Griffin-Lim's final synthesis (ops/griffin_lim.py:98) run at HIGHEST
    precision. The VAE's convolutions set no precision, and Griffin-Lim's
    loop takes gl_precision="default": both run at DEFAULT, bf16 passes on
    the TPU. Whether the VAE holds its band in TF32 on the card is not yet
    measured (ROADMAP Queue 3), so the switches stay off. cuDNN would
    otherwise run float32 convolutions in TF32 by default. The UNet and
    CLIP run in bfloat16 and are not affected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def slerp(
    t: T.Union[float, torch.Tensor], v0: torch.Tensor, v1: torch.Tensor,
    dot_threshold: float = 0.9995, one_minus_t: T.Union[float, torch.Tensor, None] = None,
) -> torch.Tensor:
    """Spherical interpolation between two tensors, with a lerp where they
    are nearly parallel (jax_util.slerp). `t` may be a 0-dim float32 tensor
    (an input of a captured program); `one_minus_t`, 1 - t, defaults to
    that difference, and a caller with a tensor `t` passes it as the float32
    rounding of the float64 difference, which is what a float `t` gives."""
    if one_minus_t is None:
        one_minus_t = 1.0 - t
    norm = torch.linalg.vector_norm(v0) * torch.linalg.vector_norm(v1)
    dot = torch.sum(v0 * v1) / torch.clamp(norm, min=1e-20)
    lerp = one_minus_t * v0 + t * v1

    theta_0 = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta_0 = torch.sin(theta_0)
    theta_t = theta_0 * t
    safe_sin = torch.where(torch.abs(sin_theta_0) < 1e-12, torch.ones_like(sin_theta_0), sin_theta_0)
    s0 = torch.sin(theta_0 - theta_t) / safe_sin
    s1 = torch.sin(theta_t) / safe_sin
    slerped = s0 * v0 + s1 * v1
    return torch.where(torch.abs(dot) > dot_threshold, lerp, slerped)
