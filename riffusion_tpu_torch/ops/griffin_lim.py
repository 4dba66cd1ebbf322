"""
Griffin-Lim phase reconstruction, a rolled Python loop over torch ops.

The counterpart of riffusion_tpu/ops/griffin_lim.py: fast Griffin-Lim with
momentum m applied as m/(1+m), a uniform random complex phase init that is
normalized to unit modulus, power-1 magnitudes, and a final synthesis from
the last phase estimate.

The initial phase is an argument (`init_real`, `init_imag`) so that a test
can hand this function the exact uniform draws the JAX program made; when
it is not given, it is drawn from `generator`.
"""

from __future__ import annotations

import typing as T

import torch

from riffusion_tpu_torch.ops.stft import STFTKernel


def griffin_lim(
    magnitudes: torch.Tensor,
    kernel: STFTKernel,
    n_iters: int = 32,
    momentum: float = 0.99,
    init_real: T.Optional[torch.Tensor] = None,
    init_imag: T.Optional[torch.Tensor] = None,
    generator: T.Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reconstruct a waveform from (B, n_bins, F) linear magnitudes.

    `init_real` / `init_imag` are uniform [0, 1) draws of the magnitudes'
    shape (normalized here, as in the JAX function). Returns (B, (F-1)*hop)
    float32.
    """
    mag = magnitudes.to(torch.float32)
    if (init_real is None) != (init_imag is None):
        raise ValueError("pass both init_real and init_imag, or neither")
    if init_real is None:
        init_real = torch.rand(mag.shape, generator=generator, device=mag.device)
        init_imag = torch.rand(mag.shape, generator=generator, device=mag.device)
    assert init_imag is not None
    if init_real.shape != mag.shape or init_imag.shape != mag.shape:
        raise ValueError(
            f"initial phase shape {tuple(init_real.shape)} != magnitudes {tuple(mag.shape)}"
        )
    ar = init_real.to(mag.device, torch.float32)
    ai = init_imag.to(mag.device, torch.float32)
    norm = torch.sqrt(ar * ar + ai * ai) + 1e-16
    ar, ai = ar / norm, ai / norm

    mom = momentum / (1.0 + momentum) if momentum > 0 else 0.0
    tr = torch.zeros_like(mag)
    ti = torch.zeros_like(mag)
    for _ in range(n_iters):
        wav = kernel.istft(mag * ar, mag * ai)
        rr, ri = kernel.stft(wav)
        ur = rr - mom * tr
        ui = ri - mom * ti
        un = torch.sqrt(ur * ur + ui * ui) + 1e-16
        ar, ai, tr, ti = ur / un, ui / un, rr, ri
    return kernel.istft(mag * ar, mag * ai)
