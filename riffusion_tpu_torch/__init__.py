"""
riffusion_tpu_torch — the PyTorch + CUDA port of riffusion_tpu for one NVIDIA
Hopper GPU (H100).

The JAX package `riffusion_tpu` stays the reference. This package keeps its
module paths, class names and parameter names so that each module's
counterpart is easy to find, and keeps the JAX layouts at its public
functions (images (1, H, W, 3) in [-1, 1], attention operands (b, s, h*d),
mel amplitudes (C, n_mels, F)) so that tests compare like with like.

Plain tensor code is PyTorch (cuBLAS, cuDNN, cuFFT). The one Pallas kernel
on the single-clip serving path, UNet self-attention, is a CUDA C++ kernel
written for sm_90a (`ops/attention.py`, `csrc/attention.cu`).

This package never imports jax or flax.
"""

__version__ = "0.1.0"
