"""
riffusion_tpu_torch — the PyTorch + CUDA port of riffusion_tpu for one NVIDIA
Hopper GPU (H100).

The JAX package `riffusion_tpu` stays the reference. This package keeps its
module paths, class names and parameter names so that each module's
counterpart is easy to find, and keeps the JAX layouts at its public
functions (images (1, H, W, 3) in [-1, 1], attention operands (b, s, h*d),
mel amplitudes (C, n_mels, F), training latents (B, H, W, C)) so that tests
compare like with like.

Plain tensor code is PyTorch (cuBLAS, cuDNN, cuFFT). The JAX package's
Pallas kernels, all of them UNet self-attention, are CUDA C++ kernels
written for sm_90a (`ops/attention.py` over `csrc/`, built and loaded by
`ops/kernels.py`): the flash attention forward and its two backward
kernels, and the full-row attention of the batched path.

This package never imports jax, flax or the JAX package: it keeps its own
copies of the host modules it shares with it.
"""

__version__ = "0.1.0"
