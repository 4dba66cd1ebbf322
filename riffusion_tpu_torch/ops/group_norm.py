"""
GroupNorm over channels_last (NHWC) activations with SiLU optionally fused:
the hand-written Hopper kernel (csrc/group_norm.cu), its plain PyTorch
version, and the launch geometry.

`group_norm(x, weight, bias, num_groups, eps, silu=...)` normalises each
group of C/G adjacent channels of each image of a 4-D channels_last x, with
the statistics in fp32 (fp64 for fp64 tensors), applies the affine, rounds
to x's dtype and, with `silu`, applies SiLU in that dtype: what
models/layers.py GroupNorm followed by F.silu computes on an NCHW tensor.
The result is channels_last.

- For a CUDA tensor the wrapper launches the kernel (bf16 or fp32 x; gamma
  and beta bf16 or fp32), or raises. Nothing falls back.
- For a CPU tensor it runs `group_norm_reference`, the plain version:
  F.group_norm on x in precise(dtype), the cast back, F.silu.

No TPU kernel stands behind it: the JAX package's GroupNorm is plain jnp,
which XLA fuses in its NHWC layout. The kernel exists because the serving
UNet keeps NHWC on the card (models/unet.py), where torch's CUDA group_norm
makes its input NCHW-contiguous first.

`COUNTS.group_norm_launches` (ops.kernels.COUNTS) counts the kernel's
calls (two launches each: the statistics, then the normalisation),
`COUNTS.group_norm_plain_calls` the wrapper's calls that ran the plain
version. A replayed CUDA graph counts its calls again (aot.py), as it does
the attention kernels'. The kernel is built in the serving round
(ops.kernels.FORWARD_KERNELS), at its first use.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.nn.functional as F

from riffusion_tpu_torch.ops import kernels

__all__ = ["group_norm", "group_norm_reference", "compare_to_plain", "check_inputs", "tiling",
           "Tiling", "TOLERANCE"]

_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_PARAM_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

#: The threads a block aims at (R = TARGET_THREADS // (C / V) rows at once),
#: and the blocks per SM the grid aims at, in each of the two launches.
#: Chosen on an H100 with scripts/time_group_norm.py: of the pairs tried
#: (128 to 512 threads, 1 to 4 blocks an SM), (384, 1) gave the least
#: GroupNorm time over the UNet's 61 sites and the fastest UNet evaluation
#: (PERF.md section 6).
TARGET_THREADS = 384
BLOCKS_PER_SM = 1
_MAX_THREADS = 1024
_MAX_SMEM = 48 * 1024

# How closely the kernel must match its plain version on the same inputs,
# per dtype: (max abs error over the plain output's largest magnitude,
# error RMS over the plain output's RMS).
# - bf16: both round y, and with SiLU the SiLU of the rounded y, to bf16.
#   The statistics differ by their sum order (fp32, about 1e-6 of the
#   mean and the variance), which moves an output across a rounding
#   boundary now and then: one bf16 step, 2^-8 of its magnitude, and twice
#   that where SiLU rounds a second time. 2^-6 of the largest output passes
#   two steps at the largest values; an RMS of 1e-3 passes such flips on
#   one element in twenty. A group normalised with its neighbour's
#   statistics, or a chunk of rows left out of them, moves the output by a
#   tenth of its RMS or more on the checks' inputs (chip_smoke.py, whose
#   groups differ in mean and scale and whose rows drift).
# - fp32: the same arithmetic in another sum order.
TOLERANCE = {torch.bfloat16: (2.0**-6, 1e-3), torch.float32: (1e-5, 1e-6)}


@dataclasses.dataclass(frozen=True)
class Tiling:
    """The kernel's launch geometry for one input: `vec` elements a 16-byte
    load, `rows` spatial rows a block reads at once (rows x C/vec threads
    load, `threads` launched, a multiple of 32), `chunk` spatial rows a
    block covers and `chunks` blocks per image (the last chunk may be
    shorter); the grid is (chunks, batch) in both launches."""

    vec: int
    rows: int
    threads: int
    chunk: int
    chunks: int
    smem_bytes: int  # the statistics launch's shared memory


def tiling(batch: int, hw: int, channels: int, element_size: int, sms: int) -> Tiling:
    """The geometry for a (batch, H*W, channels) input of `element_size`
    bytes an element on a card of `sms` SMs: about BLOCKS_PER_SM blocks a
    SM over the batch, at least `rows` spatial rows each. Raises for a
    channel count no block can hold."""
    vec = 16 // element_size
    if channels % vec:
        raise ValueError(f"the kernel reads channels in 16-byte loads: {channels} channels "
                         f"are not a multiple of {vec}")
    vpr = channels // vec
    rows = max(1, min(TARGET_THREADS // vpr, hw))
    threads = -(-rows * vpr // 32) * 32
    smem = (2 * rows * channels + rows) * 4
    if threads > _MAX_THREADS or smem > _MAX_SMEM:
        raise ValueError(f"{channels} channels of {element_size} bytes do not fit one block")
    chunks = max(1, min(-(-BLOCKS_PER_SM * sms // batch), -(-hw // rows)))
    chunk = -(-hw // chunks)
    return Tiling(vec=vec, rows=rows, threads=threads, chunk=chunk, chunks=-(-hw // chunk),
                  smem_bytes=smem)


def group_norm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    silu: bool = False,
) -> torch.Tensor:
    """The plain version, models/layers.py GroupNorm's arithmetic: F.group_norm
    on x in precise(dtype) with the affine in that precision, rounded to
    x's dtype, then F.silu in x's dtype; returned channels_last."""
    p = torch.promote_types(torch.float32, x.dtype)
    y = F.group_norm(x.to(p), num_groups, weight.to(p), bias.to(p), eps).to(x.dtype)
    if silu:
        y = F.silu(y)
    return y.contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    """What the kernel reads: a CUDA 4-D channels_last bf16 or fp32 x with a
    16-byte aligned base and C a multiple of the groups; (C,) contiguous
    bf16 or fp32 gamma and beta on its device."""
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on cuda or cpu tensors, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the kernel takes a 4-D channels_last tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the kernel takes bfloat16 or float32, got {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("the kernel needs a 16-byte aligned base")
    channels = x.shape[1]
    if num_groups <= 0 or channels % num_groups:
        raise ValueError(f"{channels} channels do not split into {num_groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.shape != (channels,) or not p.is_contiguous() or p.device != x.device \
                or p.dtype not in _PARAM_DTYPES:
            raise ValueError(f"{name} must be a contiguous ({channels},) bfloat16 or float32 "
                             f"tensor on {x.device}, got {tuple(p.shape)} {p.dtype} {p.device}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"weight and bias dtypes differ: {weight.dtype}, {bias.dtype}")


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
            eps: float, silu: bool) -> torch.Tensor:
    """Both launches on the current stream into a new channels_last output;
    raises if either is refused."""
    _check(x, weight, bias, num_groups)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile = tiling(b, h * w, c, x.element_size(), sms)
    partials = torch.empty((3, b, num_groups, tile.chunks), dtype=torch.float32, device=x.device)
    rc = kernels.entry("group_norm")(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), partials.data_ptr(),
        b, h * w, c, num_groups, tile.rows, tile.chunk, tile.chunks, float(eps), int(silu),
        _KERNEL_DTYPES[x.dtype], _PARAM_DTYPES[weight.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"group_norm kernel launch failed with CUDA error {rc}")
    return out


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm (+ SiLU) of a 4-D channels_last x, channels_last out:
    csrc/group_norm.cu for CUDA tensors, `group_norm_reference` for CPU
    tensors. Not differentiable: models/layers.py takes it only where
    autograd records nothing."""
    if x.device.type == "cpu":
        kernels.COUNTS.group_norm_plain_calls += 1
        return group_norm_reference(x, weight, bias, num_groups, eps, silu)
    out = _launch(x, weight, bias, num_groups, eps, silu)
    kernels.COUNTS.group_norm_launches += 1
    return out


def check_inputs(
    batch: int, channels: int, h: int, w: int, dtype: torch.dtype, device: T.Any, seed: int,
    groups: int = 32,
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, gamma, beta) to hold the kernel to its plain version on: x
    channels_last, whose groups differ in mean (-1 to 1) and in scale (0.5
    to 2) and whose spatial rows drift by 4 from the first to the last, so
    that a group read with another's statistics, or statistics that miss
    a chunk of rows, show; gamma about 1 and beta about 0, in x's dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=gen, device=device)

    per = channels // groups
    mean = (rand(groups) * 2 - 1).repeat_interleave(per) + 0.1 * rand(channels)
    scale = (0.5 * 4.0 ** rand(groups)).repeat_interleave(per)
    drift = torch.linspace(0.0, 4.0, h * w, device=device).view(1, 1, h, w)
    x = torch.randn((batch, channels, h, w), generator=gen, device=device)
    x = (x * scale[:, None, None] + mean[:, None, None] + drift).to(dtype)
    gamma = (1 + 0.2 * torch.randn(channels, generator=gen, device=device)).to(dtype)
    beta = (0.2 * torch.randn(channels, generator=gen, device=device)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last), gamma, beta


def compare_to_plain(out: torch.Tensor, ref: torch.Tensor) -> T.Tuple[float, float, bool]:
    """(max abs error over the plain output's largest magnitude, error RMS
    over the plain output's RMS, within TOLERANCE) of a kernel output
    against the plain version's on the same inputs, in fp32."""
    err = out.float() - ref.float()
    scale = float(ref.float().abs().max())
    max_abs = float(err.abs().max()) / scale
    rel_rms = float(err.norm() / ref.float().norm())
    abs_tol, rel_tol = TOLERANCE[ref.dtype]
    ok = bool(torch.isfinite(out).all()) and max_abs <= abs_tol and rel_rms <= rel_tol
    return max_abs, rel_rms, ok
