"""
STFT / iSTFT on torch.fft, band-restricted.

The counterpart of riffusion_tpu/ops/stft.py with its `fft` backend (the
matmul-DFT backend there was a design for the TPU's matrix unit and is not
ported). Semantics match torch.stft / torch.istft as the reference riffusion
configures them: centered frames with reflect padding, a periodic Hann
window of `win_length` zero-padded to `n_fft` (its support starts at
`(n_fft - win_length) // 2` inside the frame), hop `hop_length`, one-sided
spectrum, no normalization.

Only the lowest `n_bins` frequency bins are returned by `stft` and read by
`istft` (bins above are treated as exactly zero). The mel filterbank is zero
above `max_frequency`, so this restriction is exact on the serving path.

n_fft = 17640 at the default geometry is not a power of two
(2^3 * 3^2 * 5 * 7^2); cuFFT and pocketfft both take it as a mixed-radix
transform.

The window and the overlap-add envelope go to a device once per kernel,
device (and frame count) and stay with the kernel, so Griffin-Lim's
iterations copy nothing from the host and a captured CUDA graph
(riffusion_tpu_torch/aot.py) reads them where it was captured.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as T

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


@dataclasses.dataclass(frozen=True)
class STFTKernel:
    """One STFT geometry. Construct through `get_stft_kernel` (cached)."""

    n_fft: int
    win_length: int
    hop_length: int
    n_bins: int  # number of (lowest) frequency bins computed / consumed
    # the constants on each device, made on first use and kept
    _device: T.Dict[T.Tuple, torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False)

    @property
    def _offset(self) -> int:
        """Start of the window support inside the zero-padded n_fft frame."""
        return (self.n_fft - self.win_length) // 2

    @functools.cached_property
    def _window_np(self) -> np.ndarray:
        return hann_window(self.win_length).astype(np.float32)

    def _on_device(self, key: T.Tuple, make: T.Callable[[], np.ndarray],
                   device: torch.device) -> torch.Tensor:
        """make() uploaded to `device` once; the first upload stays."""
        key = key + (torch.device(device),)
        if key not in self._device:
            self._device.setdefault(key, torch.from_numpy(make()).to(device))
        return self._device[key]

    def window(self, device: torch.device) -> torch.Tensor:
        return self._on_device(("window",), lambda: self._window_np, device)

    def ola_envelope(self, n_frames: int, device: torch.device) -> torch.Tensor:
        """The overlap-add envelope of `n_frames` frames on `device`."""
        return self._on_device(("ola", n_frames), lambda: self._ola_envelope(n_frames), device)

    def num_frames(self, num_samples: int) -> int:
        pad = self.n_fft // 2
        return 1 + (num_samples + 2 * pad - self.n_fft) // self.hop_length

    def num_output_samples(self, n_frames: int) -> int:
        """istft(length=None) output length (torch semantics, even n_fft)."""
        return (n_frames - 1) * self.hop_length

    @functools.lru_cache(maxsize=8)
    def _ola_envelope(self, n_frames: int) -> np.ndarray:
        """Sum of squared windows over the overlap-add region."""
        hop, win = self.hop_length, self.win_length
        w2 = hann_window(win) ** 2
        env = np.zeros((n_frames - 1) * hop + win)
        for i in range(n_frames):
            env[i * hop : i * hop + win] += w2
        return np.maximum(env, 1e-11).astype(np.float32)

    def _frames(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, F, win_length): the window-support samples of each
        centered, reflect-padded frame (not yet windowed)."""
        pad = self.n_fft // 2
        x = F.pad(waveform[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
        f = self.num_frames(waveform.shape[-1])
        off = self._offset
        region = x[:, off : off + (f - 1) * self.hop_length + self.win_length]
        return region.unfold(-1, self.win_length, self.hop_length)

    def stft(self, waveform: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """(B, L) float32 -> (real, imag), each (B, n_bins, F)."""
        frames = self._frames(waveform.to(torch.float32)) * self.window(waveform.device)
        off = self._offset
        full = F.pad(frames, (off, self.n_fft - self.win_length - off))
        spec = torch.fft.rfft(full, n=self.n_fft, dim=-1)[..., : self.n_bins]
        spec = spec.transpose(1, 2)
        return spec.real.contiguous(), spec.imag.contiguous()

    def magnitude(self, waveform: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, n_bins, F) spectrogram magnitudes."""
        real, imag = self.stft(waveform)
        return torch.sqrt(real * real + imag * imag)

    def istft(self, real: torch.Tensor, imag: torch.Tensor) -> torch.Tensor:
        """(B, n_bins, F) x2 -> (B, (F-1)*hop) waveform (torch.istft with
        center=True, length=None). Bins above n_bins are exactly zero."""
        b, _, n_frames = real.shape
        full_bins = self.n_fft // 2 + 1
        spec = torch.complex(real, imag).transpose(1, 2)
        spec = F.pad(spec, (0, full_bins - self.n_bins))
        frames_full = torch.fft.irfft(spec, n=self.n_fft, dim=-1)
        off = self._offset
        frames = frames_full[..., off : off + self.win_length] * self.window(real.device)
        out_len = (n_frames - 1) * self.hop_length + self.win_length
        y = F.fold(
            frames.transpose(1, 2),
            output_size=(1, out_len),
            kernel_size=(1, self.win_length),
            stride=(1, self.hop_length),
        ).reshape(b, out_len)
        y = y / self.ola_envelope(n_frames, y.device)
        trim = self.n_fft // 2 - off
        return y[:, trim : trim + self.num_output_samples(n_frames)]


@functools.lru_cache(maxsize=32)
def get_stft_kernel(
    n_fft: int, win_length: int, hop_length: int, n_bins: T.Optional[int] = None
) -> STFTKernel:
    """Build (cached) an STFTKernel; `n_bins=None` is the full one-sided
    spectrum."""
    if n_bins is None:
        n_bins = n_fft // 2 + 1
    return STFTKernel(n_fft=n_fft, win_length=win_length, hop_length=hop_length, n_bins=n_bins)
