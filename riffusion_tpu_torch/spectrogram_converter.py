"""
Audio <-> mel-spectrogram conversion on tensors.

The counterpart of riffusion_tpu/spectrogram_converter.py:

  forward:  waveform -> band-restricted STFT magnitudes -> mel projection
  inverse:  mel -> closed-form inverse-mel matmul -> Griffin-Lim -> iSTFT

All of it runs in float32 on the converter's device (the TF32 switches are
set off by torch_util.configure_numerics, so the mel matmuls are full fp32
on the card, as the JAX package runs them at HIGHEST precision).
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.ops.griffin_lim import griffin_lim
from riffusion_tpu_torch.ops.mel import active_bin_count, inverse_mel_operator, mel_filterbank
from riffusion_tpu_torch.ops.stft import get_stft_kernel
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import audio_util, torch_util


class SpectrogramConverter:
    """Convert between audio and (channels, n_mels, frames) mel amplitudes."""

    def __init__(self, params: SpectrogramParams, device: str = "cuda"):
        self.p = params
        self.device = torch_util.check_device(device)
        if self.device.type == "cuda":
            torch_util.configure_numerics()

        n_freqs = params.n_fft // 2 + 1
        fb = mel_filterbank(
            n_freqs=n_freqs,
            f_min=float(params.min_frequency),
            f_max=float(params.max_frequency),
            n_mels=params.num_frequencies,
            sample_rate=params.sample_rate,
            norm=params.mel_scale_norm,
            mel_scale=params.mel_scale_type,
        )
        self.n_active = active_bin_count(fb)
        inv_mel = inverse_mel_operator(
            n_freqs=n_freqs,
            f_min=float(params.min_frequency),
            f_max=float(params.max_frequency),
            n_mels=params.num_frequencies,
            sample_rate=params.sample_rate,
            norm=params.mel_scale_norm,
            mel_scale=params.mel_scale_type,
            n_active=self.n_active,
        )
        self.kernel = get_stft_kernel(
            params.n_fft, params.win_length, params.hop_length, self.n_active
        )
        self._fb = torch.from_numpy(np.ascontiguousarray(fb[: self.n_active])).to(self.device)
        self._inv_mel = torch.from_numpy(inv_mel).to(self.device)

    # ------------------------------------------------------------- tensor API

    def mel_amplitudes_from_waveform(self, waveform: torch.Tensor) -> torch.Tensor:
        """(C, L) -> (C, n_mels, F) mel amplitudes."""
        amplitudes = self.kernel.magnitude(waveform.to(self.device))  # (C, n_active, F)
        return torch.einsum("fm,bft->bmt", self._fb, amplitudes)

    def waveform_from_mel_amplitudes(
        self,
        amplitudes_mel: torch.Tensor,
        init_real: T.Optional[torch.Tensor] = None,
        init_imag: T.Optional[torch.Tensor] = None,
        generator: T.Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(C, n_mels, F) -> (C, samples). The Griffin-Lim initial phase is
        `init_real` / `init_imag`, uniform draws of shape (C, n_active, F),
        or drawn from `generator` when they are not given."""
        linear = torch.einsum(
            "fm,bmt->bft", self._inv_mel, amplitudes_mel.to(self.device, torch.float32)
        )
        linear = torch.clamp(linear, min=0.0)
        return griffin_lim(
            linear,
            self.kernel,
            n_iters=self.p.num_griffin_lim_iters,
            momentum=0.99,
            init_real=init_real,
            init_imag=init_imag,
            generator=generator,
        )

    # -------------------------------------------------------------- host API

    def spectrogram_from_audio(self, audio: AudioSegment) -> np.ndarray:
        """Audio segment -> (channels, frequency, time) mel amplitudes."""
        if int(audio.frame_rate) != self.p.sample_rate:
            raise ValueError("Audio sample rate must match params")
        waveform = torch.from_numpy(audio.raw_data.T.astype(np.float32))
        return self.mel_amplitudes_from_waveform(waveform).cpu().numpy()

    def audio_from_spectrogram(
        self, spectrogram: np.ndarray, apply_filters: bool = True, seed: int = 0
    ) -> AudioSegment:
        """(channels, frequency, time) mel amplitudes -> audio segment."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        waveform = self.waveform_from_mel_amplitudes(
            torch.as_tensor(np.asarray(spectrogram, dtype=np.float32)), generator=generator
        )
        segment = audio_util.audio_from_waveform(
            samples=waveform.cpu().numpy(), sample_rate=self.p.sample_rate, normalize=True
        )
        if apply_filters:
            segment = audio_util.apply_filters(segment, compression=False)
        return segment
