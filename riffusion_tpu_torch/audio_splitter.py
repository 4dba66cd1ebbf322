"""
Stem separation: the counterpart of riffusion_tpu/audio_splitter.py.

`split_audio` shells out to a demucs executable when one is installed
(`--device cuda` for a card, `cpu` for the CPU); otherwise it runs the
in-process `AudioSplitter`: frequency and stereo-heuristic masks that split
a segment into drums/bass/vocals/other, far below demucs quality but free of
dependencies. The STFT and the inverse STFT run on the splitter's device
with the port's ops/stft.py; the masks are numpy on the host, as in the JAX
package.
"""

from __future__ import annotations

import shutil
import subprocess
import typing as T
from pathlib import Path

import numpy as np

from riffusion_tpu_torch.audio.segment import AudioSegment

STEM_NAMES = ["drums", "bass", "vocals", "other", "guitar", "piano"]


def _demucs_path() -> T.Optional[str]:
    return shutil.which("demucs")


def split_audio(
    audio_path: T.Union[str, Path],
    output_dir: T.Union[str, Path],
    model: str = "htdemucs_6s",
    device: str = "cuda",
    jobs: int = 4,
) -> T.List[Path]:
    """Split an audio file into stems; returns the stem file paths.

    Uses the demucs command line when it is installed; otherwise the
    in-process splitter with 4 stems.
    """
    from riffusion_tpu_torch.util import torch_util

    audio_path = Path(audio_path)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    demucs = _demucs_path()
    if demucs is not None:
        demucs_device = "cuda" if torch_util.check_device(device).type == "cuda" else "cpu"
        subprocess.run(
            [
                demucs, str(audio_path),
                "--name", model,
                "--out", str(output_dir),
                "--jobs", str(jobs),
                "--device", demucs_device,
            ],
            check=True,
            capture_output=True,
        )
        stem_dir = output_dir / model / audio_path.stem
        return sorted(stem_dir.glob("*.wav"))

    splitter = AudioSplitter(device=device)
    segment = AudioSegment.from_file(audio_path)
    stems = splitter.split(segment)
    paths = []
    for name, stem in stems.items():
        path = output_dir / f"{name}.wav"
        stem.export(path, format="wav")
        paths.append(path)
    return sorted(paths)


class AudioSplitter:
    """In-process heuristic stem splitter (drums/bass/vocals/other).

    Spectral-mask separation: bass = low band, drums = transient
    (spectral-flux-gated) content, vocals = mid band of the stereo-center
    signal, other = residual. The masks are soft and sum to 1, so the stems
    mix back to the original.
    """

    def __init__(self, device: str = "cuda"):
        self.device = device

    def split(self, segment: AudioSegment) -> T.Dict[str, AudioSegment]:
        import torch

        from riffusion_tpu_torch.ops.stft import get_stft_kernel
        from riffusion_tpu_torch.util import torch_util

        dev = torch_util.check_device(self.device)
        sr = segment.frame_rate
        n_fft, hop = 2048, 512
        kernel = get_stft_kernel(n_fft, n_fft, hop)

        wave = segment.raw_data.T.astype(np.float32) / 32768.0  # (C, L)
        with torch.inference_mode():
            real_t, imag_t = kernel.stft(torch.from_numpy(wave).to(dev))
        real, imag = real_t.cpu().numpy(), imag_t.cpu().numpy()
        mag = np.sqrt(real**2 + imag**2) + 1e-9

        freqs = np.linspace(0, sr / 2, kernel.n_bins)[None, :, None]

        # band masks
        bass_mask = 1.0 / (1.0 + np.exp((freqs - 180.0) / 40.0))
        vocal_band = 1.0 / (1.0 + np.exp((freqs - 4000.0) / 600.0)) - 1.0 / (
            1.0 + np.exp((freqs - 200.0) / 50.0)
        )
        vocal_band = np.clip(vocal_band, 0, 1)

        # transient mask from positive spectral flux
        flux = np.maximum(np.diff(mag, axis=-1, prepend=mag[..., :1]), 0.0)
        flux_norm = flux / (np.quantile(flux, 0.98) + 1e-9)
        drum_mask = np.clip(flux_norm, 0, 1) * (1.0 - bass_mask)

        # stereo-center emphasis for vocals (mono: plain band)
        if mag.shape[0] == 2:
            side = np.abs(mag[0] - mag[1]) / (mag[0] + mag[1])
            center = (1.0 - side)[None]
            vocal_mask = vocal_band * center * (1.0 - drum_mask)
        else:
            vocal_mask = vocal_band * (1.0 - drum_mask) * 0.5

        total = bass_mask + drum_mask + vocal_mask
        other_mask = np.clip(1.0 - total, 0, 1)
        norm = bass_mask + drum_mask + vocal_mask + other_mask
        masks = {
            "bass": bass_mask / norm,
            "drums": drum_mask / norm,
            "vocals": vocal_mask / norm,
            "other": other_mask / norm,
        }

        stems = {}
        for name, mask in masks.items():
            m = np.broadcast_to(mask, mag.shape)
            # float32 on the device, as the JAX package's arrays are
            with torch.inference_mode():
                wav = kernel.istft(
                    torch.as_tensor(real * m, dtype=torch.float32, device=dev),
                    torch.as_tensor(imag * m, dtype=torch.float32, device=dev),
                ).cpu().numpy()
            stems[name] = AudioSegment.from_float(wav * 32768.0, sr)
        return stems
