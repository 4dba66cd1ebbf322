"""
Debug FFT analysis and plotting: the counterpart of
riffusion_tpu/util/fft_util.py. `compute_fft` is host numpy; `plot_ffts`
imports plotly when it is installed, else matplotlib, when it is called.
"""

from __future__ import annotations

import typing as T

import numpy as np

from riffusion_tpu_torch.audio.segment import AudioSegment


def compute_fft(
    segment: AudioSegment,
    window_duration_ms: int = 100,
) -> T.Tuple[np.ndarray, np.ndarray]:
    """Windowed average magnitude spectrum of a segment.

    Returns (frequencies Hz, mean |FFT| over windows), per the first channel.
    """
    sr = segment.frame_rate
    samples = segment.raw_data[:, 0].astype(np.float64) / 32768.0
    win = int(window_duration_ms / 1000 * sr)
    n_windows = max(1, len(samples) // win)
    mags = []
    window_fn = np.hanning(win)
    for i in range(n_windows):
        chunk = samples[i * win : (i + 1) * win]
        if len(chunk) < win:
            break
        mags.append(np.abs(np.fft.rfft(chunk * window_fn)))
    mean_mag = np.mean(mags, axis=0) if mags else np.zeros(win // 2 + 1)
    freqs = np.fft.rfftfreq(win, 1.0 / sr)
    return freqs, mean_mag


def plot_ffts(
    segments: T.Mapping[str, AudioSegment],
    title: str = "FFT",
    window_duration_ms: int = 100,
    show: bool = True,
    save_path: T.Optional[str] = None,
):
    """Overlay the spectra of several segments (debug aid)."""
    curves = {name: compute_fft(seg, window_duration_ms) for name, seg in segments.items()}

    try:
        import plotly.graph_objects as go

        fig = go.Figure()
        for name, (freqs, mag) in curves.items():
            fig.add_trace(go.Scatter(x=freqs, y=mag, name=name))
        fig.update_layout(title=title, xaxis_type="log", yaxis_type="log")
        if save_path:
            fig.write_html(save_path)
        if show:
            fig.show()
        return fig
    except ImportError:
        pass

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    for name, (freqs, mag) in curves.items():
        ax.loglog(freqs[1:], mag[1:] + 1e-12, label=name)
    ax.set_title(title)
    ax.set_xlabel("Hz")
    ax.legend()
    if save_path:
        fig.savefig(save_path)
    return fig
