"""
Sample clips task, the counterpart of riffusion_tpu/streamlit/tasks/
sample_clips.py: cut random clips from an uploaded audio file, optionally
compute spectrograms.
"""

from __future__ import annotations

import typing as T

import numpy as np

from riffusion_tpu_torch.audio.segment import AudioSegment


def sample_clip_starts(
    duration_ms: float, clip_duration_ms: int, num_clips: int, seed: int = -1
) -> T.List[int]:
    """Random clip start offsets. A seed >= 0 seeds numpy's global RNG, as
    the JAX package does, so both draw the same starts."""
    if seed >= 0:
        np.random.seed(seed)
    span = int(duration_ms) - clip_duration_ms
    if span <= 0:
        return [0] * num_clips
    return [int(np.random.randint(0, span)) for _ in range(num_clips)]


def sample_clips(
    segment: AudioSegment,
    num_clips: int,
    duration_ms: int,
    mono: bool = False,
    seed: int = -1,
) -> T.List[T.Tuple[int, AudioSegment]]:
    """Returns [(start_ms, clip), ...]."""
    if mono:
        segment = segment.set_channels(1)
    starts = sample_clip_starts(segment.duration_ms, duration_ms, num_clips, seed)
    return [(s, segment[s : s + duration_ms]) for s in starts]


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("📎 Sample Clips")
    st.write("Export short clips from an audio file.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()

    audio_file = st.file_uploader("Upload audio", type=streamlit_util.AUDIO_EXTENSIONS)
    if not audio_file:
        st.info("Upload an audio file to get started")
        return

    segment = streamlit_util.load_audio_file(audio_file)
    st.audio(audio_file)

    col1, col2, col3 = st.columns(3)
    num_clips = int(col1.number_input("Number of clips", value=3, min_value=1))
    duration_ms = int(col2.number_input("Duration (ms)", value=5120))
    seed = int(col3.number_input("Seed", value=-1))
    mono = st.checkbox("Mono", value=False)
    compute_spectrograms = st.checkbox("Compute spectrograms", value=False)

    for start_ms, clip in sample_clips(segment, num_clips, duration_ms, mono, seed):
        name = f"clip_start_{start_ms}_ms_duration_{duration_ms}_ms"
        st.write(f"#### {name}")
        streamlit_util.display_and_download_audio(clip, name=name, extension=extension)
        if compute_spectrograms:
            params = SpectrogramParams(stereo=clip.channels == 2)
            image = streamlit_util.spectrogram_image_from_audio(
                clip, params=params, device=device
            )
            st.image(image)
