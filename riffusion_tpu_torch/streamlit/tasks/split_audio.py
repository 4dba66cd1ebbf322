"""
Stem-splitting task, the counterpart of riffusion_tpu/streamlit/tasks/
split_audio.py: split uploaded audio into stems (demucs where it is
installed, else the in-process splitter), allow recombining subsets by
overlay mixing. The page has a device selector, which the JAX page lacks:
the splitter's STFT runs on the device picked there.
"""

from __future__ import annotations

import typing as T

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.util import audio_util


def recombine(stems: T.Mapping[str, AudioSegment], include: T.Sequence[str]) -> AudioSegment:
    """Overlay-mix the selected stems back together."""
    selected = [stems[name] for name in include]
    assert selected, "select at least one stem"
    return audio_util.overlay_segments(selected)


def render() -> None:
    import tempfile
    from pathlib import Path

    import streamlit as st

    from riffusion_tpu_torch import audio_splitter
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("✂️ Audio Splitter")
    st.write("Split audio into stems (drums, bass, vocals, guitar, piano, other).")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()
    audio_file = st.file_uploader("Upload audio", type=streamlit_util.AUDIO_EXTENSIONS)
    if not audio_file:
        st.info("Upload an audio file to get started")
        return
    st.audio(audio_file)

    segment = streamlit_util.load_audio_file(audio_file)
    with tempfile.TemporaryDirectory() as td:
        audio_path = Path(td) / "input.wav"
        segment.export(audio_path, format="wav")
        try:
            stem_paths = audio_splitter.split_audio(
                audio_path, output_dir=Path(td) / "out", device=device
            )
        except RuntimeError as e:
            st.error(str(e))
            return
        stems = {p.stem: AudioSegment.from_file(p) for p in stem_paths}

    names = list(stems)
    for name in names:
        st.write(f"#### {name}")
        streamlit_util.display_and_download_audio(stems[name], name=name, extension=extension)

    include = st.multiselect("Recombine stems", options=names, default=names)
    if include:
        mixed = recombine(stems, include)
        st.write("#### recombined")
        streamlit_util.display_and_download_audio(mixed, name="recombined", extension=extension)
