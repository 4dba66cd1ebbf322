"""
Image -> audio task, the counterpart of riffusion_tpu/streamlit/tasks/
image_to_audio.py: upload a spectrogram image, recover params from EXIF
(with fallbacks), reconstruct audio.
"""

from __future__ import annotations

import typing as T

from PIL import Image

from riffusion_tpu_torch.spectrogram_params import SpectrogramParams


def params_from_image(image: Image.Image, use_20k: bool = False) -> SpectrogramParams:
    """EXIF params if present, else defaults (20 kHz variant selectable)."""
    try:
        return SpectrogramParams.from_exif(image.getexif())
    except (KeyError, AttributeError):
        if use_20k:
            return SpectrogramParams(
                min_frequency=10, max_frequency=20000, stereo=True, sample_rate=44100
            )
        return SpectrogramParams()


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("⏈ Image to Audio")
    st.write("Reconstruct audio from a spectrogram image.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()

    image_file = st.file_uploader(
        "Upload a spectrogram image", type=streamlit_util.IMAGE_EXTENSIONS
    )
    if not image_file:
        st.info("Upload an image file to get started")
        return

    image = Image.open(image_file)
    st.image(image)

    try:
        params = SpectrogramParams.from_exif(image.getexif())
    except (KeyError, AttributeError):
        st.info("Could not find spectrogram parameters in exif data. Using defaults.")
        use_20k = st.checkbox("Use 20kHz", value=False)
        params = params_from_image(image, use_20k=use_20k)

    segment = streamlit_util.audio_segment_from_spectrogram_image(
        image=image.convert("RGB"), params=params, device=device
    )
    streamlit_util.display_and_download_audio(segment, name="image_to_audio", extension=extension)
