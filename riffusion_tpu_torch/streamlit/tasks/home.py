"""Playground landing page (the counterpart of riffusion_tpu/streamlit/tasks/home.py)."""


def render() -> None:
    import streamlit as st

    st.set_page_config(layout="wide", page_icon="🎸")
    st.title("🎸 Riffusion Playground")
    st.write(
        """
        Generate and transform music with Stable Diffusion on an NVIDIA GPU.

        * **Text to Audio** — generate a clip from a text prompt
        * **Audio to Audio** — restyle existing audio with a prompt
        * **Interpolation** — walk the latent space between two prompts
        * **Audio Splitter** — split audio into stems
        * **Text to Audio Batch** — batch-generate from a JSON spec
        * **Sample Clips** — cut random clips from audio files
        * **Image to Audio** — reconstruct audio from a spectrogram image
        """
    )
