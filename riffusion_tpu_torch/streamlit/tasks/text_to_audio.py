"""
Text -> audio task, the counterpart of riffusion_tpu/streamlit/tasks/
text_to_audio.py: txt2img to a spectrogram image, then reconstruct audio;
multiple clips increment the seed; optional 20 kHz stereo params.
"""

from __future__ import annotations

import typing as T

from riffusion_tpu_torch.spectrogram_params import SpectrogramParams


def params_for_ui(use_20k: bool) -> SpectrogramParams:
    """Spectrogram params of the page's 20 kHz toggle."""
    if use_20k:
        return SpectrogramParams(
            min_frequency=10,
            max_frequency=20000,
            sample_rate=44100,
            stereo=True,
        )
    return SpectrogramParams(min_frequency=0, max_frequency=10000, stereo=False)


def generate_clips(
    prompt: str,
    negative_prompt: str = "",
    starting_seed: int = 42,
    num_clips: int = 1,
    num_inference_steps: int = 50,
    guidance: float = 7.0,
    width: int = 512,
    use_20k: bool = False,
    checkpoint: T.Optional[str] = None,
    device: str = "cuda",
    scheduler: str = "PNDMScheduler",
):
    """Yield (seed, image, segment) tuples — the task's business logic,
    callable without streamlit."""
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    params = params_for_ui(use_20k)
    for i in range(num_clips):
        seed = starting_seed + i
        image = streamlit_util.run_txt2img(
            prompt=prompt,
            num_inference_steps=num_inference_steps,
            guidance=guidance,
            negative_prompt=negative_prompt,
            seed=seed,
            width=width,
            height=512,
            checkpoint=checkpoint or streamlit_util.DEFAULT_CHECKPOINT,
            device=device,
            scheduler=scheduler,
        )
        segment = streamlit_util.audio_segment_from_spectrogram_image(
            image=image, params=params, device=device
        )
        yield seed, image, segment


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("🌊 Text to Audio")
    st.write("Generate audio clips from text prompts.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()
    checkpoint = streamlit_util.select_checkpoint()
    scheduler = streamlit_util.select_scheduler()

    with st.form("Inputs"):
        prompt = st.text_input("Prompt")
        negative_prompt = st.text_input("Negative prompt")
        col1, col2 = st.columns(2)
        starting_seed = col1.number_input("Seed", value=42)
        num_clips = col2.number_input("Number of clips", value=1, min_value=1)
        st.form_submit_button("Riff", type="primary")

    with st.sidebar.expander("Settings", expanded=False):
        num_inference_steps = st.number_input("Steps", value=50)
        guidance = st.number_input(
            "Guidance", value=7.0, help="How much the model listens to the text prompt"
        )
        width = st.number_input("Width", value=512, step=32)
        use_20k = st.checkbox("Use 20kHz", value=False)

    if not prompt:
        st.info("Enter a prompt")
        return

    for seed, image, segment in generate_clips(
        prompt=prompt,
        negative_prompt=negative_prompt,
        starting_seed=int(starting_seed),
        num_clips=int(num_clips),
        num_inference_steps=int(num_inference_steps),
        guidance=float(guidance),
        width=int(width),
        use_20k=use_20k,
        checkpoint=checkpoint,
        device=device,
        scheduler=scheduler,
    ):
        st.write(f"#### Seed {seed}")
        st.image(image, use_column_width=False)
        streamlit_util.display_and_download_audio(
            segment, name=f"{prompt.replace(' ', '_')}_{seed}", extension=extension
        )
