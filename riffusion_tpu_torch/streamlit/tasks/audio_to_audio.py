"""
Audio-to-audio restyling, the counterpart of riffusion_tpu/streamlit/tasks/
audio_to_audio.py: slice arbitrary-length audio into 5 s clips with 0.2 s
overlap, convert each to a spectrogram image, run img2img (plain /
interpolation / magic mix), convert back, and crossfade-stitch the results.
In interpolation mode the clips run as one batched program (one seed image
per clip).
"""

from __future__ import annotations

import dataclasses
import typing as T

import numpy as np
from PIL import Image

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import audio_util

CLIP_DURATION_S = 5.0
OVERLAP_S = 0.2


@dataclasses.dataclass(frozen=True)
class ClipParams:
    prompt: str
    negative_prompt: str = ""
    seed: int = 42
    denoising: float = 0.45
    guidance: float = 7.0
    num_inference_steps: int = 50


def clip_start_times(duration_s: float, clip_s: float = CLIP_DURATION_S,
                     overlap_s: float = OVERLAP_S) -> np.ndarray:
    """Start offsets covering the audio with fixed overlap."""
    stride = clip_s - overlap_s
    if duration_s <= clip_s:
        return np.array([0.0])
    return np.arange(0, duration_s - clip_s + stride, stride)


def slice_audio_into_clips(
    segment: AudioSegment, starts_s: T.Sequence[float], clip_s: float = CLIP_DURATION_S
) -> T.List[AudioSegment]:
    """Cut clips, padding the last one with silence to full length."""
    clips = []
    for start in starts_s:
        clip = segment[start * 1000 : (start + clip_s) * 1000]
        want = int(round(clip_s * 1000))
        if len(clip) < want:
            silence = AudioSegment.silent(
                want - len(clip), segment.frame_rate, channels=clip.channels
            )
            clip = clip.append(silence, crossfade=0)
        clips.append(clip)
    return clips


def scale_image_to_32_stride(image: Image.Image) -> Image.Image:
    """Resize down to dims that are multiples of 32."""
    w, h = image.size
    return image.resize((w - w % 32, h - h % 32), Image.BICUBIC)


def restyle_segment(
    segment: AudioSegment,
    params: ClipParams,
    mode: str = "img2img",
    device: str = "cuda",
    checkpoint: T.Optional[str] = None,
    scheduler: str = "PNDMScheduler",
    magic_mix_kmin: float = 0.3,
    magic_mix_kmax: float = 0.5,
    magic_mix_factor: float = 0.5,
    interpolation_alpha: float = 0.5,
    prompt_b: T.Optional[str] = None,
    seed_b: int = 123,
    sample_rate: int = 44100,
) -> T.Tuple[AudioSegment, Image.Image, Image.Image]:
    """Restyle one audio segment. Returns (audio, source_image, result_image).

    Modes: "img2img", "interpolation" (two-prompt riffuse at a fixed
    alpha), "magic_mix".
    """
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    if segment.frame_rate != sample_rate:
        segment = segment.set_frame_rate(sample_rate)

    spectrogram_params = SpectrogramParams()
    init_image = streamlit_util.spectrogram_image_from_audio(
        segment, params=spectrogram_params, device=device
    )
    orig_size = init_image.size
    model_image = scale_image_to_32_stride(init_image)

    checkpoint = checkpoint or streamlit_util.DEFAULT_CHECKPOINT
    if mode == "img2img":
        result = streamlit_util.run_img2img(
            prompt=params.prompt,
            init_image=model_image,
            denoising_strength=params.denoising,
            num_inference_steps=params.num_inference_steps,
            guidance_scale=params.guidance,
            negative_prompt=params.negative_prompt or None,
            seed=params.seed,
            checkpoint=checkpoint,
            device=device,
            scheduler=scheduler,
        )
    elif mode == "interpolation":
        from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput

        pipeline = streamlit_util.load_riffusion_checkpoint(
            checkpoint=checkpoint, device=device
        )
        inputs = InferenceInput(
            alpha=interpolation_alpha,
            num_inference_steps=params.num_inference_steps,
            start=PromptInput(
                prompt=params.prompt, seed=params.seed,
                denoising=params.denoising, guidance=params.guidance,
            ),
            end=PromptInput(
                prompt=prompt_b or params.prompt, seed=seed_b,
                denoising=params.denoising, guidance=params.guidance,
            ),
        )
        result = pipeline.riffuse(inputs, init_image=model_image)
    elif mode == "magic_mix":
        result = streamlit_util.run_img2img_magic_mix(
            prompt=params.prompt,
            init_image=model_image,
            num_inference_steps=params.num_inference_steps,
            guidance_scale=params.guidance,
            seed=params.seed,
            kmin=magic_mix_kmin,
            kmax=magic_mix_kmax,
            mix_factor=magic_mix_factor,
            checkpoint=checkpoint,
            device=device,
            scheduler=scheduler,
        )
    else:
        raise ValueError(f"Unknown mode {mode!r}")

    if result.size != orig_size:
        result = result.resize(orig_size, Image.BICUBIC)

    audio = streamlit_util.audio_segment_from_spectrogram_image(
        image=result, params=spectrogram_params, device=device
    )
    return audio, init_image, result


def restyle_audio(
    segment: AudioSegment,
    params: ClipParams,
    mode: str = "img2img",
    device: str = "cuda",
    checkpoint: T.Optional[str] = None,
    scheduler: str = "PNDMScheduler",
    increment_seed_per_clip: bool = True,
    **mode_kwargs,
) -> T.Tuple[AudioSegment, T.List[Image.Image]]:
    """Full long-audio restyle: slice -> per-clip restyle -> crossfade stitch.
    Returns (stitched audio, result images)."""
    starts = clip_start_times(segment.duration_seconds)
    clips = slice_audio_into_clips(segment, starts)

    if mode == "interpolation" and len(clips) > 1:
        batched = _restyle_clips_batched(
            clips, params, device=device, checkpoint=checkpoint,
            increment_seed_per_clip=increment_seed_per_clip, **mode_kwargs,
        )
        if batched is not None:
            outputs, images = batched
            stitched = audio_util.stitch_segments(outputs, crossfade_s=OVERLAP_S)
            return stitched, images

    outputs = []
    images = []
    for i, clip in enumerate(clips):
        clip_params = params
        if increment_seed_per_clip and i > 0:
            clip_params = dataclasses.replace(params, seed=params.seed + i)
        audio, _, result_image = restyle_segment(
            clip, clip_params, mode=mode, device=device,
            checkpoint=checkpoint, scheduler=scheduler, **mode_kwargs,
        )
        outputs.append(audio)
        images.append(result_image)
    stitched = audio_util.stitch_segments(outputs, crossfade_s=OVERLAP_S)
    return stitched, images


def _restyle_clips_batched(
    clips: T.List[AudioSegment],
    params: ClipParams,
    device: str = "cuda",
    checkpoint: T.Optional[str] = None,
    increment_seed_per_clip: bool = True,
    interpolation_alpha: float = 0.5,
    prompt_b: T.Optional[str] = None,
    seed_b: int = 123,
    **_ignored,
) -> T.Optional[T.Tuple[T.List[AudioSegment], T.List[Image.Image]]]:
    """Run the whole interpolation-mode clip sweep as one batched program
    (one seed image per clip, the UNet at batch 2N). Returns None when the
    clip images' sizes differ; the caller then runs the serial loop."""
    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    spectrogram_params = SpectrogramParams()
    model_images = []
    for clip in clips:
        image = streamlit_util.spectrogram_image_from_audio(
            clip, params=spectrogram_params, device=device
        )
        model_images.append(scale_image_to_32_stride(image))
    if len({im.size for im in model_images}) != 1:
        return None

    pipeline = streamlit_util.load_riffusion_checkpoint(
        checkpoint=checkpoint or streamlit_util.DEFAULT_CHECKPOINT, device=device
    )
    inputs_list = []
    for i in range(len(clips)):
        seed = params.seed + (i if increment_seed_per_clip else 0)
        inputs_list.append(
            InferenceInput(
                alpha=interpolation_alpha,
                num_inference_steps=params.num_inference_steps,
                start=PromptInput(
                    prompt=params.prompt, seed=seed,
                    denoising=params.denoising, guidance=params.guidance,
                ),
                end=PromptInput(
                    prompt=prompt_b or params.prompt, seed=seed_b + i,
                    denoising=params.denoising, guidance=params.guidance,
                ),
            )
        )
    h = model_images[0].height
    fused = SpectrogramParams(
        min_frequency=0, max_frequency=10000,
        num_frequencies=h - h % 32,
    )
    results = pipeline.riffuse_audio_batch(
        inputs_list, model_images, params=fused
    )
    outputs = [seg for _, seg in results]
    images = [img for img, _ in results]
    return outputs, images


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("✨ Audio to Audio")
    st.write("Restyle existing audio with a text prompt.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()
    checkpoint = streamlit_util.select_checkpoint()
    scheduler = streamlit_util.select_scheduler()

    audio_file = st.file_uploader("Upload audio", type=streamlit_util.AUDIO_EXTENSIONS)
    if not audio_file:
        st.info("Upload an audio file to get started")
        return

    segment = streamlit_util.load_audio_file(audio_file)
    st.audio(audio_file)

    mode = st.radio("Mode", ["img2img", "interpolation", "magic_mix"], horizontal=True)
    assert mode is not None

    with st.form("Inputs"):
        prompt = st.text_input("Prompt")
        negative_prompt = st.text_input("Negative prompt")
        col1, col2, col3 = st.columns(3)
        seed = col1.number_input("Seed", value=42)
        denoising = col2.number_input("Denoising", value=0.45)
        guidance = col3.number_input("Guidance", value=7.0)
        num_inference_steps = st.sidebar.number_input("Steps", value=50)
        st.form_submit_button("Riff", type="primary")

    if not prompt:
        st.info("Enter a prompt")
        return

    params = ClipParams(
        prompt=prompt,
        negative_prompt=negative_prompt,
        seed=int(seed),
        denoising=float(denoising),
        guidance=float(guidance),
        num_inference_steps=int(num_inference_steps),
    )
    stitched, images = restyle_audio(
        segment, params, mode=mode, device=device,
        checkpoint=checkpoint, scheduler=scheduler,
    )
    cols = st.columns(min(4, len(images)))
    for i, image in enumerate(images):
        cols[i % len(cols)].image(image)
    streamlit_util.display_and_download_audio(stitched, name="audio_to_audio", extension=extension)
