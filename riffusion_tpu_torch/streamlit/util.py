"""
Streamlit utilities: the cached pipeline and converter loaders, scheduler
selection, the txt2img / img2img / MagicMix runners, the pipeline lock and
the audio display helpers. The counterpart of riffusion_tpu/streamlit/util.py,
over the port's RiffusionPipeline (one set of weights serves every mode).

Importable without streamlit: the caching decorator becomes an lru_cache
when streamlit is absent, and `st` is touched only inside the UI helpers.
Every device defaults to "cuda"; the CPU is used only when it is asked for.
"""

from __future__ import annotations

import functools
import io
import threading
import typing as T

from PIL import Image

from riffusion_tpu_torch.audio.segment import AudioSegment, _ffmpeg_path
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

DEFAULT_CHECKPOINT = "riffusion/riffusion-model-v1"

AUDIO_EXTENSIONS = ["mp3", "wav", "flac", "webm", "m4a", "ogg"]
IMAGE_EXTENSIONS = ["png", "jpg", "jpeg"]

# The reference UI's option strings, mapped to the port's schedulers (the
# "(Karras)" variants run on the Karras sigma grid).
SCHEDULER_OPTIONS = [
    "DPMSolverMultistepScheduler",
    "DPMSolverMultistepScheduler (Karras)",
    "UniPCMultistepScheduler",
    "UniPCMultistepScheduler (Karras)",
    "PNDMScheduler",
    "DDIMScheduler",
    "LMSDiscreteScheduler",
    "EulerDiscreteScheduler",
    "EulerAncestralDiscreteScheduler",
]

_SCHEDULER_MAP = {
    "DPMSolverMultistepScheduler": "dpmpp",
    "DPMSolverMultistepScheduler (Karras)": "dpmpp_k",
    "UniPCMultistepScheduler": "unipc",
    "UniPCMultistepScheduler (Karras)": "unipc_k",
    "PNDMScheduler": "pndm",
    "DDIMScheduler": "ddim",
    "LMSDiscreteScheduler": "lms",
    "EulerDiscreteScheduler": "euler",
    "EulerAncestralDiscreteScheduler": "euler_a",
}

DEVICE_OPTIONS = ["cuda", "cpu"]


def streamlit_available() -> bool:
    try:
        import streamlit  # noqa: F401

        return True
    except ImportError:
        return False


def _st():
    import streamlit as st

    return st


def _cache_resource(fn):
    """st.cache_resource when streamlit exists, else lru_cache."""
    if streamlit_available():
        return _st().cache_resource(fn)
    return functools.lru_cache(maxsize=None)(fn)


def scheduler_name(option: str) -> str:
    """UI scheduler option string -> the port's scheduler name."""
    if option not in _SCHEDULER_MAP:
        raise ValueError(f"Unknown scheduler {option}")
    return _SCHEDULER_MAP[option]


get_scheduler = scheduler_name  # the reference's name


@_cache_resource
def load_riffusion_checkpoint(
    checkpoint: str = DEFAULT_CHECKPOINT,
    no_traced_unet: bool = False,
    device: str = "cuda",
) -> RiffusionPipeline:
    """Load (cached) the shared pipeline. `no_traced_unet` is accepted for
    the reference's call sites and has no effect (the JAX package ignores it
    too)."""
    return RiffusionPipeline.load_checkpoint(checkpoint=checkpoint, device=device)


# The reference kept three separate diffusers pipelines; one pipeline covers
# all three modes here. These aliases keep the reference's call sites.
load_stable_diffusion_pipeline = load_riffusion_checkpoint
load_stable_diffusion_img2img_pipeline = load_riffusion_checkpoint
load_magic_mix_pipeline = load_riffusion_checkpoint


@_cache_resource
def pipeline_lock() -> threading.Lock:
    """Singleton lock serializing pipeline access across sessions."""
    return threading.Lock()


@_cache_resource
def spectrogram_image_converter(
    params: SpectrogramParams, device: str = "cuda"
) -> SpectrogramImageConverter:
    return SpectrogramImageConverter(params=params, device=device)


def spectrogram_image_from_audio(
    segment: AudioSegment, params: SpectrogramParams, device: str = "cuda"
) -> Image.Image:
    converter = spectrogram_image_converter(params=params, device=device)
    return converter.spectrogram_image_from_audio(segment)


def audio_segment_from_spectrogram_image(
    image: Image.Image, params: SpectrogramParams, device: str = "cuda"
) -> AudioSegment:
    converter = spectrogram_image_converter(params=params, device=device)
    return converter.audio_from_spectrogram_image(image)


def audio_bytes_from_spectrogram_image(
    image: Image.Image,
    params: SpectrogramParams,
    device: str = "cuda",
    output_format: str = "mp3",
) -> io.BytesIO:
    segment = audio_segment_from_spectrogram_image(image=image, params=params, device=device)
    audio_bytes = io.BytesIO()
    segment.export(audio_bytes, format=output_format)
    return audio_bytes


def default_output_extension() -> str:
    return "mp3" if _ffmpeg_path() else "wav"


# ----------------------------------------------------------------- inference


def run_txt2img(
    prompt: str,
    num_inference_steps: int,
    guidance: float,
    negative_prompt: str,
    seed: int,
    width: int,
    height: int,
    checkpoint: str = DEFAULT_CHECKPOINT,
    device: str = "cuda",
    scheduler: str = SCHEDULER_OPTIONS[0],
) -> Image.Image:
    """Text -> spectrogram image."""
    with pipeline_lock():
        pipeline = load_riffusion_checkpoint(checkpoint=checkpoint, device=device)
        return pipeline.txt2img(
            prompt=prompt,
            negative_prompt=negative_prompt or None,
            seed=seed,
            num_inference_steps=num_inference_steps,
            guidance=guidance,
            width=width,
            height=height,
            scheduler=scheduler_name(scheduler),
        )


def run_img2img(
    prompt: str,
    init_image: Image.Image,
    denoising_strength: float,
    num_inference_steps: int,
    guidance_scale: float,
    seed: int,
    negative_prompt: T.Optional[str] = None,
    checkpoint: str = DEFAULT_CHECKPOINT,
    device: str = "cuda",
    scheduler: str = SCHEDULER_OPTIONS[0],
    progress_callback: T.Optional[T.Callable[[float], T.Any]] = None,
) -> Image.Image:
    """Single-prompt img2img restyling. `progress_callback` hears 0.0 before
    the request and 1.0 after it."""
    with pipeline_lock():
        pipeline = load_riffusion_checkpoint(checkpoint=checkpoint, device=device)
        if progress_callback is not None:
            progress_callback(0.0)
        image = pipeline.img2img(
            prompt=prompt,
            init_image=init_image,
            denoising_strength=denoising_strength,
            negative_prompt=negative_prompt or None,
            seed=seed,
            num_inference_steps=num_inference_steps,
            guidance=guidance_scale,
            scheduler=scheduler_name(scheduler),
        )
        if progress_callback is not None:
            progress_callback(1.0)
        return image


def run_img2img_magic_mix(
    prompt: str,
    init_image: Image.Image,
    num_inference_steps: int,
    guidance_scale: float,
    seed: int,
    kmin: float,
    kmax: float,
    mix_factor: float,
    checkpoint: str = DEFAULT_CHECKPOINT,
    device: str = "cuda",
    scheduler: str = SCHEDULER_OPTIONS[0],
) -> Image.Image:
    """MagicMix img2img."""
    with pipeline_lock():
        pipeline = load_riffusion_checkpoint(checkpoint=checkpoint, device=device)
        return pipeline.img2img_magic_mix(
            prompt=prompt,
            init_image=init_image,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale,
            seed=seed,
            kmin=kmin,
            kmax=kmax,
            mix_factor=mix_factor,
            scheduler=scheduler_name(scheduler),
        )


def load_audio_file(audio_file: io.BytesIO) -> AudioSegment:
    return AudioSegment.from_file(audio_file)


@_cache_resource
def get_audio_splitter(device: str = "cuda"):
    from riffusion_tpu_torch.audio_splitter import AudioSplitter

    return AudioSplitter(device=device)


# ------------------------------------------------------------------ UI bits


def select_device(container: T.Any = None) -> str:
    """The device selector: "cuda" first and the default; the CPU only when
    it is picked."""
    st = _st()
    device = st.sidebar.selectbox(
        "Device",
        options=DEVICE_OPTIONS,
        index=0,
        help="Which compute device to use. CUDA is recommended.",
    )
    assert device is not None
    return device


def select_audio_extension(container: T.Any = None) -> str:
    st = _st()
    container = container or st.sidebar
    default = default_output_extension()
    extension = container.selectbox(
        "Output format",
        options=AUDIO_EXTENSIONS,
        index=AUDIO_EXTENSIONS.index(default),
    )
    assert extension is not None
    return extension


def select_scheduler(container: T.Any = None) -> str:
    st = _st()
    scheduler = st.sidebar.selectbox(
        "Scheduler",
        options=SCHEDULER_OPTIONS,
        index=0,
        help="Which diffusion scheduler to use",
    )
    assert scheduler is not None
    return scheduler


def select_checkpoint(container: T.Any = None) -> str:
    st = _st()
    container = container or st.sidebar
    return container.text_input(
        "Custom Checkpoint",
        value=DEFAULT_CHECKPOINT,
        help="Provide a custom model checkpoint",
    )


class StreamlitCounter:
    """Simple counter stored in streamlit session state."""

    def __init__(self, key: str = "_counter"):
        self.key = key
        st = _st()
        if not st.session_state.get(self.key):
            st.session_state[self.key] = 0

    def increment(self) -> None:
        _st().session_state[self.key] += 1

    @property
    def value(self) -> int:
        return _st().session_state[self.key]


def display_and_download_audio(
    segment: AudioSegment, name: str, extension: str = "mp3"
) -> None:
    """Render an audio player + a named download button."""
    st = _st()
    mime_type = f"audio/{extension}"
    audio_bytes = io.BytesIO()
    segment.export(audio_bytes, format=extension)
    st.audio(audio_bytes, format=mime_type)
    st.download_button(
        f"{name}.{extension}",
        data=audio_bytes,
        file_name=f"{name}.{extension}",
        mime=mime_type,
    )
