"""
Interpolation task, the counterpart of riffusion_tpu/streamlit/tasks/
interpolation.py: latent-space walk between two prompts — N alphas with
optional power-curve shaping, every alpha in one batched program, and a
zero-crossfade concat of the clips. Run under a process group of several
ranks (torchrun, parallel/mesh.py), the batch is split data-parallel over
a ("data",) mesh of every rank when the alpha count divides by it, as the
JAX package shards it over its devices; alone, it runs on the one device.
"""

from __future__ import annotations

import dataclasses
import functools
import typing as T

import numpy as np
import torch
from PIL import Image

from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams


def shaped_alphas(num_frames: int, alpha_power: float = 1.0) -> T.List[float]:
    """Evenly spaced alphas with power-curve shaping."""
    alphas = list(np.linspace(0, 1, num_frames))
    alphas_shifted = [2 * a - 1 for a in alphas]
    alphas_shifted = [(abs(a) ** alpha_power) * (1 if a > 0 else -1) for a in alphas_shifted]
    return [(a + 1) / 2 for a in alphas_shifted]


@dataclasses.dataclass(frozen=True)
class InterpolationSpec:
    prompt_start: str
    prompt_end: str
    seed_start: int
    seed_end: int
    num_frames: int = 4
    alpha_power: float = 1.0
    denoising: float = 0.75
    guidance: float = 7.0
    num_inference_steps: int = 50


def run_interpolation_batch(
    spec: InterpolationSpec,
    init_image: Image.Image,
    device: str = "cuda",
    checkpoint: T.Optional[str] = None,
    use_sharded_sweep: bool = True,
) -> T.Tuple[T.List[Image.Image], T.List[AudioSegment]]:
    """Generate all frames as one batch, images and audio together (sharded
    over the ranks when a mesh is useful, see sweep_mesh). Returns (images,
    segments)."""
    from riffusion_tpu_torch.streamlit import util as streamlit_util

    pipeline = streamlit_util.load_riffusion_checkpoint(
        checkpoint=checkpoint or streamlit_util.DEFAULT_CHECKPOINT, device=device
    )
    alphas = shaped_alphas(spec.num_frames, spec.alpha_power)
    mesh = sweep_mesh(len(alphas), device) if use_sharded_sweep else None

    reqs = [
        InferenceInput(
            alpha=float(alpha),
            num_inference_steps=spec.num_inference_steps,
            seed_image_id="og_beat",
            start=PromptInput(
                prompt=spec.prompt_start, seed=spec.seed_start,
                denoising=spec.denoising, guidance=spec.guidance,
            ),
            end=PromptInput(
                prompt=spec.prompt_end, seed=spec.seed_end,
                denoising=spec.denoising, guidance=spec.guidance,
            ),
        )
        for alpha in alphas
    ]
    num_frequencies = init_image.height - init_image.height % 32
    params = SpectrogramParams(
        min_frequency=0, max_frequency=10000, num_frequencies=num_frequencies
    )
    sharded = {} if mesh is None else {"mesh": mesh}
    results = pipeline.riffuse_audio_batch(reqs, init_image, params=params, **sharded)
    images = [img for img, _ in results]
    segments = [seg for _, seg in results]
    return images, segments


def sweep_mesh(num_alphas: int, device: str = "cuda"):
    """The ("data",) mesh of every rank, on `device`'s type, when a process
    group of more than one rank is running and `num_alphas` divides by its
    size, else None (the JAX page's condition, with the world size for the
    device count)."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    if num_alphas % dist.get_world_size():
        return None
    return _data_mesh(dist.get_world_size(), torch.device(device).type)


@functools.lru_cache(maxsize=None)
def _data_mesh(world_size: int, device_type: str):
    """One ("data",) mesh per world and device type: a mesh makes process
    groups, which live as long as the process."""
    from riffusion_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(axis_names=("data",), device_type=device_type)


def concat_segments(segments: T.Sequence[AudioSegment]) -> AudioSegment:
    """Zero-crossfade concatenation."""
    combined = segments[0]
    for s in segments[1:]:
        combined = combined.append(s, crossfade=0)
    return combined


def render() -> None:
    import streamlit as st

    from riffusion_tpu_torch.streamlit import util as streamlit_util

    st.set_page_config(layout="wide", page_icon="🎸")
    st.subheader("🎭 Interpolation")
    st.write("Interpolate between prompts in the latent space.")

    device = streamlit_util.select_device()
    extension = streamlit_util.select_audio_extension()
    checkpoint = streamlit_util.select_checkpoint()

    num_interpolation_steps = T.cast(
        int, st.sidebar.number_input("Interpolation steps", value=4, min_value=1, max_value=64)
    )
    alpha_power = st.sidebar.number_input("Alpha power", value=1.0)
    num_inference_steps = T.cast(int, st.sidebar.number_input("Inference steps", value=50))

    init_image_name = st.sidebar.selectbox(
        "Seed image",
        options=["og_beat", "agile", "marim", "motorway", "vibes"],
        index=0,
    )

    with st.form("Inputs"):
        col1, col2 = st.columns(2)
        with col1:
            st.write("##### Prompt A")
            prompt_start = st.text_input("Prompt", key="pa")
            seed_start = st.number_input("Seed", value=42, key="sa")
            denoising = st.number_input("Denoising", value=0.75)
        with col2:
            st.write("##### Prompt B")
            prompt_end = st.text_input("Prompt", key="pb")
            seed_end = st.number_input("Seed", value=123, key="sb")
            guidance = st.number_input("Guidance", value=7.0)
        st.form_submit_button("Generate", type="primary")

    if not prompt_start or not prompt_end:
        st.info("Enter both prompts")
        return

    from pathlib import Path

    seed_images_dir = Path(__file__).resolve().parents[3] / "seed_images"
    init_image = Image.open(seed_images_dir / f"{init_image_name}.png").convert("RGB")

    spec = InterpolationSpec(
        prompt_start=prompt_start,
        prompt_end=prompt_end,
        seed_start=int(seed_start),
        seed_end=int(seed_end),
        num_frames=int(num_interpolation_steps),
        alpha_power=float(alpha_power),
        denoising=float(denoising),
        guidance=float(guidance),
        num_inference_steps=int(num_inference_steps),
    )
    images, segments = run_interpolation_batch(spec, init_image, device, checkpoint)

    cols = st.columns(len(images))
    for col, image in zip(cols, images):
        col.image(image)

    combined = concat_segments(segments)
    streamlit_util.display_and_download_audio(combined, name="interpolation", extension=extension)
