"""
Sharded frame sweeps: the counterpart of riffusion_tpu/parallel/sweep.py.

The reference generates interpolation frames one riffuse call per alpha.
`FrameSweep.interpolate` runs every alpha of a sweep as one batch, and
with a mesh splits the frames over its "data" axis: each rank runs its
contiguous share and the uint8 frames are gathered, so N ranks make N
frames in the wall time of one.

The JAX package vmaps one frame's program (UNet batch 2) over the frames;
here the frames are requests of the pipeline's batched program, and their
attention sites route as one frame's would (UNet batch 2), so K1 takes
the self-attention sites whatever the number of frames, as on the TPU.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.parallel.mesh import axis_size, data_share, gather_rows
from riffusion_tpu_torch.riffusion_pipeline import (
    ANCESTRAL, GeneratorNoise, NoiseSource, RiffusionPipeline,
)


class _FrameNoise:
    """Frame `frame` of a sweep's view of one noise source that every frame
    shares: the same "vae_eps", "noise_a" and "noise_b" for every frame
    (drawn once), and its own slice of one "ancestral" draw of (S, F, C, h,
    w) for the sweep's F frames."""

    def __init__(self, draws: T.Dict[str, torch.Tensor], source: NoiseSource, frame: int,
                 num_frames: int):
        self.draws, self.source, self.frame, self.num_frames = draws, source, frame, num_frames

    def __call__(self, name: str, shape: T.Tuple[int, ...], device: torch.device) -> torch.Tensor:
        if name == ANCESTRAL:
            full = (shape[0], self.num_frames) + tuple(shape[2:])
            if name not in self.draws:
                self.draws[name] = self.source(name, full, device)
            return self.draws[name][:, self.frame:self.frame + 1]
        if name not in self.draws:
            self.draws[name] = self.source(name, shape, device)
        return self.draws[name]


class FrameSweep:
    """Batched alpha-sweep interpolation, over a mesh's "data" axis or on
    one device.

    Usage: sweep = FrameSweep(pipeline, mesh); images = sweep.interpolate(...).
    All alphas share the seed image, the seeds and the prompts; each frame
    takes the alpha's lerp of the text embeddings and of the guidance, and
    the alpha's slerp of the two seed noises. The frames are requests of
    the pipeline's batched program, which runs a rank's share of them.
    """

    def __init__(self, pipeline: RiffusionPipeline, mesh: T.Optional[T.Any] = None):
        self.pipe = pipeline
        self.mesh = mesh
        if mesh is not None:
            pipeline._check_mesh(mesh)

    def interpolate(
        self,
        prompt_start: str,
        prompt_end: str,
        seed_start: int,
        seed_end: int,
        init_image: Image.Image,
        alphas: T.Sequence[float],
        num_inference_steps: int = 50,
        denoising: float = 0.75,
        guidance_start: float = 7.0,
        guidance_end: float = 7.0,
        use_reweighting: bool = True,
        *,
        noise: T.Optional[NoiseSource] = None,
    ) -> np.ndarray:
        """All alpha frames as (num_frames, H, W, 3) uint8 spectrogram
        images. With a mesh, every rank calls this with the same arguments
        and gets every frame; the alphas are padded (repeating the last) up
        to a multiple of the "data" axis, and the extra frames dropped.

        Draws: "vae_eps", "noise_a" and "noise_b" of one latent, shared by
        every frame (the seed image's sample and the two seed noises), and
        with an ancestral sampler "ancestral", (S, F, C, h, w) for the F
        padded frames (each frame its own). `noise` defaults to
        GeneratorNoise(seed_start, seed_end)."""
        pipe = self.pipe
        alphas_arr = np.asarray(list(alphas), np.float32)
        n = len(alphas_arr)
        shard = axis_size(self.mesh, "data") if self.mesh is not None else 1
        n_pad = -(-n // shard) * shard
        alphas_padded = np.pad(alphas_arr, (0, n_pad - n), mode="edge")
        frames = [
            InferenceInput(
                start=PromptInput(prompt=prompt_start, seed=seed_start, denoising=denoising,
                                  guidance=guidance_start),
                end=PromptInput(prompt=prompt_end, seed=seed_end, denoising=denoising,
                                guidance=guidance_end),
                alpha=float(a), num_inference_steps=num_inference_steps,
            )
            for a in alphas_padded
        ]
        source = noise or GeneratorNoise(seed_start, seed_end, pipe.device)
        draws: T.Dict[str, torch.Tensor] = {}
        noises = [_FrameNoise(draws, source, i, n_pad) for i in range(n_pad)]
        share = data_share(self.mesh, n_pad) if self.mesh is not None else None
        # the JAX package vmaps one frame's program: its sites route at UNet batch 2
        images, _ = pipe._dispatch(
            frames, [init_image], None, use_reweighting, None, noises, None,
            share=share, routed_batch=2, strength=denoising,
        )()
        if self.mesh is not None:
            images = gather_rows(torch.from_numpy(images).to(pipe.device), self.mesh).cpu().numpy()
        return images[:n]


def dryrun_serving_batch(n_devices: int, device: str = "cuda") -> int:
    """Mesh-sharded batched serving on tiny shapes: one riffuse_audio_batch
    over a (data, model) mesh of an initialized world of n_devices, the
    batch split on "data" (parallel/dryrun.py); returns the request count."""
    from riffusion_tpu_torch.parallel.mesh import factor_mesh_shape, make_mesh
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    if dist.get_world_size() != n_devices:
        raise RuntimeError(f"need a world of {n_devices}, have {dist.get_world_size()}")
    mesh = make_mesh(factor_mesh_shape(n_devices, 2), ("data", "model"),
                     device_type=torch.device(device).type)
    pipe = RiffusionPipeline.load_checkpoint("random:tiny", device=device)
    rng = np.random.default_rng(0)
    init = Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8))
    n = axis_size(mesh, "data")
    reqs = [
        InferenceInput(
            start=PromptInput(prompt=f"style {i}", seed=i),
            end=PromptInput(prompt="target", seed=100 + i),
            alpha=0.1 * i,
            num_inference_steps=2,
        )
        for i in range(n)
    ]
    results = pipe.riffuse_audio_batch(
        reqs, init, params=SpectrogramParams(num_frequencies=64), mesh=mesh
    )
    if len(results) != n:
        raise RuntimeError(f"the sharded batch returned {len(results)} of {n} clips")
    return n
