"""
Fine-tuning dataset: audio files -> spectrogram images -> VAE posterior
moments + CLIP text embeddings, cached as npz shards.

The counterpart of riffusion_tpu/training/dataset.py, with the same shard
format (so a dataset built by either package trains the other):
`shard_{i:05d}.npz` holding fp16 `mean` and `logvar` (N, h, w, c) and the
int32 prompt index `ctx`, `contexts.npy` with one fp16 (77, hidden) CLIP
embedding per unique prompt, and `meta.json`.

- `build_latent_dataset(pipeline, ...)` runs on the port's pipeline: its
  `embed_text` for each unique prompt, and the VAE's `encode_moments` in
  fp32 batches of `encode_batch` on the pipeline's device.
- `LatentDataset` is the JAX package's numpy stream, copied: the same
  shards and seed give the same batches, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import typing as T
from pathlib import Path

import numpy as np
import torch

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg", ".m4a")


@dataclasses.dataclass(frozen=True)
class DatasetMeta:
    num_clips: int
    latent_shape: T.Tuple[int, int, int]  # (h, w, c)
    context_shape: T.Tuple[int, int]  # (seq, hidden)
    scaling_factor: float
    num_shards: int
    prompts: T.Tuple[str, ...]
    params: T.Dict[str, T.Any]  # SpectrogramParams asdict, for provenance

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "DatasetMeta":
        return cls(
            num_clips=d["num_clips"],
            latent_shape=tuple(d["latent_shape"]),
            context_shape=tuple(d["context_shape"]),
            scaling_factor=d["scaling_factor"],
            num_shards=d["num_shards"],
            prompts=tuple(d["prompts"]),
            params=d["params"],
        )


def _iter_audio_files(audio_dir: Path) -> T.List[Path]:
    files = sorted(
        p for p in audio_dir.iterdir() if p.suffix.lower() in AUDIO_EXTENSIONS and p.is_file()
    )
    if not files:
        raise FileNotFoundError(f"no audio files ({AUDIO_EXTENSIONS}) in {audio_dir}")
    return files


def _prompt_for(path: Path, prompts_map: T.Dict[str, str], default_prompt: T.Optional[str]) -> str:
    if path.name in prompts_map:
        return prompts_map[path.name]
    if path.stem in prompts_map:
        return prompts_map[path.stem]
    if default_prompt is not None:
        return default_prompt
    # filename as prompt: "lofi_hip_hop-take2" -> "lofi hip hop take2"
    return path.stem.replace("_", " ").replace("-", " ").strip()


def _slice_clips(segment: AudioSegment, clip_duration_ms: int,
                 max_clips: int) -> T.List[AudioSegment]:
    """Non-overlapping fixed-duration windows; the trailing remainder is
    dropped so every clip has the same spectrogram geometry."""
    total_ms = int(segment.duration_seconds * 1000)
    clips = []
    for start in range(0, total_ms - clip_duration_ms + 1, clip_duration_ms):
        clips.append(segment[start : start + clip_duration_ms])
        if len(clips) >= max_clips:
            break
    return clips


def build_latent_dataset(
    pipeline,
    audio_dir: T.Union[str, Path],
    out_dir: T.Union[str, Path],
    params: T.Optional[SpectrogramParams] = None,
    prompts_json: T.Optional[T.Union[str, Path]] = None,
    default_prompt: T.Optional[str] = None,
    clip_duration_ms: int = 5120,
    max_clips_per_file: int = 64,
    encode_batch: int = 8,
    shard_size: int = 256,
    seed: int = 0,
) -> DatasetMeta:
    """Precompute (VAE moments, prompt index) shards from a directory of
    audio with a loaded port `RiffusionPipeline` (its VAE, CLIP and device).
    5120 ms is 512 frames of 10 ms, the 512x512 spectrogram geometry.
    `seed` is reserved and unused, as in the JAX package."""
    del seed
    from riffusion_tpu_torch.riffusion_pipeline import preprocess_image
    from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter

    audio_dir = Path(audio_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    params = params or SpectrogramParams()

    prompts_map: T.Dict[str, str] = {}
    if prompts_json is None and (audio_dir / "prompts.json").exists():
        prompts_json = audio_dir / "prompts.json"
    if prompts_json is not None:
        with open(prompts_json, encoding="utf-8") as fh:
            prompts_map = json.load(fh)

    converter = SpectrogramImageConverter(params, device=str(pipeline.device))

    # ---- (image array, prompt) pairs
    images: T.List[np.ndarray] = []
    prompt_of_clip: T.List[str] = []
    for path in _iter_audio_files(audio_dir):
        segment = AudioSegment.from_file(str(path))
        prompt = _prompt_for(path, prompts_map, default_prompt)
        for clip in _slice_clips(segment, clip_duration_ms, max_clips_per_file):
            img = converter.spectrogram_image_from_audio(clip)
            arr = preprocess_image(img)[0]  # (H, W, 3) float32 in [-1, 1]
            h8, w8 = (arr.shape[0] // 8) * 8, (arr.shape[1] // 8) * 8  # the VAE's stride
            images.append(arr[:h8, :w8])
            prompt_of_clip.append(prompt)
    if not images:
        raise ValueError(
            f"no clips of {clip_duration_ms} ms could be sliced from {audio_dir} "
            "(are the files shorter than one clip?)"
        )

    # ---- one embedding per unique prompt
    unique_prompts = sorted(set(prompt_of_clip))
    prompt_index = {p: i for i, p in enumerate(unique_prompts)}
    contexts = np.stack(
        [pipeline.embed_text(p)[0].float().cpu().numpy() for p in unique_prompts]
    ).astype(np.float16)  # (P, 77, hidden)
    ctx_of_clip = np.asarray([prompt_index[p] for p in prompt_of_clip], np.int32)

    # ---- VAE moments in fp32 batches (the pipeline keeps its VAE in fp32)
    means: T.List[np.ndarray] = []
    logvars: T.List[np.ndarray] = []
    with torch.inference_mode():
        for i in range(0, len(images), encode_batch):
            batch = torch.from_numpy(np.stack(images[i : i + encode_batch]))
            batch = batch.to(pipeline.device, torch.float32).permute(0, 3, 1, 2)
            mean, logvar = pipeline.vae.encode_moments(batch)
            means.append(mean.permute(0, 2, 3, 1).cpu().numpy().astype(np.float16))
            logvars.append(logvar.permute(0, 2, 3, 1).cpu().numpy().astype(np.float16))
    mean_all = np.concatenate(means)
    logvar_all = np.concatenate(logvars)

    # ---- shards
    num_shards = (len(images) + shard_size - 1) // shard_size
    for s in range(num_shards):
        lo, hi = s * shard_size, min((s + 1) * shard_size, len(images))
        np.savez_compressed(
            out_dir / f"shard_{s:05d}.npz",
            mean=mean_all[lo:hi],
            logvar=logvar_all[lo:hi],
            ctx=ctx_of_clip[lo:hi],
        )
    np.save(out_dir / "contexts.npy", contexts)

    meta = DatasetMeta(
        num_clips=len(images),
        latent_shape=tuple(mean_all.shape[1:]),
        context_shape=tuple(contexts.shape[1:]),
        scaling_factor=float(pipeline.bundle.vae_config.scaling_factor),
        num_shards=num_shards,
        prompts=tuple(unique_prompts),
        params={
            k: v for k, v in dataclasses.asdict(params).items()
            if not isinstance(v, (list, dict)) or v
        },
    )
    with open(out_dir / "meta.json", "w", encoding="utf-8") as fh:
        json.dump(meta.to_json(), fh, indent=2)
    return meta


class LatentDataset:
    """Streams shuffled fixed-shape (latents, contexts) batches from a
    shard directory. Each epoch resamples the VAE posterior
    (z = mean + std * eps) and scales by the VAE scaling factor, as the
    inference path's encode does."""

    def __init__(self, root: T.Union[str, Path]):
        self.root = Path(root)
        with open(self.root / "meta.json", encoding="utf-8") as fh:
            self.meta = DatasetMeta.from_json(json.load(fh))
        self.contexts = np.load(self.root / "contexts.npy").astype(np.float32)
        means, logvars, ctxs = [], [], []
        for s in range(self.meta.num_shards):
            with np.load(self.root / f"shard_{s:05d}.npz") as z:
                means.append(z["mean"])
                logvars.append(z["logvar"])
                ctxs.append(z["ctx"])
        self.mean = np.concatenate(means).astype(np.float32)
        self.logvar = np.concatenate(logvars).astype(np.float32)
        self.ctx = np.concatenate(ctxs)
        if len(self.mean) != self.meta.num_clips:
            raise ValueError(f"{self.root}: {len(self.mean)} clips in the shards, "
                             f"{self.meta.num_clips} in meta.json")

    def __len__(self) -> int:
        return self.meta.num_clips

    def batches(
        self, batch_size: int, seed: int = 0, sample_posterior: bool = True
    ) -> T.Iterator[T.Tuple[np.ndarray, np.ndarray]]:
        """Infinite epoch-shuffled batch stream of (latents (B, h, w, c),
        contexts (B, 77, hidden)), fp32; the remainder batch of an epoch is
        dropped. Each batch is drawn inside a `riffusion.data.batch` span
        (tracing.py)."""
        if batch_size > len(self):
            raise ValueError(f"batch_size {batch_size} exceeds dataset size {len(self)}")
        rng = np.random.default_rng(seed)
        scale = self.meta.scaling_factor
        while True:
            order = rng.permutation(len(self))
            for lo in range(0, len(self) - batch_size + 1, batch_size):
                with tracing.span("riffusion.data.batch"):
                    idx = order[lo : lo + batch_size]
                    mean = self.mean[idx]
                    if sample_posterior:
                        std = np.exp(0.5 * self.logvar[idx])
                        z = mean + std * rng.standard_normal(mean.shape).astype(np.float32)
                    else:
                        z = mean
                    batch = z * scale, self.contexts[self.ctx[idx]]
                yield batch
