"""
What decides `correct` in a serving cell: a sample of the window's clips,
drawn from the seed, against the plain reference (reference/riffuse.py),
computed in float32 with TF32 off from the same weights and requests once
the program's memory is freed.

Two numbers, each the worst over the sampled clips:

- image_gap: the mean absolute difference, in uint8 levels, between the
  served spectrogram image and the reference's. It covers the request end
  to end up to the image: CLIP, the VAE encode and its posterior sample,
  the seed-noise slerp, the img2img start, the sampler's steps with the
  UNet and its attention kernels, and the VAE decode.
- audio_gap: the distance between the served clip's samples and the
  reference's audio tail run on the served image (inverse mel, Griffin-Lim
  with the request's phase draws, int16, riffusion's filters), each scaled
  to unit norm. It follows the program from its own image, so that it
  judges the DSP alone; image_gap judges what comes before.

The limits are the cell's (`check.limits` of workloads/<cell>.json); PERF.md
gives the readings each was set from.
"""

from __future__ import annotations

import typing as T

import numpy as np
from PIL import Image

from bench_port import harness, sut
from bench_port.reference import riffuse, sd


def image_gap(served: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(served.astype(np.float64) - ref.astype(np.float64)).mean())


def audio_gap(served: np.ndarray, ref: np.ndarray) -> float:
    a, b = served.astype(np.float64).ravel(), ref.astype(np.float64).ravel()
    if a.shape != b.shape:
        return float("inf")
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return float("inf")
    return float(np.linalg.norm(a / na - b / nb))


def sample(keys: T.Sequence[T.Tuple], seed: int, k: int) -> T.List[T.Tuple]:
    keys = sorted(keys)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 7])
    return [keys[i] for i in sorted(rng.choice(len(keys), size=min(k, len(keys)),
                                               replace=False))]


def reference_weights(config, states) -> riffuse.Weights:
    return riffuse.Weights(unet=sd.widened(states["unet"]), vae=sd.widened(states["vae"]),
                           clip=sd.widened(states["text_encoder"]), config=config)


def readings(weights: riffuse.Weights, bodies: T.Mapping[T.Tuple, dict],
             served: T.Mapping[T.Tuple, T.Tuple[np.ndarray, np.ndarray]],
             keys: T.Sequence[T.Tuple], steps: int) -> T.Dict[str, float]:
    """The worst image_gap and audio_gap over `keys`."""
    device = next(iter(weights.unet.values())).device
    gaps = {"image_gap": 0.0, "audio_gap": 0.0}
    for key in keys:
        body = bodies[key]
        seed_image = np.asarray(Image.open(sut.INPUTS / f"{body['seed_image_id']}.png")
                                .convert("RGB"))
        image, samples = served[key]
        gaps["image_gap"] = max(gaps["image_gap"],
                                image_gap(image, riffuse.image(weights, body, seed_image, steps)))
        gaps["audio_gap"] = max(gaps["audio_gap"],
                                audio_gap(samples, riffuse.audio(image, body, device)))
    return gaps


def check(record: harness.Record, states, bodies, served) -> None:
    limits = record.cell["check"]["limits"]
    keys = sample(list(bodies), record.seed, record.cell["check"]["sample"])
    record.notes["checked_clips"] = len(keys)
    if not keys:
        record.checks = [harness.Check("clips_checked", 0.0, -1.0)]
        return
    gaps = readings(reference_weights(record.config, states), bodies, served, keys,
                    record.cell["params"]["num_inference_steps"])
    record.checks = [harness.Check(name, value, limits[name]) for name, value in gaps.items()]
