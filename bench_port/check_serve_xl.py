"""
What decides `correct` in an SDXL serving cell: a sample of the window's
clips, drawn from the seed, against the plain SDXL reference
(reference/sdxl.py), computed in float32 with TF32 off from the same
weights and requests once the program's memory is freed. The numbers and
their definitions are check_serve.py's: image_gap (the request end to end
up to its image: both towers, the VAE encode and its posterior sample, the
seed-noise slerp, Euler's img2img start and steps with the UNet and K1, the
VAE decode) and audio_gap (the DSP on the served image).

The limits are the cell's (`check.limits` of workloads/<cell>.json);
PERF.md gives the readings each was set from.
"""

from __future__ import annotations

import typing as T

import numpy as np

from bench_port import check_serve, harness, sut_xl
from bench_port.reference import riffuse, sd, sdxl


def reference_weights(config, states) -> sdxl.Weights:
    return sdxl.Weights(**{m: sd.widened(states[m]) for m in sut_xl.MODELS}, config=config)


def readings(weights: sdxl.Weights, params, bodies: T.Mapping[T.Tuple, dict],
             served: T.Mapping[T.Tuple, T.Tuple[np.ndarray, np.ndarray]],
             keys: T.Sequence[T.Tuple]) -> T.Dict[str, float]:
    """The worst image_gap and audio_gap over `keys`."""
    device = next(iter(weights.unet.values())).device
    seed_image = sut_xl.seed_image(params)
    gaps = {"image_gap": 0.0, "audio_gap": 0.0}
    for key in keys:
        body = bodies[key]
        image, samples = served[key]
        ref = sdxl.image(weights, body, seed_image, params["num_inference_steps"])
        gaps["image_gap"] = max(gaps["image_gap"], check_serve.image_gap(image, ref))
        gaps["audio_gap"] = max(gaps["audio_gap"],
                                check_serve.audio_gap(samples, riffuse.audio(image, body, device)))
    return gaps


def check(record: harness.Record, states, bodies, served) -> None:
    limits = record.cell["check"]["limits"]
    keys = check_serve.sample(list(bodies), record.seed, record.cell["check"]["sample"])
    record.notes["checked_clips"] = len(keys)
    if not keys:
        record.checks = [harness.Check("clips_checked", 0.0, -1.0)]
        return
    gaps = readings(reference_weights(record.config, states), record.cell["params"], bodies,
                    served, keys)
    record.notes["readings"] = gaps
    record.checks = [harness.Check(name, value, limits[name]) for name, value in gaps.items()]
