"""
Dynamic request batching for the port's server.

The batcher is the JAX package's own: riffusion_tpu/serving.py is host code
(threads, queues, PIL) that imports no JAX, and it drives any pipeline with
`riffuse_audio(..., scheduler=...)` and `riffuse_audio_batch(...,
async_dispatch=True)`. The port's RiffusionPipeline has both; what CUDA
needs differently (the readback into pinned memory behind an event, so the
finalizer thread waits for its own batch only) lives in that pipeline's
`finalize`. So this module re-exports it rather than keeping a second copy:

- `DynamicBatcher`: concurrent requests queue up; one worker thread
  coalesces those with the same program signature (seed image, mask, steps,
  strength to 3 decimals, resolved scheduler) into one batched call, padded
  to a bucket (1/2/4/8/16) by repeating the tail request; a finalizer
  thread reads back batch N while the worker queues batch N+1.
- `FAST_PRESET` (`unipc_k:rho=2`, 16 steps), gated on strength
  `FAST_PRESET_GATED_STRENGTH` (0.75) by `preset_for_strength`, which sends
  other strengths to `FAST_PRESET_OFFGATE` (`dpmpp`, 24 steps).
- `load_seed_image`.

The bucket cap (16, `max_batch` 8 by default) is the JAX package's, set by
a TPU v5e's memory; re-deriving it for the H100 is open work.
"""

from riffusion_tpu.serving import (
    FAST_PRESET,
    FAST_PRESET_GATED_STRENGTH,
    FAST_PRESET_OFFGATE,
    DynamicBatcher,
    load_seed_image,
    preset_for_strength,
)

__all__ = [
    "DynamicBatcher", "FAST_PRESET", "FAST_PRESET_GATED_STRENGTH", "FAST_PRESET_OFFGATE",
    "load_seed_image", "preset_for_strength",
]
