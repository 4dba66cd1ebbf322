"""
The dynamic batcher (riffusion_tpu_torch/serving.py, the JAX package's
DynamicBatcher re-exported) over the port's tiny pipeline on the CPU:
concurrent submits coalesce into one padded launch, the FAST preset routes
each strength to its sampler and step count, a batch of one takes the
single path with the resolved scheduler, and the async finalize hands every
caller its own result.
"""

import threading

import numpy as np
import pytest
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import serving as jax_serving
from riffusion_tpu.datatypes import InferenceInput, PromptInput
from riffusion_tpu.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch import serving
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

SIZE = 64
PARAMS = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=SIZE)


class Recorder:
    """The port's pipeline, recording each call's entry point, batch size,
    scheduler and step count."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.calls = []

    def riffuse_audio(self, inputs, **kw):
        self.calls.append(("single", 1, kw.get("scheduler"), inputs.num_inference_steps))
        return self.pipe.riffuse_audio(inputs, **kw)

    def riffuse_audio_batch(self, inputs_list, **kw):
        self.calls.append(("batch", len(inputs_list), kw.get("scheduler"),
                           inputs_list[0].num_inference_steps))
        return self.pipe.riffuse_audio_batch(inputs_list, **kw)


@pytest.fixture(scope="module")
def pipe():
    return RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")


@pytest.fixture(scope="module")
def seed_image():
    rng = np.random.default_rng(0)
    return Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8), mode="RGB")


def _request(seed, denoising=0.75, steps=3):
    return InferenceInput(start=PromptInput(prompt="church bells", seed=seed, denoising=denoising),
                          end=PromptInput(prompt="techno", seed=seed + 100, denoising=denoising),
                          alpha=0.5, num_inference_steps=steps)


def _submit_all(batcher, requests, seed_image):
    """Submit concurrently, one thread each; return the results in order."""
    results = [None] * len(requests)

    def run(i):
        results[i] = batcher.submit(requests[i], seed_image, None, PARAMS,
                                    seed_image_id="og_beat", mask_image_id=None)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return results


def test_reexports_are_the_jax_packages_host_code():
    for name in serving.__all__:
        assert getattr(serving, name) is getattr(jax_serving, name)
    assert serving.preset_for_strength(0.75) == {"scheduler": "unipc_k:rho=2", "steps": 16}
    assert serving.preset_for_strength(0.65) == {"scheduler": "dpmpp", "steps": 24}


def test_concurrent_submits_coalesce_into_one_padded_launch(pipe, seed_image):
    rec = Recorder(pipe)
    batcher = serving.DynamicBatcher(rec, max_batch=8, window_ms=1500)
    try:
        results = _submit_all(batcher, [_request(s) for s in (1, 2, 3)], seed_image)
    finally:
        batcher.shutdown()
    assert rec.calls == [("batch", 4, None, 3)]  # 3 requests padded to bucket 4
    assert batcher.stats["launches"] == 1 and batcher.stats["batched_requests"] == 3
    assert batcher.stats["padded_slots"] == 1 and batcher.stats["pipelined_finalizes"] == 1
    images = [np.asarray(image) for image, _ in results]
    assert all(im.shape == (SIZE, SIZE, 3) for im in images)
    assert all(segment.duration_seconds > 0 for _, segment in results)
    # each caller got its own request's result, not a neighbour's
    assert not np.array_equal(images[0], images[1]) and not np.array_equal(images[1], images[2])


def test_fast_preset_routes_by_strength(pipe, seed_image):
    """Strength 0.75 runs unipc_k:rho=2 at 16 steps; 0.65 runs dpmpp at 24.
    The two strengths never share a launch; a lone request takes the single
    path with its resolved scheduler."""
    rec = Recorder(pipe)
    preset = serving.FAST_PRESET
    batcher = serving.DynamicBatcher(rec, max_batch=8, window_ms=1500,
                                     scheduler=preset["scheduler"],
                                     steps_override=preset["steps"], strength_gated=True)
    try:
        _submit_all(batcher, [_request(1), _request(2), _request(3, denoising=0.65)], seed_image)
    finally:
        batcher.shutdown()
    assert sorted(rec.calls) == [("batch", 2, "unipc_k:rho=2", 16), ("single", 1, "dpmpp", 24)]
    assert batcher.stats["requests"] == 3 and batcher.stats["launches"] == 2


def test_batch_of_one_takes_the_single_path(pipe, seed_image):
    rec = Recorder(pipe)
    batcher = serving.DynamicBatcher(rec, max_batch=8, window_ms=10, scheduler="dpmpp")
    try:
        (image, segment), = _submit_all(batcher, [_request(5)], seed_image)
    finally:
        batcher.shutdown()
    assert rec.calls == [("single", 1, "dpmpp", 3)]
    assert np.asarray(image).shape == (SIZE, SIZE, 3) and segment.duration_seconds > 0
