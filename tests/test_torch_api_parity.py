"""
The port's loaders and batch entry point take the JAX package's parameters,
by keyword and in JAX's positional order, on random:tiny on the CPU, in
both packages: `RiffusionPipeline.load_checkpoint` (use_traced_unet,
channels_last, local_files_only and cache_dir accepted and dropped),
`load_bundle(checkpoint, dtype, seed)`, `build_latent_dataset(..., seed)`
and `riffuse_audio_batch` with `mesh=None` and `async_dispatch` in its
positional place (after `mesh`). Before the repair each call raised in the
port or put an argument in the wrong slot.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import jax_twin, torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import riffusion_pipeline as jax_pipeline
from riffusion_tpu.models import weights as jax_weights
from riffusion_tpu.training import dataset as jax_dataset
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models import weights
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.training import dataset

SIZE = 64
PARAMS = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=SIZE)


def _names(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("fn", ["load_checkpoint", "riffuse_audio_batch"])
def test_signatures_follow_jax_order(fn):
    """The port's parameters start with JAX's, in JAX's order (the port's
    keyword-only `noises` follows)."""
    theirs = _names(getattr(jax_pipeline.RiffusionPipeline, fn))
    ours = _names(getattr(RiffusionPipeline, fn))
    assert ours[:len(theirs)] == theirs


def test_loader_signatures_follow_jax_order():
    assert _names(weights.load_bundle)[:3] == _names(jax_weights.load_bundle) \
        == ["checkpoint", "dtype", "seed"]
    theirs = _names(jax_dataset.build_latent_dataset)
    assert _names(dataset.build_latent_dataset) == theirs and theirs[-1] == "seed"


@pytest.mark.parametrize("how", ["keywords", "positional"])
def test_load_checkpoint_takes_jax_arguments(how):
    """Every JAX parameter by keyword, then all eight in JAX's order: the
    four dropped knobs land where JAX puts them, and the device and the
    scheduler reach theirs."""
    kw = dict(checkpoint="random:tiny", use_traced_unet=False, channels_last=True, dtype=None,
              device="cpu", local_files_only=True, cache_dir=None, scheduler="ddim")
    for package in (jax_pipeline.RiffusionPipeline, RiffusionPipeline):
        if how == "keywords":
            pipe = package.load_checkpoint(**kw)
        else:
            pipe = package.load_checkpoint(*kw.values())
        assert pipe.bundle.scheduler_name == "ddim"
    # load_checkpoint(ckpt, False): False is use_traced_unet, not the dtype
    pipe = RiffusionPipeline.load_checkpoint("random:tiny", False, device="cpu")
    assert pipe.bundle.dtype == torch.float32


def test_load_bundle_takes_a_seed():
    """seed=3 gives both packages the checkpoint_id random:tiny:s3:float32
    and weights other than seed 0's; dtype in JAX's second place."""
    theirs = jax_weights.load_bundle("random:tiny", jnp.float32, 3)
    ours = weights.load_bundle("random:tiny", torch.float32, 3, device="cpu")
    assert ours.checkpoint_id == theirs.checkpoint_id == "random:tiny:s3:float32"
    seed0 = weights.load_bundle("random:tiny", torch.float32, device="cpu")
    assert seed0.checkpoint_id == "random:tiny:s0:float32"
    a, b = ours.unet.state_dict(), seed0.unet.state_dict()
    assert not torch.equal(a["conv_in.weight"], b["conv_in.weight"])
    again = weights.load_bundle("random:tiny", seed=3, device="cpu").unet.state_dict()
    assert torch.equal(again["conv_in.weight"], a["conv_in.weight"])


def test_build_latent_dataset_takes_a_seed(tmp_path):
    """Both packages' build_latent_dataset with JAX's reserved seed, on one
    0.64 s clip: the same shard layout."""
    audio = tmp_path / "audio"
    audio.mkdir()
    t = np.arange(int(44100 * 0.7)) / 44100
    AudioSegment((np.sin(2 * np.pi * 440 * t) * 12000).astype(np.int16), 44100).export(
        str(audio / "a.wav"))
    jp = jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    tp = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    kw = dict(clip_duration_ms=640, seed=5)
    theirs = jax_dataset.build_latent_dataset(jp, audio, tmp_path / "jax", params=jax_twin(PARAMS),
                                              **kw)
    ours = dataset.build_latent_dataset(tp, audio, tmp_path / "port", params=PARAMS, **kw)
    assert ours.num_clips == theirs.num_clips == 1
    assert ours.latent_shape == theirs.latent_shape and ours.num_shards == theirs.num_shards


def _requests():
    return [InferenceInput(start=PromptInput(prompt=f"bells {i}", seed=i, guidance=1.5),
                           end=PromptInput(prompt="techno", seed=10 + i, guidance=1.5),
                           alpha=0.25 * i, num_inference_steps=2) for i in range(2)]


def test_riffuse_audio_batch_positional_async_after_mesh():
    """(inputs, image, params, use_reweighting, apply_filters, mesh,
    async_dispatch): True in the seventh place asks both packages for a
    finalize, and mesh=None runs the batch on one device."""
    image = Image.fromarray(np.random.default_rng(0).integers(0, 255, (SIZE, SIZE, 3),
                                                              dtype=np.uint8))
    jp = jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    tp = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    finals = [
        jp.riffuse_audio_batch([jax_twin(x) for x in _requests()], image, jax_twin(PARAMS),
                               True, False, None, True),
        tp.riffuse_audio_batch(_requests(), image, PARAMS, True, False, None, True),
    ]
    for finalize in finals:
        assert callable(finalize)
        results = finalize()
        assert len(results) == 2
        for img, segment in results:
            assert img.size == (SIZE, SIZE) and segment.frame_rate == 44100
    sync = tp.riffuse_audio_batch(_requests(), image, params=PARAMS, mesh=None)
    assert isinstance(sync, list) and len(sync) == 2
