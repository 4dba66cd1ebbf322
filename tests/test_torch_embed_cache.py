"""
The port's text-embedding disk cache (riffusion_tpu_torch/embed_cache.py)
and what keys it: ModelBundle.checkpoint_id against the JAX package's
strings, the store's round trip, key sensitivity, corrupt-entry recovery and
the disable switch (as tests/test_embed_cache.py holds the JAX package's),
the pipeline's wiring (a fresh pipeline serves its prompts from disk,
bit-equal, without touching the text encoder, and the embeddings equal the
JAX package's on the same weights), and warmstart_report's keys on the CPU
(JAX's keys among them, from a CPU run of its own report).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import jax_twin, torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import riffusion_pipeline as jax_pipeline
from riffusion_tpu.models import weights as jax_weights
from riffusion_tpu_torch import embed_cache
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models import weights
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

CPU = torch.device("cpu")


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "embeds"
    monkeypatch.setenv("RIFFUSION_TPU_EMBED_CACHE_DIR", str(d))
    monkeypatch.delenv("RIFFUSION_TPU_NO_EMBED_CACHE", raising=False)
    return d


@pytest.fixture(scope="module")
def jax_tiny():
    return jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")


# ------------------------------------------------------------ checkpoint_id


def test_random_checkpoint_id_is_the_jax_string(jax_tiny):
    """random:{size}:s{seed}:{dtype}, the JAX package's form, with numpy's
    dtype names."""
    ours = weights.load_bundle("random:tiny", device="cpu")
    assert ours.checkpoint_id == jax_tiny.bundle.checkpoint_id == "random:tiny:s0:float32"
    bf16 = weights.random_bundle("tiny", seed=3, device="cpu", dtype=torch.bfloat16)
    assert bf16.checkpoint_id == "random:tiny:s3:bfloat16"
    assert weights.dtype_name(torch.float16) == jnp.dtype(jnp.float16).name


def test_directory_checkpoint_id(tmp_path):
    """dir:{hash}:{dtype}: the JAX package's digest of the path and each
    file's relative path, size and mtime_ns, so the same string for the same
    files; it changes when a file is rewritten. Every directory loader sets
    it."""
    bundle = weights.load_bundle("random:tiny", device="cpu")
    root = tmp_path / "native"
    weights.save_native(bundle, root)
    loaded = weights.load_bundle(str(root), device="cpu")
    assert loaded.checkpoint_id == weights._dir_identity(root, torch.float32)
    assert loaded.checkpoint_id == jax_weights._dir_identity(str(root), jnp.float32)
    assert loaded.checkpoint_id.startswith("dir:") and loaded.checkpoint_id.endswith(":float32")
    assert weights._dir_identity(root, torch.bfloat16).endswith(":bfloat16")
    assert weights.load_bundle(str(root), device="cpu").checkpoint_id == loaded.checkpoint_id
    unet = root / "unet.pt"
    stat = os.stat(unet)
    unet.write_bytes(unet.read_bytes())
    os.utime(unet, ns=(stat.st_atime_ns, stat.st_mtime_ns + 1_000_000))
    assert weights._dir_identity(root, torch.float32) != loaded.checkpoint_id


def test_bundle_from_jax_params_has_no_checkpoint_id(jax_tiny):
    """A bundle built directly from parameter trees is not cached (as the
    JAX package's direct bundles), and its device must be named."""
    with pytest.raises(TypeError):
        weights.bundle_from_jax_params("tiny", jax_tiny.unet_params, jax_tiny.vae_params,
                                       jax_tiny.clip_params)
    bundle = weights.bundle_from_jax_params("tiny", jax_tiny.unet_params, jax_tiny.vae_params,
                                            jax_tiny.clip_params, device="cpu")
    assert bundle.checkpoint_id == ""


# ------------------------------------------------------------------- store


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_roundtrip_preserves_value_and_dtype(cache_dir, dtype):
    value = (torch.arange(12, dtype=torch.float32).reshape(1, 3, 4) / 7).to(dtype)
    key = embed_cache.entry_key("ckpt", dtype, "plain", "funk bassline", device=CPU)
    assert embed_cache.get(key) is None
    embed_cache.put(key, value)
    out = embed_cache.get(key)
    assert out is not None and out.dtype == dtype and out.device == CPU
    assert torch.equal(out, value)
    with np.load(cache_dir / (key + ".npz")) as z:  # fp32 value and the dtype's name
        assert z["value"].dtype == np.float32 and str(z["dtype"]) == str(dtype)[6:]


def test_key_sensitivity():
    base = embed_cache.entry_key("ckpt", torch.float32, "plain", "jazz piano", device=CPU)
    assert embed_cache.entry_key("ckpt", torch.float32, "plain", "jazz piano",
                                 device="cpu") == base
    for other in (
        embed_cache.entry_key("ckpt2", torch.float32, "plain", "jazz piano", device=CPU),
        embed_cache.entry_key("ckpt", torch.bfloat16, "plain", "jazz piano", device=CPU),
        embed_cache.entry_key("ckpt", torch.float32, "weighted", "jazz piano", device=CPU),
        embed_cache.entry_key("ckpt", torch.float32, "uncond:2", "jazz piano", device=CPU),
        embed_cache.entry_key("ckpt", torch.float32, "plain", "jazz  piano", device=CPU),
    ):
        assert other != base
    fp = embed_cache.fingerprint(CPU)
    assert torch.__version__ in fp and fp.endswith("|cpu")
    with pytest.raises(TypeError):
        embed_cache.entry_key("ckpt", torch.float32, "plain", "x")  # the device is named


def test_corrupt_entry_is_dropped_not_fatal(cache_dir):
    key = embed_cache.entry_key("ckpt", torch.float32, "plain", "x", device=CPU)
    embed_cache.put(key, torch.ones(1, 2, 3))
    path = cache_dir / (key + ".npz")
    path.write_bytes(b"not an npz")
    assert embed_cache.get(key) is None  # a soft miss
    assert not path.exists()  # the corrupt entry is removed
    embed_cache.put(key, torch.ones(1, 2, 3))
    assert embed_cache.get(key) is not None
    # an entry naming no dtype is corrupt too
    with open(path, "wb") as f:
        np.savez(f, value=np.ones(3, np.float32), dtype=np.str_("nonsense"))
    assert embed_cache.get(key) is None and not path.exists()


def test_failed_write_is_not_fatal(tmp_path, monkeypatch, caplog):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("RIFFUSION_TPU_EMBED_CACHE_DIR", str(blocker / "sub"))
    embed_cache.put("k", torch.ones(2))
    assert "write failed" in caplog.text
    assert embed_cache.get("k") is None


def test_disabled_by_env(cache_dir, monkeypatch):
    monkeypatch.setenv("RIFFUSION_TPU_NO_EMBED_CACHE", "1")
    key = embed_cache.entry_key("ckpt", torch.float32, "plain", "x", device=CPU)
    embed_cache.put(key, torch.ones(1, 2, 3))
    assert embed_cache.get(key) is None
    assert not cache_dir.exists()


# --------------------------------------------------------- the pipeline


def _fail(*args, **kwargs):
    pytest.fail("the disk cache missed")


def test_fresh_pipeline_serves_every_kind_from_disk(cache_dir, monkeypatch):
    """The plain, weighted and multi-chunk unconditional embeddings of a
    first pipeline are read back by a second without its text encoder,
    bit-equal, counted as hits."""
    long_prompt = " ".join(f"w{i}" for i in range(90))  # two chunks: uncond:2
    first = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    ref = (first.embed_text("church bells"), first.embed_text_weighted("(organ:1.3)"),
           first.embed_text_weighted(long_prompt), first._uncond_embedding("hiss", 154))
    assert first.embed_cache_counts == {"hits": 0, "misses": 4}
    assert len(list(cache_dir.glob("*.npz"))) == 4

    second = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    monkeypatch.setattr(second.text_encoder, "forward", _fail)
    out = (second.embed_text("church bells"), second.embed_text_weighted("(organ:1.3)"),
           second.embed_text_weighted(long_prompt), second._uncond_embedding("hiss", 154))
    for a, b in zip(ref, out):
        assert b.dtype == a.dtype and b.device == a.device
        assert torch.equal(a, b)
    assert second.embed_cache_counts == {"hits": 4, "misses": 0}


def test_disk_cached_embeddings_match_jax(cache_dir, jax_tiny):
    """On the JAX package's weights (with the JAX bundle's checkpoint id, so
    the cache is on), the embeddings that come back from disk equal the JAX
    package's: 1e-5, float32 through the same CLIP."""
    def pipe():
        bundle = weights.bundle_from_jax_params(
            "tiny", jax_tiny.unet_params, jax_tiny.vae_params, jax_tiny.clip_params, device="cpu")
        bundle.checkpoint_id = jax_tiny.bundle.checkpoint_id
        return RiffusionPipeline(bundle, device="cpu")

    pipe().embed_text_weighted("church bells")
    warm = pipe()
    emb = warm.embed_text_weighted("church bells")
    assert warm.embed_cache_counts == {"hits": 1, "misses": 0}
    ref = np.asarray(jax_tiny.embed_text_weighted("church bells"))
    np.testing.assert_allclose(emb.numpy(), ref, rtol=0, atol=1e-5)


def test_warmstart_report_on_the_cpu(cache_dir):
    """The port's stages (no trace, lower, compile or executable load; on
    the CPU the program runs eagerly, so no warm-up or capture either), and
    a second fresh load whose prompts all come from the disk cache."""
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    inputs = InferenceInput(start=PromptInput(prompt="a", seed=1, negative_prompt="hiss"),
                            end=PromptInput(prompt="b", seed=2), alpha=0.5,
                            num_inference_steps=2)
    params = SpectrogramParams(num_frequencies=64)
    reports = [RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
               .warmstart_report(inputs, image, params=params) for _ in range(2)]
    for report in reports:
        assert set(report) == {"host_prep_s", "weights_ready_s", "kernel_build_s",
                               "kernel_source", "source", "warmup_s", "capture_s", "execute_s",
                               "embed_cache_hits", "embed_cache_misses", "trace_lower_s",
                               "compile_s", "aot_load_s"}
        assert report["kernel_source"] == "none" and report["kernel_build_s"] == 0.0
        assert (report["source"], report["warmup_s"], report["capture_s"]) == ("eager", 0.0, 0.0)
        assert (report["trace_lower_s"], report["compile_s"], report["aot_load_s"]) == \
            (0.0, 0.0, 0.0)
        assert all(report[k] >= 0 for k in ("host_prep_s", "weights_ready_s", "execute_s"))
    assert (reports[0]["embed_cache_hits"], reports[0]["embed_cache_misses"]) == (0, 3)
    assert (reports[1]["embed_cache_hits"], reports[1]["embed_cache_misses"]) == (3, 0)
    jax_report_keys = {"host_prep_s", "weights_ready_s", "execute_s"}
    assert jax_report_keys <= set(reports[0])


def test_warmstart_report_carries_the_jax_keys(jax_tiny, cache_dir):
    """Every key of JAX's warmstart_report (a CPU run of the JAX package's
    own, on random:tiny: its plain-jit branch) is in the port's, and the
    keys JAX's store branch adds (source, aot_load_s) too, so a caller
    written against JAX's report (bench.py reads trace_lower_s and
    compile_s) reads the port's."""
    rng = np.random.default_rng(1)
    image = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
    inputs = InferenceInput(start=PromptInput(prompt="a", seed=1), end=PromptInput(prompt="b",
                            seed=2), alpha=0.5, num_inference_steps=2)
    params = SpectrogramParams(num_frequencies=64)
    jax_report = jax_tiny.warmstart_report(jax_twin(inputs), image, params=jax_twin(params))
    jax_store_keys = {"source", "aot_load_s"}  # riffusion_tpu/riffusion_pipeline.py:587-602
    assert {"trace_lower_s", "compile_s", "execute_s"} <= set(jax_report)
    ours = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu").warmstart_report(
        inputs, image, params=params)
    assert set(jax_report) | jax_store_keys <= set(ours)

