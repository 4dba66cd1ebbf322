"""
The port's checkpoint loading (riffusion_tpu_torch/models/weights.py and its
readers, models/formats.py) against the JAX package's loaders on the CPU:

- the tiny diffusers-layout checkpoint that tests/test_checkpoint_fixture.py
  writes on the spot (torch .bin files, a real transformers CLIP, a BPE
  vocabulary, an EulerDiscreteScheduler config), and the same checkpoint
  re-written as safetensors in fp32, fp16 and bf16 with the old and the new
  VAE attention names;
- the renames at full SD v1 width, on the meta device;
- directories written by the JAX package's `save_native` (flax msgpack) in
  fp32 and bf16;
- the two readers against `safetensors` and `flax.serialization`, and each
  refusal;
- the server and `run_finetune` from a diffusers directory.

Every state dict comparison is exact (torch.equal): loading moves and casts
weights, it computes nothing.
"""

import dataclasses
import json
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from test_checkpoint_fixture import tiny_diffusers_checkpoint  # noqa: F401  (fixture)
import test_weight_conversion as twc
from riffusion_tpu.models import weights as jax_weights
from riffusion_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from riffusion_tpu.models.clip import CLIPTextModel as JaxCLIP
from riffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from riffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from riffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from riffusion_tpu.models.vae import VAEConfig as JaxVAEConfig
from riffusion_tpu_torch.models import formats, weights
from riffusion_tpu_torch.models.clip import CLIPTextConfig
from riffusion_tpu_torch.models.unet import UNetConfig
from riffusion_tpu_torch.models.vae import VAEConfig

safetensors_torch = pytest.importorskip("safetensors.torch")
serialization = pytest.importorskip("flax.serialization")

PROMPTS = ("hello", "church bells, techno", "")


def _numpy_f32(tree):
    """A JAX parameter tree as float32 numpy (bf16 widens exactly)."""
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32), tree)


def _jax_reference(jb):
    """from_jax_params of a JAX bundle's three trees, in float32."""
    return weights.from_jax_params(*(_numpy_f32(t) for t in
                                     (jb.unet_params, jb.vae_params, jb.clip_params)))


def _port_states(bundle):
    return [m.state_dict() for m in (bundle.unet, bundle.vae, bundle.text_encoder)]


def _assert_states_equal(port, ref, dtypes=(torch.float32,) * 3):
    """Exact equality, key for key; `ref` cast to each module's dtype first
    (the loader casts the file's values the same way)."""
    for name, got, want, dtype in zip(("unet", "vae", "clip"), port, ref, dtypes):
        assert set(got) == set(want), name
        for key, value in want.items():
            assert got[key].dtype == dtype, (name, key)
            assert torch.equal(got[key], value.to(dtype)), (name, key)


def _port_config(cfg):
    """The JAX config's fields that the port's config has (not sample_size)."""
    fields = dataclasses.asdict(cfg)
    fields.pop("sample_size", None)
    return fields


# ------------------------------------------------------- the diffusers fixture


def test_diffusers_fixture_matches_jax(tiny_diffusers_checkpoint):  # noqa: F811
    root, _ = tiny_diffusers_checkpoint
    jb = jax_weights.load_diffusers_checkpoint(str(root), dtype=jnp.float32)
    pb = weights.load_bundle(str(root), device="cpu")
    _assert_states_equal(_port_states(pb), _jax_reference(jb))
    assert dataclasses.asdict(pb.unet.cfg) == _port_config(jb.unet_config)
    assert dataclasses.asdict(pb.vae.cfg) == _port_config(jb.vae_config)
    assert dataclasses.asdict(pb.text_encoder.cfg) == _port_config(jb.clip_config)
    assert pb.scheduler_name == jb.scheduler_name == "euler"
    assert type(pb.tokenizer).__name__ == "CLIPTokenizer"
    for prompt in PROMPTS:
        assert pb.tokenizer(prompt)["input_ids"] == jb.tokenizer(prompt)["input_ids"]


def _rewrite(src, dst, dtype, old_vae_names):
    """The fixture's checkpoint with every model as safetensors in `dtype`
    (CLIP's with an int64 position_ids), the VAE's attention under the old
    or the new names."""
    shutil.copytree(src, dst)
    old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    for folder, bin_name, st_name in (
        ("unet", "diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors"),
        ("vae", "diffusion_pytorch_model.bin", "diffusion_pytorch_model.safetensors"),
        ("text_encoder", "pytorch_model.bin", "model.safetensors"),
    ):
        state = torch.load(dst / folder / bin_name, weights_only=True)
        (dst / folder / bin_name).unlink()
        out = {}
        for key, value in state.items():
            if folder == "vae" and old_vae_names and ".attentions.0." in key:
                for new, name in old.items():
                    key = key.replace(f".attentions.0.{new}.", f".attentions.0.{name}.")
            out[key] = value.to(dtype) if value.is_floating_point() else value
        if folder == "text_encoder":  # as older transformers saved it: int64, skipped
            out.setdefault("text_model.embeddings.position_ids", torch.arange(77)[None])
        safetensors_torch.save_file(out, str(dst / folder / st_name))
    return dst


@pytest.mark.parametrize("old_vae_names", [False, True], ids=["vae-new", "vae-old"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16],
                         ids=["fp32", "fp16", "bf16"])
def test_safetensors_checkpoint_matches_jax(tiny_diffusers_checkpoint, tmp_path,  # noqa: F811
                                            dtype, old_vae_names):
    """The rewritten checkpoint loads to the fixture's weights rounded to the
    file's dtype, exactly. fp32 and fp16 are also loaded by the JAX package
    (its safetensors reader has no bfloat16), which must agree."""
    root, _ = tiny_diffusers_checkpoint
    ref = _jax_reference(jax_weights.load_diffusers_checkpoint(str(root), dtype=jnp.float32))
    ref = [{k: v.to(dtype) for k, v in sd.items()} for sd in ref]
    d = _rewrite(root, tmp_path / "ckpt", dtype, old_vae_names)
    port = _port_states(weights.load_bundle(str(d), device="cpu"))
    _assert_states_equal(port, ref)
    if dtype != torch.bfloat16:
        jb = jax_weights.load_diffusers_checkpoint(str(d), dtype=jnp.float32)
        _assert_states_equal(port, _jax_reference(jb))
    # a bf16 bundle keeps bf16 weights bit for bit; the VAE stays fp32
    if dtype == torch.bfloat16:
        pb = weights.load_bundle(str(d), device="cpu", dtype=torch.bfloat16)
        _assert_states_equal(_port_states(pb), ref,
                             (torch.bfloat16, torch.float32, torch.bfloat16))


def _jax_flax_shapes(cfg, kind):
    """The JAX module's parameter tree shapes (eval_shape: no compile)."""
    key = jax.random.PRNGKey(0)
    if kind == "unet":
        m = JaxUNet(cfg, dtype=jnp.float32)
        args = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                jnp.zeros((1, 77, cfg.cross_attention_dim)))
    elif kind == "vae":
        m = JaxVAE(cfg, dtype=jnp.float32)
        args = (jnp.zeros((1, 64, 64, 3)), key)
    else:
        m = JaxCLIP(cfg, dtype=jnp.float32)
        args = (jnp.zeros((1, 77), jnp.int32),)
    return twc._flatten(jax.eval_shape(lambda: m.init(key, *args))["params"])


@pytest.mark.parametrize("kind", ["unet", "vae", "clip"])
def test_full_width_keys_map_on_meta(kind):
    """Every key of a full-width diffusers checkpoint (the names
    tests/test_weight_conversion.py generates, at their torch shapes from
    the JAX modules' trees) lands on a parameter of the port's full-width
    module with its shape, and every parameter is covered. Meta tensors:
    no memory."""
    jax_cfg, keys_fn, index = {
        "unet": (JaxUNetConfig(), lambda: twc._torch_unet_keys(UNetConfig()), 0),
        "vae": (JaxVAEConfig(), lambda: twc._torch_vae_keys(VAEConfig()), 1),
        "clip": (JaxCLIPConfig(), lambda: twc._torch_clip_keys(CLIPTextConfig()), 2),
    }[kind]
    flax_shapes = _jax_flax_shapes(jax_cfg, kind)
    state = {}
    for tk, tag in keys_fn().items():
        if tag == "skip":
            state[tk] = torch.empty((1, 77), dtype=torch.int64, device="meta")
            continue
        probe = {tk: np.zeros((2, 2, 3, 3)) if tag == "conv"
                 else np.zeros((2, 2)) if tag in ("linear", "embed") else np.zeros((2,))}
        (path,) = twc._flatten(jax_weights.convert_torch_state_dict(probe, kind)).keys()
        state[tk] = torch.empty(twc._torch_shape(path, flax_shapes[path]), device="meta")
    converted, sources = weights.convert_diffusers_state_dict(state, kind)
    module = weights.build_modules("full", torch.device("meta"))[index]
    weights._check_state_dict(module, converted, kind, sources)  # raises on any mismatch
    assert len(converted) == len(module.state_dict()) == len(state) - (kind == "clip")


# ------------------------------------------------- the JAX package's export


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_native_dir(request, tmp_path_factory):
    dtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[request.param]
    jb = jax_weights.random_bundle("tiny", seed=1, dtype=dtype)
    jb = dataclasses.replace(jb, scheduler_name="lms")
    out = tmp_path_factory.mktemp(f"jax_native_{request.param}")
    jax_weights.save_native(jb, str(out))
    return out, jb, request.param


def test_jax_save_native_loads(jax_native_dir):
    """The JAX export (msgpack trees, riffusion_tpu.json) through the port's
    reader and from_jax_params: the JAX trees exactly, at float32 and, for
    the bf16 export, at bfloat16 too (the VAE in fp32)."""
    out, jb, name = jax_native_dir
    pb = weights.load_bundle(str(out), device="cpu")
    ref = _jax_reference(jb)
    _assert_states_equal(_port_states(pb), ref)
    assert pb.scheduler_name == "lms"
    assert dataclasses.asdict(pb.unet.cfg) == _port_config(jb.unet_config)
    if name == "bfloat16":
        pb = weights.load_bundle(str(out), device="cpu", dtype=torch.bfloat16)
        _assert_states_equal(_port_states(pb), ref,
                             (torch.bfloat16, torch.float32, torch.bfloat16))
        assert pb.unet.conv_in.weight.dtype == torch.bfloat16


def test_load_bundle_dispatch(jax_native_dir, tmp_path):
    """The port's own export first, then the JAX package's, then a unet/
    folder; anything else raises and names what it looked for."""
    out, _, _ = jax_native_dir
    d = tmp_path / "both"
    shutil.copytree(out, d)
    weights.save_native(weights.random_bundle("tiny", device="cpu"), d)  # beside the JAX files
    assert weights.load_bundle(str(d), device="cpu").scheduler_name == "pndm"  # the port's
    with pytest.raises(FileNotFoundError, match="riffusion_tpu.json.*diffusers-layout"):
        weights.load_bundle(str(tmp_path / "nothing"), device="cpu")


# ------------------------------------------------------------------ readers


def _synthetic_tree(rng):
    """Odd shapes and sizes: 0-d, empty, > 127 and > 65535 elements (the
    msgpack int and bin widths), a map of > 15 entries, a key > 31 bytes."""
    import ml_dtypes

    tree = {"block": {f"leaf_{i}": rng.standard_normal((i + 1, 3)).astype(np.float32)
                      for i in range(17)},
            "a_rather_long_parameter_name_beyond_31_bytes": {
                "kernel": rng.standard_normal((300, 257)).astype(np.float16)},
            "scale": np.array(rng.standard_normal(), np.float32),
            "empty": np.zeros((0, 4), np.float32),
            "bf16": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)}
    return tree


def _flat_numpy(tree, prefix=""):
    """{"a/b": leaf}: the port's tensors as they are, flax's as numpy."""
    out = {}
    for k, v in tree.items():
        out.update(_flat_numpy(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v if isinstance(v, torch.Tensor) else np.asarray(v)})
    return out


def _assert_tree_equal(port_tree, ref_tree):
    got, want = _flat_numpy(port_tree), _flat_numpy(ref_tree)
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        assert tuple(g.shape) == v.shape, k
        if v.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), v.view(np.int16))
        else:
            assert g.dtype == getattr(torch, v.dtype.name)
            np.testing.assert_array_equal(g.numpy(), v)


def test_msgpack_reader_matches_flax(tmp_path):
    tree = _synthetic_tree(np.random.default_rng(0))
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    _assert_tree_equal(formats.read_flax_msgpack(path), serialization.msgpack_restore(
        path.read_bytes()))


def test_msgpack_reader_joins_chunked_arrays(tmp_path, monkeypatch):
    """flax's chunked form (arrays over MAX_CHUNK_SIZE bytes), forced here by
    a small chunk size."""
    tree = _synthetic_tree(np.random.default_rng(1))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    assert b"__msgpack_chunked_array__" in path.read_bytes()
    _assert_tree_equal(formats.read_flax_msgpack(path), serialization.msgpack_restore(
        path.read_bytes()))


def test_safetensors_reader_matches_library(tmp_path):
    rng = np.random.default_rng(2)
    tensors = {"w32": torch.from_numpy(rng.standard_normal((300, 257)).astype(np.float32)),
               "w16": torch.from_numpy(rng.standard_normal((3, 5, 7)).astype(np.float16)),
               "wbf": torch.randn(9, 11, generator=torch.Generator().manual_seed(0)).bfloat16(),
               "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 3)}
    path = tmp_path / "t.safetensors"
    safetensors_torch.save_file(tensors, str(path), metadata={"format": "pt"})
    got, want = formats.read_safetensors(path), safetensors_torch.load_file(str(path))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ----------------------------------------------------------------- refusals


def test_refuses_unknown_dtypes_and_types(tmp_path):
    p = tmp_path / "i.safetensors"
    safetensors_torch.save_file({"ids": torch.arange(4, dtype=torch.int32)}, str(p))
    with pytest.raises(ValueError, match="'ids' has dtype I32"):
        formats.read_safetensors(p)
    cases = [({"w": np.zeros(3, np.float64)}, "dtype float64"),
             ({"w": {"x": np.zeros(2, np.float32), "lr": 0.5}}, "type float64"),
             ({"w": 1j}, r"ext type 2 \(native complex\)"),
             ({"w": np.float32(1.0)}, r"ext type 3 \(numpy scalar\)"),
             ({"w": None}, "type nil")]
    for tree, match in cases:
        p = tmp_path / "t.msgpack"
        p.write_bytes(serialization.msgpack_serialize(tree))
        with pytest.raises(ValueError, match=match):
            formats.read_flax_msgpack(p)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_refuses_weights_that_do_not_fit(tiny_diffusers_checkpoint, tmp_path, fault):  # noqa: F811
    """A missing key, an extra key or a misshapen tensor: ValueError naming
    the port's key and the file's."""
    root, _ = tiny_diffusers_checkpoint
    d = tmp_path / "bad"
    shutil.copytree(root, d)
    path = d / "unet" / "diffusion_pytorch_model.bin"
    state = torch.load(path, weights_only=True)
    victim = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    port_key = "down_blocks_0.attentions_0.blocks_0.attn1.to_q.weight"
    if fault == "missing":
        del state[victim]
        match = f"missing {port_key}"
    elif fault == "extra":
        state["down_blocks.0.resnets.0.extra.weight"] = torch.zeros(3)
        match = (r"unexpected down_blocks_0.resnets_0.extra.weight "
                 r"\(file key down_blocks.0.resnets.0.extra.weight\)")
    else:
        state[victim] = state[victim][:, :-1]
        match = f"shape of {port_key} \\(file key {victim}\\)"
    torch.save(state, path)
    with pytest.raises(ValueError, match=match):
        weights.load_bundle(str(d), device="cpu")


# ------------------------------------------------------- serving and training


@pytest.fixture(scope="module")
def ddim_checkpoint(tiny_diffusers_checkpoint, tmp_path_factory):  # noqa: F811
    """The fixture's checkpoint with its scheduler config naming DDIM."""
    root, _ = tiny_diffusers_checkpoint
    d = tmp_path_factory.mktemp("ddim") / "ckpt"
    shutil.copytree(root, d)
    (d / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"_class_name": "DDIMScheduler", "num_train_timesteps": 1000}))
    return d


def test_server_serves_with_the_checkpoints_sampler(ddim_checkpoint, tmp_path):
    """The server started with --checkpoint DIR: /run_inference/ runs the
    checkpoint's DDIM, the only plan of the request."""
    from riffusion_tpu_torch import server as server_mod

    seed_dir = tmp_path / "seeds"
    seed_dir.mkdir()
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), np.uint8)).save(
        seed_dir / "og_beat.png")
    srv = server_mod.create_app(**server_mod.parse_args(
        ["--checkpoint", str(ddim_checkpoint), "--device", "cpu", "--port", "0",
         "--seed-images-dir", str(seed_dir)]))
    pipe = server_mod.PIPELINE
    assert pipe.bundle.scheduler_name == "ddim"
    plans = []
    plan = pipe._plan
    pipe._plan = lambda *a: plans.append(plan(*a)[0].name) or plan(*a)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"start": {"prompt": "hello", "seed": 1},
                           "end": {"prompt": "techno", "seed": 2}, "alpha": 0.5,
                           "num_inference_steps": 3, "seed_image_id": "og_beat"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/run_inference/",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            out = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        server_mod.PIPELINE = None
    assert out["image"].startswith("data:image/jpeg;base64,") and out["duration_s"] > 0
    assert plans == ["ddim"]


def test_finetune_from_a_diffusers_directory(ddim_checkpoint, tmp_path):
    """run_finetune (and `cli.py finetune`) from the directory: two steps
    whose losses and exported UNet equal, bit for bit (fp32 on the CPU, the
    same code on the same numbers), those of a run from the port's export
    of the JAX package's conversion of the same directory; the export keeps
    the directory's vocabulary."""
    from riffusion_tpu_torch import cli
    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune

    jb = jax_weights.load_diffusers_checkpoint(str(ddim_checkpoint), dtype=jnp.float32)
    native = tmp_path / "native"
    weights.save_native(weights.bundle_from_jax_params(
        "tiny", *(_numpy_f32(t) for t in (jb.unet_params, jb.vae_params, jb.clip_params)),
        device="cpu"),
        native)
    (tmp_path / "audio").mkdir()
    wave = np.sin(np.arange(44100) * 2 * np.pi * 440 / 44100) * 16000
    AudioSegment(wave.astype(np.int16), 44100).export(str(tmp_path / "audio" / "a.wav"))
    pipe = RiffusionPipeline.load_checkpoint(str(ddim_checkpoint), device="cpu")
    build_latent_dataset(pipe, tmp_path / "audio", tmp_path / "ds",
                         params=SpectrogramParams(num_frequencies=64), clip_duration_ms=640)
    runs = {}
    for name, ckpt in (("diffusers", ddim_checkpoint), ("native", native)):
        runs[name] = run_finetune(FinetuneConfig(
            checkpoint=str(ckpt), dataset_dir=str(tmp_path / "ds"),
            output_dir=str(tmp_path / name), steps=2, batch_size=1, log_every=1,
            device="cpu"), log=lambda s: None)
    a, b = (json.loads((tmp_path / n / "loss_log.json").read_text()) for n in runs)
    assert a == b and np.isfinite(runs["diffusers"]["final_loss"])
    ua, ub = (torch.load(tmp_path / n / "export" / "unet.pt", weights_only=True) for n in runs)
    assert all(torch.equal(ua[k], ub[k]) for k in ub)
    assert (tmp_path / "diffusers" / "export" / "tokenizer" / "vocab.json").is_file()
    tuned = RiffusionPipeline.load_checkpoint(runs["diffusers"]["export_dir"], device="cpu")
    assert type(tuned.tokenizer).__name__ == "CLIPTokenizer"

    cli.main(["finetune", "--checkpoint", str(ddim_checkpoint), "--audio-dir",
              str(tmp_path / "audio"), "--output-dir", str(tmp_path / "cli"), "--steps", "1",
              "--batch-size", "1", "--clip-duration-ms", "640", "--num-frequencies", "64",
              "--device", "cpu"])
    assert (tmp_path / "cli" / "export" / "riffusion_tpu_torch.json").is_file()
