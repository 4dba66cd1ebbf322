"""
The port's fine-tuning slice (riffusion_tpu_torch/parallel/train.py,
training/dataset.py, training/finetune.py, models/weights.py native
save/load, spectrogram_image_converter.py, util/image_util.py, cli.py) on
the CPU, against the JAX package's where it has a counterpart:

- the trainer step against riffusion_tpu/parallel/train.py's on the same
  weights, t and noise (drawn as `_train_step` draws them, then passed
  in): the loss of each of 3 AdamW steps and the parameters after them, at
  the 16-channel UNet of tests/test_training.py (the JAX train step compiles
  in about 25 s at that size);
- the learning-rate schedule against optax's at every step; the EMA update
  against the JAX driver's;
- LatentDataset batches bit-equal to the JAX package's from the same shards;
  build_latent_dataset's moments and embeddings against the JAX package's at
  random:tiny with the same weights;
- the image codec and the spectrogram-image converter against the JAX
  package's;
- checkpoint/resume equal to an uninterrupted run; the export loaded by the
  pipeline and riffused; the finetune command.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_util import jax_twin, torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import riffusion_pipeline as jax_pipeline
from riffusion_tpu.audio.segment import AudioSegment as JaxAudioSegment
from riffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from riffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from riffusion_tpu.parallel.mesh import make_mesh
from riffusion_tpu.parallel.train import DiffusionTrainer as JaxTrainer
from riffusion_tpu.spectrogram_image_converter import (
    SpectrogramImageConverter as JaxImageConverter,
)
from riffusion_tpu.training import dataset as jax_dataset
from riffusion_tpu.training import finetune as jax_finetune
from riffusion_tpu.util import image_util as jax_image_util
from riffusion_tpu_torch import cli
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from riffusion_tpu_torch.models.weights import bundle_from_jax_params, state_dict_from_jax
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.training import (
    FinetuneConfig,
    LatentDataset,
    build_latent_dataset,
    run_finetune,
)
from riffusion_tpu_torch.training import finetune
from riffusion_tpu_torch.util import image_util

TINY_PARAMS = SpectrogramParams(num_frequencies=64)
CLIP_MS = 640  # 64 frames of 10 ms: a 64x64 image, 8x8 latents
SR = 44100


# ------------------------------------------------------------- the trainer


def _jax_unet_config():
    return dataclasses.replace(JaxUNetConfig.tiny(), block_out_channels=(16, 16, 16, 16),
                               cross_attention_dim=16, norm_num_groups=4)


def _random_params(shapes, rng):
    """N(0, 1/fan_in) kernels, small biases, scales near 1, as numpy."""
    def leaf(path, shape):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(shape.shape) / np.sqrt(np.prod(shape.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape.shape)
        return 0.1 * rng.standard_normal(shape.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def trainer_runs():
    """3 steps of each trainer from the same weights, batch and draws."""
    cfg = _jax_unet_config()
    s, b = cfg.sample_size, 2
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(
        lambda: JaxUNet(cfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, 16)))["params"])
    params = _random_params(shapes, rng)
    latents = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    context = rng.standard_normal((b, 77, 16)).astype(np.float32)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]

    mesh = make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1])
    jt = JaxTrainer(cfg, mesh, learning_rate=1e-3, dtype=jnp.float32)
    p, opt = jt.init_from(params)
    jax_losses = []
    for key in keys:
        p, opt, loss = jt.step(p, opt, latents, context, key)
        jax_losses.append(float(loss))
    jax_final = jax.tree.map(np.asarray, p)

    port_cfg = UNetConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(UNetConfig)})
    unet = UNet2DCondition(port_cfg)
    unet.load_state_dict(state_dict_from_jax(params), strict=True)
    trainer = DiffusionTrainer(device="cpu", learning_rate=1e-3, dtype=torch.float32)
    trainer.init_from(unet)
    port_losses = []
    for key in keys:  # the draws of JAX's _train_step, passed in
        k_t, k_noise = jax.random.split(key)
        t = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
        noise = np.asarray(jax.random.normal(k_noise, latents.shape, jnp.float32))
        port_losses.append(float(trainer.step(latents, context, t=t, noise=noise)))
    return jax_losses, jax_final, port_losses, trainer, params


def test_trainer_step_matches_jax(trainer_runs):
    """Losses to 1e-5 relative (fp32, another sum order). The parameters'
    movement over 3 AdamW steps at lr 1e-3 to 1e-3 of its RMS, and each
    parameter to 1e-4 (a tenth of one step): Adam divides each gradient by
    its own running magnitude, so where a gradient is near 0 a float32
    difference in it moves that element's update by a visible fraction of
    lr (measured: up to 2.1e-5 on single weights)."""
    jax_losses, jax_final, port_losses, trainer, params = trainer_runs
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    ref = state_dict_from_jax(jax_final)
    start = state_dict_from_jax(params)
    ours = trainer.master.state_dict()
    moved_ours = torch.cat([(ours[k] - start[k]).flatten() for k in ref])
    moved_ref = torch.cat([(ref[k] - start[k]).flatten() for k in ref])
    rel = float((moved_ours - moved_ref).norm() / moved_ref.norm())
    worst = float((moved_ours - moved_ref).abs().max())
    assert rel < 1e-3 and worst < 1e-4, (rel, worst)
    assert float(moved_ref.abs().max()) > 2e-3  # the steps did move the weights


def test_trainer_checkpoint_round_trip(trainer_runs, tmp_path):
    """A restored trainer steps as the saved one does."""
    _, _, _, trainer, params = trainer_runs
    unet = UNet2DCondition(trainer.master.cfg)
    unet.load_state_dict(state_dict_from_jax(params))
    other = DiffusionTrainer(device="cpu", learning_rate=1e-3, dtype=torch.float32)
    other.init_from(unet)
    trainer.save_checkpoint(tmp_path, 3, ema={"x": torch.ones(2)})
    step, ema = other.restore_checkpoint(tmp_path, 3)
    assert step == 3 and torch.equal(ema["x"], torch.ones(2))
    for a, b in zip(trainer.master.state_dict().values(), other.master.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    s = trainer.master.cfg.cross_attention_dim
    batch = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
             rng.standard_normal((2, 77, s)).astype(np.float32))
    draws = dict(t=np.array([3, 900]), noise=rng.standard_normal((2, 8, 8, 4)))
    state = {k: v.clone() for k, v in trainer.master.state_dict().items()}
    loss_a = trainer.step(*batch, **draws)
    loss_b = other.step(*batch, **draws)
    assert float(loss_a) == float(loss_b)
    trainer.master.load_state_dict(state)


def test_bf16_working_copy_trains_fp32_masters():
    """At a bf16 compute dtype the masters stay fp32 and take the working
    copy's gradients; the copy's Linear/Conv2d are bf16, its norms and
    conv_out fp32."""
    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig(**{f.name: getattr(_jax_unet_config(), f.name)
                                         for f in dataclasses.fields(UNetConfig)}))
    trainer = DiffusionTrainer(device="cpu", learning_rate=1e-3, dtype=torch.bfloat16)
    trainer.init_from(unet)
    work = trainer.unet
    assert work is not trainer.master
    assert work.conv_in.weight.dtype == torch.bfloat16
    assert work.down_blocks_0.attentions_0.blocks_0.attn1.to_q.weight.dtype == torch.bfloat16
    assert work.conv_norm_out.weight.dtype == torch.float32
    assert work.conv_out.weight.dtype == torch.float32
    before = trainer.master.conv_in.weight.detach().clone()
    loss = trainer.step(np.random.default_rng(0).standard_normal((2, 8, 8, 4)),
                        np.random.default_rng(1).standard_normal((2, 77, 16)),
                        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in trainer.master.parameters())
    assert all(p.grad is None for p in work.parameters())
    assert not torch.equal(trainer.master.conv_in.weight, before)


@pytest.mark.parametrize("steps,warmup", [(10, 3), (4, 1), (5, 100), (7, 0)])
def test_lr_schedule_matches_optax(steps, warmup):
    cfg = FinetuneConfig(checkpoint="random:tiny", dataset_dir="", output_dir="", steps=steps,
                         warmup_steps=warmup, learning_rate=3e-4)
    ref = jax_finetune._lr_schedule(jax_finetune.FinetuneConfig(
        checkpoint="random:tiny", dataset_dir="", output_dir="", steps=steps,
        warmup_steps=warmup, learning_rate=3e-4))
    ours = finetune.lr_schedule(cfg)
    assert ours(0) == 0.0 or warmup == 0
    for step in range(steps + 3):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step


def test_ema_update_matches_jax():
    rng = np.random.default_rng(2)
    ema = {"a": rng.standard_normal((5, 3)).astype(np.float32),
           "b": rng.standard_normal(7).astype(np.float32)}
    ema_t = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    for i in range(3):
        params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": rng.standard_normal(7).astype(np.float32)}
        d = 0.999 if i else 0.5
        ema = jax.tree.map(lambda a, b: a * d + b.astype(a.dtype) * (1.0 - d), ema, params)
        finetune.ema_update(ema_t, {k: torch.from_numpy(v) for k, v in params.items()}, d)
    for k in ema:
        np.testing.assert_allclose(ema_t[k].numpy(), np.asarray(ema[k]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- the dataset


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """Three 1.5 s files (two 640 ms clips each); two share a prompt."""
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(7)
    t = np.arange(int(SR * 1.5)) / SR
    for i, freq in enumerate((220.0, 440.0, 660.0)):
        wave = 0.5 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(t.shape)
        AudioSegment((wave * 32767).astype(np.int16), SR).export(str(root / f"tone_{i}.wav"))
    (root / "prompts.json").write_text(
        json.dumps({"tone_0.wav": "low drone", "tone_1.wav": "low drone"}))
    return root


@pytest.fixture(scope="module")
def pipes():
    jp = jax_pipeline.RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    bundle = bundle_from_jax_params("tiny", jp.unet_params, jp.vae_params, jp.clip_params,
                                    device="cpu")
    return jp, RiffusionPipeline(bundle, device="cpu")


@pytest.fixture(scope="module")
def datasets(pipes, audio_dir, tmp_path_factory):
    jp, tp = pipes
    jax_dir, port_dir = tmp_path_factory.mktemp("jax_ds"), tmp_path_factory.mktemp("port_ds")
    kw = dict(clip_duration_ms=CLIP_MS, encode_batch=4, shard_size=4)
    jax_meta = jax_dataset.build_latent_dataset(jp, audio_dir, jax_dir,
                                                params=jax_twin(TINY_PARAMS), **kw)
    port_meta = build_latent_dataset(tp, audio_dir, port_dir, params=TINY_PARAMS, **kw)
    return jax_meta, port_meta, jax_dir, port_dir


def test_build_latent_dataset_matches_jax(datasets):
    """The same clips, prompts and shards; the VAE moments of the same
    weights agree to 2e-3 (fp32 convolutions in two frameworks, stored as
    fp16, from spectrogram images that agree to a uint8 level), the CLIP
    embeddings to fp16 rounding."""
    jax_meta, port_meta, jax_dir, port_dir = datasets
    assert dataclasses.asdict(port_meta) == dataclasses.asdict(jax_meta)
    assert port_meta.num_clips == 6 and port_meta.num_shards == 2
    assert port_meta.prompts == ("low drone", "tone 2")
    for s in range(port_meta.num_shards):
        with np.load(jax_dir / f"shard_{s:05d}.npz") as zj, \
                np.load(port_dir / f"shard_{s:05d}.npz") as zt:
            np.testing.assert_array_equal(zt["ctx"], zj["ctx"])
            for key in ("mean", "logvar"):
                assert zt[key].dtype == np.float16 and zt[key].shape == zj[key].shape
                np.testing.assert_allclose(zt[key].astype(np.float32),
                                           zj[key].astype(np.float32), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.load(port_dir / "contexts.npy").astype(np.float32),
                               np.load(jax_dir / "contexts.npy").astype(np.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("batch_size,seed,posterior", [(4, 0, True), (2, 3, True), (3, 1, False)])
def test_latent_dataset_batches_bit_equal(datasets, batch_size, seed, posterior):
    _, _, jax_dir, port_dir = datasets
    ours = LatentDataset(port_dir).batches(batch_size, seed=seed, sample_posterior=posterior)
    theirs = jax_dataset.LatentDataset(port_dir).batches(batch_size, seed=seed,
                                                         sample_posterior=posterior)
    for _ in range(7):  # across epochs
        (lat, ctx), (lat_j, ctx_j) = next(ours), next(theirs)
        assert lat.dtype == lat_j.dtype == np.float32
        np.testing.assert_array_equal(lat, lat_j)
        np.testing.assert_array_equal(ctx, ctx_j)
    with pytest.raises(ValueError, match="exceeds dataset size"):
        next(LatentDataset(port_dir).batches(batch_size=64))


def test_image_codec_and_converter_match_jax():
    rng = np.random.default_rng(4)
    for channels in (1, 2):
        spec = (rng.random((channels, 64, 40)) ** 3 * 1e6).astype(np.float32)
        ours = image_util.image_from_spectrogram(spec, power=0.25)
        theirs = jax_image_util.image_from_spectrogram(spec, power=0.25)
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
        np.testing.assert_array_equal(
            image_util.spectrogram_from_image(ours, stereo=channels == 2),
            jax_image_util.spectrogram_from_image(theirs, stereo=channels == 2))
    t = np.arange(int(0.64 * SR)) / SR
    wave = (0.5 * np.sin(2 * np.pi * 330 * t) * 32767).astype(np.int16)
    ours = SpectrogramImageConverter(TINY_PARAMS, device="cpu").spectrogram_image_from_audio(
        AudioSegment(wave, SR))
    theirs = JaxImageConverter(jax_twin(TINY_PARAMS), device="cpu").spectrogram_image_from_audio(
        JaxAudioSegment(wave, SR))
    a, b = np.asarray(ours, np.int16), np.asarray(theirs, np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99
    assert image_util.exif_from_image(ours).keys() == jax_image_util.exif_from_image(theirs).keys()
    with pytest.raises(ValueError, match="Sample rate"):
        SpectrogramImageConverter(TINY_PARAMS, device="cpu").spectrogram_image_from_audio(
            AudioSegment(wave, 22050))


# ------------------------------------------------------- the driver, export


def _config(dataset_dir, output_dir, **kw):
    base = dict(checkpoint="random:tiny", dataset_dir=str(dataset_dir),
                output_dir=str(output_dir), batch_size=4, learning_rate=1e-3,
                warmup_steps=1, checkpoint_every=2, log_every=1, device="cpu")
    base.update(kw)
    return FinetuneConfig(**base)


def test_resume_equals_an_uninterrupted_run(datasets, tmp_path):
    """Steps 1-2, then a resumed 3-4, against 1-4 in one run: the same
    losses and the same exported weights, EMA included."""
    _, _, _, port_dir = datasets
    whole = run_finetune(_config(port_dir, tmp_path / "whole", steps=4, ema_decay=0.5),
                         log=lambda s: None)
    run_finetune(_config(port_dir, tmp_path / "split", steps=2, ema_decay=0.5),
                 log=lambda s: None)
    logged = []
    split = run_finetune(_config(port_dir, tmp_path / "split", steps=4, ema_decay=0.5),
                         log=logged.append)
    assert any("resumed from checkpoint step 2" in s for s in logged)
    losses = [json.loads((tmp_path / d / "loss_log.json").read_text()) for d in ("whole", "split")]
    assert [s for s, _ in losses[1]] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in losses[1]], [v for _, v in losses[0]], rtol=1e-6)
    assert split["final_loss"] == pytest.approx(whole["final_loss"], rel=1e-6)
    for name in ("state_2", "state_4"):
        assert (tmp_path / "split" / "checkpoints" / name / "state.pt").is_file()
    a = torch.load(tmp_path / "whole" / "export" / "unet.pt", weights_only=True)
    b = torch.load(tmp_path / "split" / "export" / "unet.pt", weights_only=True)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=1e-7)


def test_export_loads_and_riffuses(datasets, tmp_path):
    """The export is the EMA of the trained UNet (not the raw weights, not
    the start), VAE and CLIP as loaded, and it generates."""
    _, _, _, port_dir = datasets
    stats = run_finetune(_config(port_dir, tmp_path, steps=3, ema_decay=0.5),
                         log=lambda s: None)
    assert stats["steps"] == 3 and stats["num_clips"] == 6 and np.isfinite(stats["final_loss"])
    tuned = RiffusionPipeline.load_checkpoint(stats["export_dir"], device="cpu")
    base = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    raw = torch.load(tmp_path / "checkpoints" / "state_3" / "state.pt", weights_only=True)
    w = "conv_in.weight"
    assert not torch.equal(tuned.unet.state_dict()[w], base.unet.state_dict()[w])
    assert not torch.equal(tuned.unet.state_dict()[w], raw["params"][w])
    torch.testing.assert_close(tuned.unet.state_dict()[w], raw["ema"][w])
    for a, b in zip(tuned.vae.state_dict().values(), base.vae.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.default_rng(0)
    init = Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8), "RGB")
    img = tuned.riffuse(InferenceInput(start=PromptInput(prompt="low drone", seed=1),
                                       end=PromptInput(prompt="tone 2", seed=2), alpha=0.5,
                                       num_inference_steps=2), init)
    assert img.size == (64, 64) and np.asarray(img).std() > 0


def test_finetune_command_on_the_cpu(audio_dir, tmp_path, capsys):
    """`python -m riffusion_tpu_torch.cli finetune ... --device cpu`: builds
    the dataset, trains, exports; a second call with more steps resumes."""
    args = ["finetune", "--checkpoint", "random:tiny", "--audio-dir", str(audio_dir),
            "--output-dir", str(tmp_path), "--steps", "2", "--batch-size", "2",
            "--checkpoint-every", "1", "--clip-duration-ms", str(CLIP_MS),
            "--num-frequencies", "64", "--device", "cpu"]
    cli.main(args)
    out = capsys.readouterr().out
    assert "Dataset: 6 clips, 2 unique prompts" in out and "Fine-tune done: 2 steps" in out
    assert (tmp_path / "export" / "riffusion_tpu_torch.json").is_file()
    cli.main(args[:7] + ["--steps", "3"] + args[9:])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["finetune", "--checkpoint", "random:tiny", "--output-dir", str(tmp_path)])
