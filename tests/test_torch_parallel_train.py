"""
The port's sharded fine-tuning step on the CPU: DiffusionTrainer(mesh=)
over a ("data", "model", "seq") mesh (riffusion_tpu_torch/parallel/
train.py), its differentiable collectives (parallel/comm.py), the
sequence-parallel UNet (parallel/seq.py), the trainable tensor-parallel cut
(parallel/tp_serving.py), checkpoints across meshes and run_finetune's
mesh. One world of 4 gloo ranks is spawned for the module
(parallel.mesh.spawn_world, with a time limit so that a hang fails); the
JAX side runs here, in the parent, on the 8 virtual CPU devices of
tests/conftest.py, and the ranks import no JAX.

- The collectives alone, each against the single-process operation it
  stands for, in fp64: the halo exchange and a 3x3 convolution (stride 1
  and 2) against the whole convolution, self-attention with K and V
  gathered against whole attention, GroupNorm over "seq" against
  GroupNorm, copy_to and reduce_from against a fan-out and a sum; and a
  gradient check of halo_exchange, gather and all_sum: the Jacobian by
  central differences against the one their backward gives, across ranks.
- (a) The tiny UNet on 16x16 latents at batch 4 in fp64 at the meshes
  (4,1,1), (2,2,1), (1,2,2), (2,1,2) and (1,1,4) against the unsharded
  loss_and_grads on the same draws; (1,1,4) reaches a level of 2 rows,
  which runs whole. Replicated parameters bit-equal on every rank after
  a step. The attention sites route at the global query count.
- (b) Against the JAX package's DiffusionTrainer in fp32: 3 steps from the
  same weights with JAX's own draws, at test_torch_training.py's
  tolerances. At (2,2,1) against JAX's step on the same mesh. At (2,1,2)
  against JAX's unsharded step: JAX's own step at (2,1,2) departs from it
  (a JAX-side fault, held by its own test below), where JAX's (2,2,1) does
  not.
- (c) A checkpoint saved at (2,2,1) resumes at (1,1,4) and on one process:
  the next step equal in fp64.
- (d) run_finetune with mesh_shape (and JAX's default rule) in the world
  against the single-process run's export, from a tiny checkpoint whose
  GroupNorms have several channels a group (random:tiny's one-channel
  groups at the 32-channel level give gradients that are zero in exact
  arithmetic, which Adam turns from fp32 rounding into steps of the
  learning rate's size, in any sum order); its refusals.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch.parallel import mesh as mesh_mod

WORLD = 4
WORLD_TIMEOUT_S = 300.0
WIRING_MESHES = [(4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2), (1, 1, 4)]
JAX_MESHES = [(2, 2, 1), (2, 1, 2)]
# the JAX mesh each port mesh is held to: its own shape, but (2,1,2) to JAX's
# unsharded step (test_jax_step_at_data_by_seq_departs_from_its_unsharded_step)
JAX_REFERENCE = {(2, 2, 1): (2, 2, 1), (2, 1, 2): (1, 1, 1)}
AXES = ("data", "model", "seq")
LR = 1e-3


# ------------------------------------------------------------ the world's work


def _tiny_unet(dtype=torch.float64):
    from riffusion_tpu_torch.models.weights import random_bundle

    return random_bundle("tiny", seed=0, device="cpu").unet.to(dtype)


def _replicated_digest(trainer):
    """sha256 of the replicated parameters' bytes, in name order."""
    from riffusion_tpu_torch.parallel.train import param_spec

    h = hashlib.sha256()
    for name, p in trainer.master.named_parameters():
        if param_spec(name, p) is None:
            h.update(name.encode() + p.detach().numpy().tobytes())
    return h.hexdigest()


def _jacobians(fn, x):
    """The Jacobian of an SPMD function of each rank's x, in fp64, by
    central differences and by its backward: (rows of the numerical
    Jacobian for this rank's outputs against every rank's inputs, columns
    of the analytical one for this rank's inputs against every rank's
    outputs). All ranks run every forward and backward together; the
    parent assembles both matrices."""
    import torch.distributed as dist

    rank, world, eps = dist.get_rank(), dist.get_world_size(), 1e-6
    n_in = x.numel()
    n_out = fn(x).numel()
    numerical = torch.zeros(n_out, world * n_in, dtype=torch.float64)
    for src in range(world):
        for i in range(n_in):
            outs = []
            for sign in (1.0, -1.0):
                xp = x.detach().clone()
                if rank == src:
                    xp.view(-1)[i] += sign * eps
                outs.append(fn(xp).detach().reshape(-1))
            numerical[:, src * n_in + i] = (outs[0] - outs[1]) / (2 * eps)
    analytical = torch.zeros(world * n_out, n_in, dtype=torch.float64)
    for dst in range(world):
        for j in range(n_out):
            xg = x.detach().clone().requires_grad_()
            y = fn(xg)
            g = torch.zeros_like(y)
            if rank == dst:
                g.view(-1)[j] = 1.0
            y.backward(g)
            analytical[dst * n_out + j] = xg.grad.reshape(-1)
    return numerical.numpy(), analytical.numpy()


def _conv_inputs():
    """x (2, 3, 8, 5), weight, bias and a cotangent for stride 1 and 2."""
    gen = torch.Generator().manual_seed(11)
    x, w, b = (torch.randn(shape, generator=gen, dtype=torch.float64)
               for shape in ((2, 3, 8, 5), (4, 3, 3, 3), (4,)))
    gys = {stride: torch.randn(2, 4, 8 // stride, 5 if stride == 1 else 3, generator=gen,
                               dtype=torch.float64) for stride in (1, 2)}
    return x, w, b, gys


def _attention_inputs():
    """Attention(16, 2 heads of 8) with weights of scale 0.3, x and a
    cotangent over 16 tokens."""
    from riffusion_tpu_torch.models.layers import Attention

    gen = torch.Generator().manual_seed(12)
    attn = Attention(16, 2, 8, 16).double()
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=torch.float64) * 0.3)
    x, gy = (torch.randn(2, 16, 16, generator=gen, dtype=torch.float64) for _ in range(2))
    return attn, x, gy


def _norm_inputs():
    """GroupNorm(2 groups, 4 channels) with a scale near 1 and a small
    bias, x (mean 0.5) and a cotangent over 8 rows."""
    from riffusion_tpu_torch.models.layers import GroupNorm

    gen = torch.Generator().manual_seed(13)
    norm = GroupNorm(2, 4, eps=1e-5).double()
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(4, generator=gen, dtype=torch.float64))
        norm.bias.copy_(0.1 * torch.randn(4, generator=gen, dtype=torch.float64))
    x = torch.randn(2, 4, 8, 3, generator=gen, dtype=torch.float64) + 0.5
    gy = torch.randn(2, 4, 8, 3, generator=gen, dtype=torch.float64)
    return norm, x, gy


def _collective_checks(rank, world):
    """Each collective and swapped module on its rows against the whole
    operation (the parent compares); fp64."""
    from riffusion_tpu_torch.parallel import comm
    from riffusion_tpu_torch.parallel.comm import MeshAxis
    from riffusion_tpu_torch.parallel.seq import (
        ParallelAttention, SeqGroupNorm, SeqState, halo_conv2d, swap_class,
    )

    seq = MeshAxis.of(mesh_mod.make_mesh((world,), ("seq",)), "seq")
    model = MeshAxis.of(mesh_mod.make_mesh((world,), ("model",)), "model")
    gen = torch.Generator().manual_seed(14)  # the same draws on every rank
    out = {}

    def rows(x, dim=2):
        h = x.shape[dim] // world
        return x.narrow(dim, rank * h, h)

    # a 3x3 convolution, stride 1 and 2, on the rank's rows (2 of 8)
    x, w, b, gys = _conv_inputs()
    for stride, gy in gys.items():
        xl, wl, bl = (t.detach().clone().requires_grad_() for t in (rows(x), w, b))
        y = halo_conv2d(xl, wl, bl, stride, 1, seq)
        y.backward(rows(gy))
        out[f"conv{stride}"] = (y.detach().numpy(), xl.grad.numpy(), wl.grad.numpy(),
                                bl.grad.numpy())

    # self-attention over 16 tokens, 4 per rank, K and V gathered
    state = SeqState(seq)
    state.split = True
    attn, x, gy = _attention_inputs()
    swap_class(attn, ParallelAttention, seq=state)
    xl = rows(x, 1).clone().requires_grad_()
    y = attn(xl)
    y.backward(rows(gy, 1))
    out["attention"] = (y.detach().numpy(), xl.grad.numpy(),
                        {n: p.grad.numpy() for n, p in attn.named_parameters()})

    # GroupNorm (2 groups of 2 channels) over the global rows
    norm, x, gy = _norm_inputs()
    swap_class(norm, SeqGroupNorm, seq=state)
    xl = rows(x).clone().requires_grad_()
    y = norm(xl)
    y.backward(rows(gy))
    out["groupnorm"] = (y.detach().numpy(), xl.grad.numpy(), norm.weight.grad.numpy(),
                        norm.bias.grad.numpy())

    # over "model": a fan-out of one replicated x (each rank its own
    # cotangent), and a sum of the ranks' partials (one replicated cotangent)
    x = torch.randn(3, 4, generator=gen, dtype=torch.float64).requires_grad_()
    own = torch.randn(3, 4, generator=torch.Generator().manual_seed(rank), dtype=torch.float64)
    y = comm.copy_to(x, model)
    y.backward(own)
    out["copy_to"] = (y.detach().numpy(), own.numpy(), x.grad.numpy())
    part = (torch.randn(3, 4, generator=torch.Generator().manual_seed(100 + rank),
                        dtype=torch.float64) * 1e3).to(torch.bfloat16).requires_grad_()
    y = comm.reduce_from(part, model)
    g = torch.randn(3, 4, generator=gen)
    y.backward(g)
    out["reduce_from"] = (part.detach().double().numpy(), str(y.dtype), y.detach().numpy(),
                          g.numpy(), part.grad.double().numpy(), str(part.grad.dtype))

    # the Jacobians of the "seq" exchanges
    x = torch.randn(1, 2, 2, 2, generator=torch.Generator().manual_seed(rank),
                    dtype=torch.float64)
    out["jacobians"] = {
        "halo_exchange": _jacobians(lambda t: comm.halo_exchange(t, seq, 2), x),
        "halo_exchange (1 row)": _jacobians(lambda t: comm.halo_exchange(t, seq, 2),
                                            x[:, :, :1]),
        "gather": _jacobians(lambda t: comm.gather(t, seq, 1), x),
        "all_sum": _jacobians(lambda t: comm.all_sum(t * t, seq), x),
    }
    return out


def _wiring(rank, world, batch):
    """(a): each mesh's step in fp64 against the unsharded loss_and_grads;
    the routes at the scaled gate."""
    from riffusion_tpu_torch.models import layers
    from riffusion_tpu_torch.ops import attention as attention_ops
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer, shard_state

    unet = _tiny_unet()
    ref = DiffusionTrainer(device="cpu", dtype=torch.float64)
    ref.init_from(unet)
    out = {"ref_loss": float(ref.loss_and_grads(**batch))}
    ref_grads = {n: p.grad for n, p in ref.master.named_parameters()}
    top = max(float(g.abs().max()) for g in ref_grads.values())
    for shape in WIRING_MESHES:
        trainer = DiffusionTrainer(device="cpu", learning_rate=LR, dtype=torch.float64,
                                   mesh=mesh_mod.make_mesh(shape, AXES))
        trainer.init_from(unet)
        before = _replicated_digest(trainer)
        loss = float(trainer.step(**batch))  # loss_and_grads, then AdamW: .grad stays
        want = shard_state(ref_grads, trainer.mesh)
        errors = {n: (float((p.grad - want[n]).abs().max()), float(want[n].abs().max()))
                  for n, p in trainer.master.named_parameters()}
        out[shape] = {"loss": loss, "errors": errors, "top": top,
                      "digest": _replicated_digest(trainer), "before": before,
                      "finite": all(bool(torch.isfinite(p).all())
                                    for p in trainer.master.parameters())}

    # the routes, with the gate's floor between a level-0 block (64 tokens
    # at seq 4) and the level's 256
    counts = {}
    table = layers._ATTENTION_OPS
    ops = dict(table)

    def counting(route, fn):
        def wrapped(*a, **k):
            counts[route] = counts.get(route, 0) + 1
            return fn(*a, **k)
        return wrapped

    floor = attention_ops.FLASH_SEQ_MIN
    attention_ops.FLASH_SEQ_MIN = 128
    table.update({route: counting(route, fn) for route, fn in ops.items()})
    try:
        ref.loss_and_grads(**batch)
        out["routes_whole"], counts = counts, {}
        sharded = DiffusionTrainer(device="cpu", dtype=torch.float64,
                                   mesh=mesh_mod.make_mesh((1, 1, 4), AXES))
        sharded.init_from(unet)
        sharded.loss_and_grads(**batch)
        out["routes_seq"] = counts
    finally:
        table.update(ops)
        attention_ops.FLASH_SEQ_MIN = floor
    return out


def _against_jax(rank, world, jax_case):
    """(b): 3 fp32 steps at each JAX mesh with JAX's draws; rank 0 returns
    the losses and the unsharded parameters."""
    from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from riffusion_tpu_torch.models.weights import state_dict_from_jax
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    unet = UNet2DCondition(UNetConfig(**jax_case["config"]))
    unet.load_state_dict(state_dict_from_jax(jax_case["params"]), strict=True)
    out = {}
    for shape in JAX_MESHES:
        trainer = DiffusionTrainer(device="cpu", learning_rate=LR, dtype=torch.float32,
                                   mesh=mesh_mod.make_mesh(shape, AXES))
        trainer.init_from(unet)
        losses = [float(trainer.step(jax_case["latents"], jax_case["context"], t=t, noise=n))
                  for t, n in jax_case["draws"]]
        params = trainer.unsharded(trainer.master.state_dict())
        out[shape] = (losses, {k: v.numpy() for k, v in params.items()} if rank == 0 else None)
    return out


def _checkpoints(rank, world, batch, next_batch, ckpt_dir):
    """(c): a step at (2,2,1), saved; the next step there and after a
    restore at (1,1,4)."""
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    unet = _tiny_unet()
    runs = {}
    for shape in ((2, 2, 1), (1, 1, 4)):
        trainer = DiffusionTrainer(device="cpu", learning_rate=LR, dtype=torch.float64,
                                   mesh=mesh_mod.make_mesh(shape, AXES))
        trainer.init_from(unet)
        if shape == (2, 2, 1):
            trainer.step(**batch)
            trainer.save_checkpoint(ckpt_dir, 1, ema={n: p.detach() * 0.5 for n, p
                                                      in trainer.master.named_parameters()})
            restored = None
        else:
            restored = trainer.restore_checkpoint(ckpt_dir, 1)
            restored = (restored[0], {k: v.numpy() for k, v in
                                      trainer.unsharded(restored[1]).items()})
        loss = float(trainer.step(**next_batch))
        params = trainer.unsharded(trainer.master.state_dict())
        runs[shape] = (loss, {k: v.numpy() for k, v in params.items()} if rank == 0 else None,
                       restored)
    return runs


def _finetunes(rank, world, checkpoint, dataset_dir, out_root):
    """(d): run_finetune in the world at mesh_shape (2,2,1) and by the
    default rule, and its refusal of a batch that does not divide."""
    from riffusion_tpu_torch.training import run_finetune

    out = {}
    for name, shape in (("(2, 2, 1)", (2, 2, 1)), ("default", None)):
        stats = run_finetune(_finetune_config(checkpoint, dataset_dir, f"{out_root}/{name}",
                                              mesh_shape=shape), log=lambda s: None)
        out[name] = stats["final_loss"]
    try:
        run_finetune(_finetune_config(checkpoint, dataset_dir, f"{out_root}/refused",
                                      batch_size=2, mesh_shape=(4, 1, 1)), log=lambda s: None)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


def _finetune_config(checkpoint, dataset_dir, output_dir, **kw):
    from riffusion_tpu_torch.training import FinetuneConfig

    base = dict(checkpoint=str(checkpoint), dataset_dir=str(dataset_dir),
                output_dir=str(output_dir), steps=2, batch_size=4, learning_rate=LR,
                warmup_steps=1, ema_decay=0.5, checkpoint_every=1, log_every=1, device="cpu")
    base.update(kw)
    return FinetuneConfig(**base)


def _world_checks(rank, world, batch, next_batch, jax_case, ckpt_dir, checkpoint, dataset_dir,
                  out_root):
    return {
        "collectives": _collective_checks(rank, world),
        "wiring": _wiring(rank, world, batch),
        "jax": _against_jax(rank, world, jax_case),
        "checkpoints": _checkpoints(rank, world, batch, next_batch, ckpt_dir),
        "finetune": _finetunes(rank, world, checkpoint, dataset_dir, out_root),
    }


# ----------------------------------------------------------------- fixtures


def _batch(seed, size=16):
    rng = np.random.default_rng(seed)
    return dict(latents=rng.standard_normal((4, size, size, 4)),
                context=rng.standard_normal((4, 77, 64)),
                t=rng.integers(0, 1000, 4), noise=rng.standard_normal((4, size, size, 4)))


def _jax_config():
    from riffusion_tpu.models.unet import UNetConfig as JaxUNetConfig

    return dataclasses.replace(JaxUNetConfig.tiny(), block_out_channels=(16, 16, 16, 16),
                               cross_attention_dim=16, norm_num_groups=4)


@pytest.fixture(scope="module")
def jax_case():
    """test_torch_training.py's 16-channel UNet with its random weights, a
    batch of 4 on 8x8 latents and the draws of JAX's _train_step for 3
    keys (t, noise), all numpy."""
    import jax
    import jax.numpy as jnp
    from riffusion_tpu.models.unet import UNet2DCondition as JaxUNet
    from riffusion_tpu_torch.models.unet import UNetConfig

    from test_torch_training import _random_params

    cfg = _jax_config()
    s, b = cfg.sample_size, 4
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(
        lambda: JaxUNet(cfg, dtype=jnp.float32).init(
            jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, 16)))["params"])
    params = _random_params(shapes, rng)
    latents = rng.standard_normal((b, s, s, 4)).astype(np.float32)
    context = rng.standard_normal((b, 77, 16)).astype(np.float32)
    keys = [jax.random.PRNGKey(100 + i) for i in range(3)]
    draws = []
    for key in keys:
        k_t, k_noise = jax.random.split(key)
        draws.append((np.asarray(jax.random.randint(k_t, (b,), 0, 1000)),
                      np.asarray(jax.random.normal(k_noise, latents.shape, jnp.float32))))
    config = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(UNetConfig)}
    return {"config": config, "params": params, "latents": latents, "context": context,
            "draws": draws, "keys": keys}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """random:tiny with a UNet of 8 GroupNorm groups (4 and 8 channels a
    group), random weights from a seed, in the port's export layout."""
    from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
    from riffusion_tpu_torch.models.weights import random_bundle, randomize_, save_native

    bundle = random_bundle("tiny", seed=0, device="cpu")
    bundle.unet = UNet2DCondition(dataclasses.replace(UNetConfig.tiny(), norm_num_groups=8))
    randomize_(bundle.unet, torch.Generator().manual_seed(5))
    out = tmp_path_factory.mktemp("checkpoint")
    save_native(bundle, out)
    return out


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Six 640 ms clips (8x8 latents) of the tiny pipeline."""
    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.training import build_latent_dataset

    root = tmp_path_factory.mktemp("ft")
    (root / "audio").mkdir()
    sr, rng = 44100, np.random.default_rng(7)
    t = np.arange(int(sr * 1.5)) / sr
    for i, freq in enumerate((220.0, 440.0, 660.0)):
        wave = 0.5 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(t.shape)
        AudioSegment((wave * 32767).astype(np.int16), sr).export(str(root / "audio" / f"{i}.wav"))
    pipe = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
    build_latent_dataset(pipe, root / "audio", root / "ds",
                         params=SpectrogramParams(num_frequencies=64), clip_duration_ms=640)
    return root / "ds"


@pytest.fixture(scope="module")
def world(jax_case, checkpoint, dataset_dir, tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    out_root = tmp_path_factory.mktemp("runs")
    batch, next_batch = _batch(1), _batch(2)
    results = mesh_mod.spawn_world(
        _world_checks, WORLD,
        (batch, next_batch, {k: v for k, v in jax_case.items() if k != "keys"}, str(ckpt_dir),
         str(checkpoint), str(dataset_dir), str(out_root)),
        backend="gloo", timeout_s=WORLD_TIMEOUT_S)
    return {"ranks": results, "batch": batch, "next_batch": next_batch, "ckpt_dir": ckpt_dir,
            "out_root": out_root}


# ------------------------------------------------------------- the collectives


def _whole_rows(ranks, key, index, dim=2):
    return np.concatenate([r["collectives"][key][index] for r in ranks], axis=dim)


def test_halo_conv_matches_the_whole_convolution(world):
    """Each rank's 2 of 8 rows through halo_conv2d, at stride 1 and 2,
    against the whole convolution (padding 1): the output rows, the input
    gradient rows, and the weight and bias gradients summed over the ranks,
    to 1e-12."""
    import torch.nn.functional as F

    ranks = world["ranks"]
    x, w, b, gys = _conv_inputs()
    for stride, gy in gys.items():
        xg, wg, bg = (t.clone().requires_grad_() for t in (x, w, b))
        y = F.conv2d(xg, wg, bg, stride, 1)
        y.backward(gy)
        key = f"conv{stride}"
        np.testing.assert_allclose(_whole_rows(ranks, key, 0), y.detach().numpy(), atol=1e-12)
        np.testing.assert_allclose(_whole_rows(ranks, key, 1), xg.grad.numpy(), atol=1e-12)
        for i, ref in ((2, wg.grad), (3, bg.grad)):
            summed = sum(r["collectives"][key][i] for r in ranks)
            np.testing.assert_allclose(summed, ref.numpy(), rtol=1e-12, atol=1e-12)


def test_gathered_attention_matches_whole_attention(world):
    """Queries on the rank's 4 of 16 tokens, K and V gathered: the output
    and input gradient rows and the projections' gradients summed over the
    ranks equal whole attention's, to 1e-12."""
    ranks = world["ranks"]
    attn, x, gy = _attention_inputs()
    x.requires_grad_()
    y = attn(x)
    y.backward(gy)
    np.testing.assert_allclose(_whole_rows(ranks, "attention", 0, 1), y.detach().numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(_whole_rows(ranks, "attention", 1, 1), x.grad.numpy(),
                               atol=1e-12)
    for name, p in attn.named_parameters():
        summed = sum(r["collectives"]["attention"][2][name] for r in ranks)
        np.testing.assert_allclose(summed, p.grad.numpy(), rtol=1e-12, atol=1e-12)


def test_groupnorm_over_seq_matches_groupnorm(world):
    """GroupNorm's statistics over the global rows: the output and input
    gradient rows and the scale and bias gradients summed over the ranks
    equal GroupNorm's on the whole, to 1e-12."""
    ranks = world["ranks"]
    norm, x, gy = _norm_inputs()
    x.requires_grad_()
    y = norm(x)
    y.backward(gy)
    np.testing.assert_allclose(_whole_rows(ranks, "groupnorm", 0), y.detach().numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(_whole_rows(ranks, "groupnorm", 1), x.grad.numpy(), atol=1e-12)
    for i, ref in ((2, norm.weight.grad), (3, norm.bias.grad)):
        summed = sum(r["collectives"]["groupnorm"][i] for r in ranks)
        np.testing.assert_allclose(summed, ref.numpy(), rtol=1e-12, atol=1e-12)


def test_copy_to_and_reduce_from_over_model(world):
    """copy_to is a fan-out of one replicated x: the identity forward, and
    x's gradient the sum of every rank's cotangent. reduce_from is a sum of
    the ranks' bf16 partials: the fp32 sum forward (exact here: integers
    of bf16 magnitude), the replicated cotangent passed back to every
    partial in bf16."""
    ranks = world["ranks"]
    cotangents = sum(r["collectives"]["copy_to"][1] for r in ranks)
    partials = sum(r["collectives"]["reduce_from"][0] for r in ranks)
    for r in ranks:
        y, _, grad = r["collectives"]["copy_to"]
        np.testing.assert_array_equal(y, ranks[0]["collectives"]["copy_to"][0])
        np.testing.assert_allclose(grad, cotangents, rtol=1e-14)  # another sum order
        _, dtype, total, g, part_grad, grad_dtype = r["collectives"]["reduce_from"]
        assert dtype == "torch.float32" and grad_dtype == "torch.bfloat16"
        np.testing.assert_allclose(total, partials, rtol=1e-6)
        np.testing.assert_array_equal(part_grad, torch.from_numpy(g).to(torch.bfloat16)
                                      .double().numpy())


@pytest.mark.parametrize("name", ["halo_exchange", "halo_exchange (1 row)", "gather", "all_sum"])
def test_seq_exchange_gradcheck(world, name):
    """The Jacobian of each "seq" exchange across the 4 ranks (every rank's
    output against every rank's input), by central differences in fp64
    (step 1e-6), equals the one its backward gives, to 1e-8; the halo at a
    block of one row too (its first and last row are one)."""
    ranks = world["ranks"]
    numerical = np.concatenate([r["collectives"]["jacobians"][name][0] for r in ranks], axis=0)
    analytical = np.concatenate([r["collectives"]["jacobians"][name][1] for r in ranks], axis=1)
    assert numerical.shape == analytical.shape and np.abs(analytical).max() > 0.5
    np.testing.assert_allclose(analytical, numerical, atol=1e-8)


# ------------------------------------------------------------------ (a) wiring


@pytest.mark.parametrize("shape", WIRING_MESHES)
def test_sharded_step_matches_unsharded_fp64(world, shape):
    """The tiny UNet, 16x16 latents, batch 4, fp64, against the unsharded
    loss_and_grads on the same draws: the loss to 1e-12 relative on every
    rank; every gradient the rank holds (its cut) to 1e-10 of its scale:
    its own largest element, or, for the 13 gradients that are zero in
    exact arithmetic (each below 1e-8 of the largest: biases and time
    projections in front of a GroupNorm of one channel per group, which
    removes them), the UNet's largest gradient element. After the step the
    replicated parameters are bit-equal on every rank, and moved."""
    ranks = world["ranks"]
    digests = set()
    for r in ranks:
        out = r["wiring"][shape]
        ref = r["wiring"]["ref_loss"]
        assert abs(out["loss"] - ref) <= 1e-12 * abs(ref), (out["loss"], ref)
        top = out["top"]
        zero = 0
        for name, (err, scale) in out["errors"].items():
            if scale < 1e-8 * top:
                zero += 1
                scale = top
            assert err <= 1e-10 * scale, (name, err, scale)
        assert zero == 13
        assert out["finite"] and out["digest"] != out["before"]
        digests.add(out["digest"])
    assert len(digests) == 1


def test_attention_routes_at_the_global_query_count(world):
    """With the gate's floor at 128 queries, the 16x16 level's sites (256
    queries, 64 a rank at seq 4) take K1's route on every rank, as in the
    unsharded step; the smaller levels take the plain composition."""
    for r in world["ranks"]:
        whole, seq = r["wiring"]["routes_whole"], r["wiring"]["routes_seq"]
        assert whole["flash"] == 3 and seq == whole, (whole, seq)


# ------------------------------------------------------------- (b) against JAX


@pytest.fixture(scope="module")
def jax_runs(jax_case):
    """JAX's trainer at each mesh (and unsharded) on the parent's 8 virtual
    CPU devices: 3 steps from the same weights and keys."""
    import jax
    from riffusion_tpu.parallel.mesh import make_mesh
    from riffusion_tpu.parallel.train import DiffusionTrainer as JaxTrainer

    runs = {}
    for shape in JAX_MESHES + [(1, 1, 1)]:
        mesh = make_mesh(shape, AXES, devices=jax.devices()[:int(np.prod(shape))])
        trainer = JaxTrainer(_jax_config(), mesh, learning_rate=LR, dtype=jax.numpy.float32)
        p, opt = trainer.init_from(jax_case["params"])
        losses = []
        for key in jax_case["keys"]:
            p, opt, loss = trainer.step(p, opt, jax_case["latents"], jax_case["context"], key)
            losses.append(float(loss))
        runs[shape] = (losses, jax.tree.map(np.asarray, p))
    return runs


@pytest.mark.parametrize("shape", JAX_MESHES)
def test_sharded_trainer_matches_jax(world, jax_case, jax_runs, shape):
    """3 fp32 steps at lr 1e-3 with JAX's draws against JAX's trainer (at
    JAX_REFERENCE's mesh): test_torch_training.py's tolerances. Losses to
    1e-5 relative on every rank; the parameters' movement to 1e-3 of its
    RMS, and each parameter to 1e-4."""
    from riffusion_tpu_torch.models.weights import state_dict_from_jax

    jax_losses, jax_final = jax_runs[JAX_REFERENCE[shape]]
    for r in world["ranks"]:
        np.testing.assert_allclose(r["jax"][shape][0], jax_losses, rtol=1e-5)
    ours = world["ranks"][0]["jax"][shape][1]
    ref = state_dict_from_jax(jax_final)
    start = state_dict_from_jax(jax_case["params"])
    moved_ours = np.concatenate([(ours[k] - start[k].numpy()).ravel() for k in ref])
    moved_ref = np.concatenate([(ref[k] - start[k]).numpy().ravel() for k in ref])
    rel = np.linalg.norm(moved_ours - moved_ref) / np.linalg.norm(moved_ref)
    worst = np.abs(moved_ours - moved_ref).max()
    assert rel < 1e-3 and worst < 1e-4, (rel, worst)
    assert np.abs(moved_ref).max() > 2e-3


def test_jax_step_at_data_by_seq_departs_from_its_unsharded_step(jax_runs):
    """The JAX-side fault the port does not follow: on the 8 virtual CPU
    devices, JAX's step at (2,1,2) moves more than 1% of the parameters by
    more than 1e-4 away from its unsharded step within 3 steps (Adam's
    first updates of opposite sign: a gradient of another sign), and its
    later losses differ by more than 1e-4 relative; at (2,2,1) its step is
    the unsharded one to test_torch_training.py's tolerances."""
    import jax

    whole_losses, whole = jax_runs[(1, 1, 1)]
    for shape, departs in (((2, 1, 2), True), ((2, 2, 1), False)):
        losses, final = jax_runs[shape]
        apart = sum(int((np.abs(a - b) > 1e-4).sum())
                    for a, b in zip(jax.tree.leaves(final), jax.tree.leaves(whole)))
        total = sum(a.size for a in jax.tree.leaves(whole))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, whole_losses))
        if departs:
            assert apart > 0.01 * total and rel > 1e-4, (shape, apart, rel)
        else:
            assert apart == 0 and rel < 1e-5, (shape, apart, rel)


# ----------------------------------------------------------- (c) checkpoints


def test_checkpoint_resumes_on_another_mesh_and_one_process(world):
    """A checkpoint written at (2,2,1) (after one step) holds the unsharded
    state in the single-device layout. Restored at (1,1,4), and by an
    unsharded trainer in this process, the next step equals the (2,2,1)
    trainer's own next step in fp64: the loss to 1e-12 relative, every
    parameter after it to 1e-12 of the largest; the EMA comes back whole."""
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    runs = world["ranks"][0]["checkpoints"]
    loss_a, params_a, _ = runs[(2, 2, 1)]
    loss_b, params_b, restored = runs[(1, 1, 4)]
    state = torch.load(world["ckpt_dir"] / "state_1" / "state.pt", weights_only=True)
    unet = _tiny_unet()
    whole = unet.state_dict()
    assert {k: tuple(v.shape) for k, v in state["params"].items()} == \
        {k: tuple(v.shape) for k, v in whole.items()}
    assert restored[0] == 1
    for name, value in restored[1].items():
        np.testing.assert_array_equal(value, state["ema"][name].numpy())

    single = DiffusionTrainer(device="cpu", learning_rate=LR, dtype=torch.float64)
    single.init_from(unet)
    step, ema = single.restore_checkpoint(world["ckpt_dir"], 1)
    assert step == 1 and set(ema) == set(whole)
    batch = world["next_batch"]
    loss_c = float(single.step(**batch))
    params_c = {k: v.numpy() for k, v in single.master.state_dict().items()}
    top = max(np.abs(v).max() for v in params_a.values())
    for loss, params in ((loss_b, params_b), (loss_c, params_c)):
        assert abs(loss - loss_a) <= 1e-12 * abs(loss_a), (loss, loss_a)
        worst = max(np.abs(params[k] - params_a[k]).max() for k in params_a)
        assert worst <= 1e-12 * top, worst


# ------------------------------------------------------------ (d) run_finetune


@pytest.fixture(scope="module")
def single_finetune(checkpoint, dataset_dir, tmp_path_factory):
    from riffusion_tpu_torch.training import run_finetune

    out = tmp_path_factory.mktemp("single")
    stats = run_finetune(_finetune_config(checkpoint, dataset_dir, out), log=lambda s: None)
    return stats, torch.load(out / "export" / "unet.pt", weights_only=True)


@pytest.mark.parametrize("name", ["(2, 2, 1)", "default"])
def test_run_finetune_in_the_world_matches_one_process(world, checkpoint, single_finetune,
                                                        name):
    """run_finetune (tiny, 2 steps at batch 4, fp32, EMA 0.5) in the world,
    at mesh_shape (2,2,1) and by JAX's default rule (gcd(4, 4) = 4 on
    "data"), against the single-process run: the final loss to 1e-5
    relative on every rank; the exported UNet's movement from the start to
    1e-3 of its RMS and each weight to 1e-5 (fp32 in other sum orders
    through AdamW); the loss log and the checkpoints written once, in the
    single-device layout; the export loads."""
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    stats, single = single_finetune
    run = world["out_root"] / name
    for r in world["ranks"]:
        assert r["finetune"][name] == pytest.approx(stats["final_loss"], rel=1e-5)
    ours = torch.load(run / "export" / "unet.pt", weights_only=True)
    start = torch.load(checkpoint / "unet.pt", weights_only=True)
    moved_ours = torch.cat([(ours[k] - start[k]).flatten() for k in single])
    moved_ref = torch.cat([(single[k] - start[k]).flatten() for k in single])
    rel = float((moved_ours - moved_ref).norm() / moved_ref.norm())
    worst = float((moved_ours - moved_ref).abs().max())
    assert rel < 1e-3 and worst < 1e-5, (rel, worst)
    assert [s for s, _ in json.loads((run / "loss_log.json").read_text())] == [1, 2]
    saved = torch.load(run / "checkpoints" / "state_2" / "state.pt", weights_only=True)
    assert {k: tuple(v.shape) for k, v in saved["ema"].items()} == \
        {k: tuple(v.shape) for k, v in start.items()}
    tuned = RiffusionPipeline.load_checkpoint(str(run / "export"), device="cpu")
    assert torch.equal(tuned.unet.state_dict()["conv_in.weight"], ours["conv_in.weight"])


def test_run_finetune_refusals(world, checkpoint, dataset_dir, tmp_path):
    """A batch that does not divide over "data" raises JAX's ValueError in
    the world; a mesh_shape other than all ones without a process group
    raises here, and (1, 1, 1) runs on one device."""
    from riffusion_tpu_torch.training import run_finetune

    for r in world["ranks"]:
        assert r["finetune"]["refusal"] == ("batch_size 2 not divisible by data-parallel "
                                            "degree 4")
    with pytest.raises(ValueError, match="needs an initialized process group"):
        run_finetune(_finetune_config(checkpoint, dataset_dir, tmp_path / "a",
                                      mesh_shape=(2, 1, 1)), log=lambda s: None)
    stats = run_finetune(_finetune_config(checkpoint, dataset_dir, tmp_path / "b", steps=1,
                                          mesh_shape=(1, 1, 1)), log=lambda s: None)
    assert np.isfinite(stats["final_loss"])


def test_finetune_command_under_torchrun(dataset_dir, tmp_path):
    """torchrun --nproc-per-node 2 -m riffusion_tpu_torch.cli finetune, with
    no flag of its own: rank 0 builds the dataset from the audio and
    reports once, both ranks train their share (batch 2 on "data" by JAX's
    rule), and the export and the loss log are written."""
    args = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
            "--master-addr", "127.0.0.1", "--master-port", str(mesh_mod._free_port()),
            "-m", "riffusion_tpu_torch.cli", "finetune", "--checkpoint", "random:tiny",
            "--audio-dir", str(dataset_dir.parent / "audio"), "--output-dir", str(tmp_path),
            "--steps", "2", "--batch-size", "2", "--clip-duration-ms", "640",
            "--num-frequencies", "64", "--device", "cpu"]
    proc = subprocess.run(args, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Dataset: 6 clips") == 1, proc.stdout
    assert proc.stdout.count("Fine-tune done: 2 steps") == 1, proc.stdout
    assert (tmp_path / "export" / "riffusion_tpu_torch.json").is_file()
    assert [s for s, _ in json.loads((tmp_path / "loss_log.json").read_text())] == [1, 2]


def test_cuda_means_the_process_card(monkeypatch):
    """check_device("cuda") is the card this process chose (init_distributed
    sets each rank's from LOCAL_RANK), not card 0: under torchrun on four
    cards every rank's trainer sat on card 0 and NCCL refused the
    duplicate. Faked here: a process whose current card is 3."""
    from riffusion_tpu_torch.util import torch_util

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert torch_util.check_device("cuda") == torch.device("cuda", 3)
    assert torch_util.check_device("cuda:1") == torch.device("cuda", 1)
    assert torch_util.check_device("cpu") == torch.device("cpu")
