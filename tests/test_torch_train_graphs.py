"""
The fine-tuning step and the EMA update as device programs through a graph
store (riffusion_tpu_torch/parallel/train.py `DiffusionTrainer.step` /
`.program`, training/finetune.py's "ema_update"), on the CPU at the tiny
UNet:

- the split: the host part plus the device program, run eagerly, equal
  bit for bit the step before the split (a copy of its body is kept here as
  the reference) over 3 steps whose learning rate changes every step, in
  fp32 and with the bf16 working copy; a step that raises leaves the count,
  so its retry runs at its own rate;
- the store, with a stand-in for the card's graphs whose capture takes no
  step (as a CUDA capture runs nothing): one capture and three replays per
  program, the same losses, masters, moments and EMA as the eager trainer
  bit for bit, and the eager launch counts per step;
- a restore into a trainer whose programs were captured drops them (a graph
  replays addresses, and the optimizer's load replaces its state tensors),
  and the next steps equal an uninterrupted eager run's; a checkpoint in
  the card's layout (capturable groups) restores on the CPU;
- a host sync in the device program fails the capture with the key, and
  nothing falls back to eager; every launch counter, the backward
  kernels' among them, comes back with each replay;
- a trainer with a mesh (a world of two gloo ranks) and one under
  RIFFUSION_TPU_NO_AOT=1 never touch the store;
- the store-run trainer against the JAX package's trainer step on the same
  weights, t and noise.

The captures on the card: tests/test_torch_train_graphs_cuda.py.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from test_torch_training import _jax_unet_config, _random_params
from riffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from riffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from riffusion_tpu.parallel.train import DiffusionTrainer as JaxTrainer
from riffusion_tpu_torch import aot
from riffusion_tpu_torch.models.layers import precise
from riffusion_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from riffusion_tpu_torch.models.weights import random_bundle, state_dict_from_jax
from riffusion_tpu_torch.ops.kernels import COUNTS, Counts
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.training.finetune import ema_update

HW = 16  # 16x16 latents: the tiny UNet's 256-query sites take `attention`
STEPS = 4


def schedule(step: int) -> float:
    """A rate that changes every step."""
    return 1e-3 * (1.0 + step) / (2.0 + step * step)


def _tiny_unet() -> UNet2DCondition:
    return random_bundle("tiny", seed=0, device="cpu").unet


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((2, HW, HW, 4)).astype(np.float32)
    context = rng.standard_normal((2, 77, 64)).astype(np.float32)
    return latents, context


def _generator(step: int) -> torch.Generator:
    """The run_finetune rule: one generator reseeded per step."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence([0, step]).generate_state(1)[0]))


def _trainer(dtype=torch.float32) -> DiffusionTrainer:
    trainer = DiffusionTrainer(device="cpu", learning_rate=schedule, dtype=dtype)
    trainer.init_from(_tiny_unet())
    return trainer


def reference_step(trainer: DiffusionTrainer, latents, context, *, generator):
    """`DiffusionTrainer.loss_and_grads` and `.step` as they were before the
    host/device split, for a trainer without a mesh."""
    dev, p = trainer.device, precise(trainer.dtype)

    def on_device(x, dtype):
        x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        return x.to(dev, dtype)

    latents = on_device(latents, p)
    context = on_device(context, p)
    b = latents.shape[0]
    t = torch.randint(0, trainer.noise_config.num_train_timesteps, (b,),
                      generator=generator, device=dev)
    noise = torch.randn(latents.shape, generator=generator, device=dev)
    t = on_device(t, torch.int64)
    noise = on_device(noise, p)
    from riffusion_tpu_torch.diffusion import schedulers as sched

    noisy = sched.add_noise(trainer.noise_config, latents, noise, t)
    if trainer.unet is not trainer.master:
        with torch.no_grad():
            for work, master in zip(trainer.unet.parameters(), trainer.master.parameters()):
                work.copy_(master)
    eps = trainer.unet(noisy.permute(0, 3, 1, 2), t, context)
    err = torch.square(eps.to(p) - noise.permute(0, 3, 1, 2))
    loss = torch.mean(err)
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if trainer.unet is not trainer.master:
        for work, master in zip(trainer.unet.parameters(), trainer.master.parameters()):
            master.grad = work.grad.to(p)
            work.grad = None
    loss = loss.detach()
    for group in trainer.optimizer.param_groups:
        group["lr"] = trainer.schedule(trainer.step_count)
    trainer.optimizer.step()
    trainer.step_count += 1
    return loss


def _state(trainer: DiffusionTrainer):
    """Masters, then each parameter's AdamW state (moments and step count)."""
    masters = [p.detach().clone() for p in trainer.master.parameters()]
    opt = [t.clone() for p in trainer.master.parameters()
           for t in trainer.optimizer.state[p].values()]
    return masters, opt


def _assert_equal_states(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1], strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------------------- the split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_step_equals_the_step_before_the_split(dtype):
    latents, context = _batch()
    split, ref = _trainer(dtype), _trainer(dtype)
    for step in range(3):
        a = split.step(latents, context, generator=_generator(step))
        b = reference_step(ref, latents, context, generator=_generator(step))
        assert a.shape == () and torch.equal(a, b), step
    assert split.step_count == ref.step_count == 3
    assert [g["lr"] for g in split.optimizer.param_groups] == [schedule(2)]
    _assert_equal_states(_state(split), _state(ref))


def test_a_step_that_raises_leaves_its_count(monkeypatch):
    """A device program that raises before its update (an out-of-memory in
    the forward, say) leaves step_count where it was: the retried step runs
    at its own rate and the run equals an uninterrupted one, bit for bit."""
    latents, context = _batch()
    retried, ref = _trainer(), _trainer()
    works = DiffusionTrainer._loss_and_grads

    def fails(self, *args):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(DiffusionTrainer, "_loss_and_grads", fails)
    with pytest.raises(RuntimeError, match="out of memory"):
        retried.step(latents, context, generator=_generator(0))
    assert retried.step_count == 0
    monkeypatch.setattr(DiffusionTrainer, "_loss_and_grads", works)
    for step in range(2):
        a = retried.step(latents, context, generator=_generator(step))
        assert torch.equal(a, ref.step(latents, context, generator=_generator(step))), step
    assert retried.step_count == ref.step_count == 2
    _assert_equal_states(_state(retried), _state(ref))


# ------------------------------------------------------------- the store


class _HostSync(TorchFunctionMode):
    """Refuses Tensor.item, as a CUDA stream capture refuses a host sync,
    except on the tensors of `host_resident`: the CPU optimizer's step
    counts, which torch keeps on the host on purpose (on the card the
    capturable optimizer keeps them on the device and reads none back)."""

    def __init__(self, host_resident=()):
        super().__init__()
        self.host_resident = {id(t) for t in host_resident}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.item and id(args[0]) not in self.host_resident:
            raise RuntimeError("operation not permitted when stream is capturing")
        return func(*args, **(kwargs or {}))


class StateGraphs(aot.CudaGraphs):
    """The card's graphs on the CPU, for programs that update state in place
    (the tensors `state()` gives). The warm-up runs the program, as on the
    card. A capture on the card runs nothing: here the program runs under
    _HostSync (a host sync is refused as a stream capture refuses it) and
    every tensor of `state()` is put back as it was, so the capture takes
    no step; it keeps their addresses. A replay runs the program again into
    the static outputs, without counting (a real replay runs no Python),
    and refuses where a tensor of `state()` was replaced since the capture:
    a graph would read the old one."""

    def __init__(self, state):
        super().__init__()
        self.state = state
        self.captures = self.replays = 0

    def pool(self):
        return "the trainer's pool"

    def warmup(self, fn, args):
        return fn(*args)

    def capture(self, fn, args, pool):
        tensors = self.state()
        saved = [t.detach().clone() for t in tensors]
        steps = [t for t in tensors if t.dim() == 0]  # AdamW's step counts
        try:
            with _HostSync(steps):
                outputs = fn(*args)
        finally:
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
        self.captures += 1
        return (fn, args, outputs, [t.data_ptr() for t in tensors]), outputs

    def replay(self, graph):
        fn, args, outputs, addresses = graph
        if [t.data_ptr() for t in self.state()] != addresses:
            raise RuntimeError("a replay would read state tensors replaced since its capture")
        before = COUNTS.snapshot()
        fresh = fn(*args)
        COUNTS.restore(before)
        for static, x in zip(aot._tensors(outputs), aot._tensors(fresh)):
            static.copy_(x)
        self.replays += 1


def _trainer_tensors(trainer, ema=None):
    return [*trainer.master.parameters(),
            *(t for s in trainer.optimizer.state.values() for t in s.values()),
            *(ema.values() if ema else ())]


@pytest.fixture
def store_on(monkeypatch):
    """The store on, on the CPU (as aot.captures says on the card)."""
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    monkeypatch.setattr(aot, "captures", lambda device: aot.enabled())


def _with_store(trainer, ema=None):
    graphs = StateGraphs(lambda: _trainer_tensors(trainer, ema))
    trainer.graph_store = aot.GraphStore(graphs)
    return graphs


def _run(trainer, steps, ema=None, decay=0.9, start=0):
    """run_finetune's loop: a step, then the EMA program; the losses and
    each step's (plain, K1, dK/dV, dQ) counts."""
    latents, context = _batch()
    ema_step = None if ema is None else trainer.program(
        "ema_update", functools.partial(ema_update, ema, dict(trainer.master.named_parameters()),
                                        decay))
    losses, counts = [], []
    for step in range(start, start + steps):
        COUNTS.reset()
        losses.append(trainer.step(latents, context, generator=_generator(step)))
        if ema_step is not None:
            ema_step()
        c = COUNTS
        counts.append((c.plain_calls, c.launches, c.bwd_dkv_launches, c.bwd_dq_launches))
    return losses, counts


@contextlib.contextmanager
def aot_off():
    """RIFFUSION_TPU_NO_AOT=1 inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RIFFUSION_TPU_NO_AOT", "1")
        yield


def _ema(trainer):
    return {n: p.detach().clone() for n, p in trainer.master.named_parameters()}


def test_store_captures_once_and_replays_bit_equal_to_eager(store_on, monkeypatch):
    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    eager = _trainer()
    eager_ema = _ema(eager)
    eager_losses, eager_counts = _run(eager, STEPS, eager_ema)
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT")

    graphed = _trainer()
    ema = _ema(graphed)
    graphs = _with_store(graphed, ema)
    losses, counts = _run(graphed, STEPS, ema)
    assert sorted(graphed.graph_store.programs) == ["ema_update", "train_step"]
    assert [len(p) for p in graphed.graph_store.programs.values()] == [1, 1]
    assert (graphs.captures, graphs.replays) == (2, 2 * (STEPS - 1))
    assert all(torch.equal(a, b) for a, b in zip(losses, eager_losses, strict=True))
    _assert_equal_states(_state(graphed), _state(eager))
    assert all(torch.equal(ema[k], eager_ema[k]) for k in ema)
    assert counts == eager_counts and counts[0] == (6, 0, 0, 0)  # 3 sites, forward and backward
    assert not torch.equal(ema["conv_in.weight"], eager.master.conv_in.weight)
    report = graphed.graph_store.programs["train_step"].reports()[0]
    assert report["key"] == "train_step" and report["warmup_s"] > 0


def test_restore_drops_the_graphs_and_resumes_as_an_uninterrupted_run(store_on, tmp_path):
    """A store-run trainer saves at step 2, takes one more step, and is
    restored from that checkpoint: the load replaces AdamW's state tensors,
    so the captured graphs go (a replay of them would be refused) and the
    next call captures again. Steps 3-4 then equal an uninterrupted eager
    run's (the resume test's tolerance, rtol 1e-6); so does a fresh
    store-run trainer restored from the same file."""
    with aot_off():
        whole = _trainer()
        whole_losses, _ = _run(whole, STEPS)

    trainer = _trainer()
    graphs = _with_store(trainer)
    _run(trainer, 2)
    trainer.save_checkpoint(tmp_path, 2)
    _run(trainer, 1, start=2)
    assert (graphs.captures, graphs.replays) == (1, 2)
    assert trainer.restore_checkpoint(tmp_path, 2) == (2, None)
    assert trainer.graph_store.programs == {}
    resumed, _ = _run(trainer, 2, start=2)
    assert (graphs.captures, graphs.replays) == (2, 3)

    fresh = _trainer()
    fresh_graphs = _with_store(fresh)
    fresh.restore_checkpoint(tmp_path, 2)
    fresh_losses, _ = _run(fresh, 2, start=2)
    assert (fresh_graphs.captures, fresh_graphs.replays) == (1, 1)
    for run, losses in ((trainer, resumed), (fresh, fresh_losses)):
        np.testing.assert_allclose([float(x) for x in losses],
                                   [float(x) for x in whole_losses[2:]], rtol=1e-6)
        for a, b in zip(run.master.parameters(), whole.master.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert [g["lr"] for g in trainer.optimizer.param_groups] == [schedule(3)]


def test_a_card_checkpoint_restores_on_the_cpu(tmp_path):
    """A checkpoint in the layout the card writes (the optimizer's groups
    capturable, float32 step counts, a float lr) restores into a CPU
    trainer, whose optimizer stays non-capturable, and the next steps equal
    the saving trainer's own."""
    saver = _trainer()
    _run(saver, 2)
    saver.save_checkpoint(tmp_path, 2)
    path = tmp_path / "state_2" / "state.pt"
    state = torch.load(path, weights_only=True)
    assert all(isinstance(g["lr"], float) for g in state["opt_state"]["param_groups"])
    for group in state["opt_state"]["param_groups"]:
        group["capturable"] = True
    torch.save(state, path)
    restored = _trainer()
    restored.restore_checkpoint(tmp_path, 2)
    assert not any(g["capturable"] for g in restored.optimizer.param_groups)
    ours, _ = _run(restored, 2, start=2)
    ref, _ = _run(saver, 2, start=2)
    assert all(torch.equal(a, b) for a, b in zip(ours, ref))
    _assert_equal_states(_state(restored), _state(saver))


def test_a_host_sync_in_the_step_fails_its_capture(store_on, monkeypatch):
    synced = DiffusionTrainer._train_step

    def with_item(self, *args):
        loss = synced(self, *args)
        loss.item()  # a host sync inside the device program
        return loss

    monkeypatch.setattr(DiffusionTrainer, "_train_step", with_item)
    trainer = _trainer()
    graphs = _with_store(trainer)
    latents, context = _batch()
    for _ in range(2):  # each call warms up and fails to capture again: no eager fallback
        with pytest.raises(aot.CaptureError, match=r"capturing train_step failed at .*item"):
            trainer.step(latents, context, generator=_generator(0))
    assert len(trainer.graph_store.programs["train_step"]) == 0
    assert graphs.replays == 0


@pytest.mark.parametrize("counter", [f.name for f in dataclasses.fields(Counts)])
def test_every_counter_comes_back_with_each_replay(counter):
    """A replay runs no Python: what the capture counted, the backward
    kernels' counters among them, is added again on every replay, and the
    capture's own counts are taken back."""
    def program(x):
        setattr(COUNTS, counter, getattr(COUNTS, counter) + 1)
        return x * 2.0

    graph = aot.GraphProgram(program, "k", graphs=StateGraphs(lambda: []))
    for _ in range(3):  # the capturing call, then two replays
        COUNTS.reset()
        assert torch.equal(graph(torch.ones(2)), torch.full((2,), 2.0))
        assert COUNTS.snapshot() == dict(Counts().snapshot(), **{counter: 1})
    assert (graph.graphs.captures, graph.graphs.replays) == (1, 2)


def test_the_switch_keeps_the_store_empty(store_on, monkeypatch):
    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    trainer = _trainer()
    graphs = _with_store(trainer)
    _run(trainer, 2, _ema(trainer))
    assert trainer.graph_store.programs == {} and (graphs.captures, graphs.replays) == (0, 0)


def _mesh_rank(rank: int, world: int) -> tuple:
    """A sharded step at mesh (2, 1, 1) with the store on: the programs run
    eagerly and the trainer's store stays empty."""
    from riffusion_tpu_torch.parallel.mesh import make_mesh

    aot.captures = lambda device: True
    trainer = DiffusionTrainer(device="cpu", learning_rate=schedule, dtype=torch.float32,
                               mesh=make_mesh((2, 1, 1), ("data", "model", "seq")))
    trainer.init_from(_tiny_unet())
    latents, context = _batch()
    loss = trainer.step(latents, context, generator=_generator(0))
    ema = _ema(trainer)
    fn = functools.partial(ema_update, ema, dict(trainer.master.named_parameters()), 0.9)
    return (float(loss), not isinstance(trainer.program("ema_update", fn), aot.GraphProgram),
            len(trainer.graph_store.programs))


def test_a_mesh_keeps_the_store_empty():
    from riffusion_tpu_torch.parallel.mesh import spawn_world

    results = spawn_world(_mesh_rank, 2, backend="gloo", timeout_s=300.0)
    assert [r[1:] for r in results] == [(True, 0)] * 2
    assert results[0][0] == results[1][0] and np.isfinite(results[0][0])


# ------------------------------------------------------------- against JAX


def test_store_run_trainer_matches_jax():
    """3 steps through the store of the 16-channel UNet of
    tests/test_torch_training.py against JAX's trainer on the same weights,
    t and noise (drawn as JAX's `_train_step` draws them): the losses to
    1e-5 relative, as that file's test holds the eager trainer."""
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

    jt = JaxTrainer(cfg, jax_make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1]),
                    learning_rate=1e-3, dtype=jnp.float32)
    p, opt = jt.init_from(params)
    jax_losses = []
    for key in keys:
        p, opt, loss = jt.step(p, opt, latents, context, key)
        jax_losses.append(float(loss))

    unet = UNet2DCondition(UNetConfig(**{f: getattr(cfg, f)
                                         for f in UNetConfig.__dataclass_fields__}))
    unet.load_state_dict(state_dict_from_jax(params), strict=True)
    trainer = DiffusionTrainer(device="cpu", learning_rate=1e-3, dtype=torch.float32)
    trainer.init_from(unet)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
        mp.setattr(aot, "captures", lambda device: aot.enabled())
        graphs = _with_store(trainer)
        losses = []
        for key in keys:
            k_t, k_noise = jax.random.split(key)
            t = np.asarray(jax.random.randint(k_t, (b,), 0, 1000))
            noise = np.asarray(jax.random.normal(k_noise, latents.shape, jnp.float32))
            losses.append(float(trainer.step(latents, context, t=t, noise=noise)))
    assert (graphs.captures, graphs.replays) == (1, 2)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
