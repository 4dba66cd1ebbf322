"""
The trainer's CUDA graphs on a card (riffusion_tpu_torch/parallel/train.py
`DiffusionTrainer.step` and `.program`, aot.py): the tiny UNet's
fine-tuning step (fp32, 32x32 latents: K1 with its log-sum-exp and both
backward kernels at the 1024- and 256-query sites) and the EMA update,
captured and replayed, against the same steps run eagerly
(RIFFUSION_TPU_NO_AOT=1) with the same capturable optimizer; the launch
counts per step; a restore followed by a replay; checkpoints between the
card and the CPU; a host sync refused at capture; a trainer with a mesh
on the card keeps the eager optimizer it had before graphs (not
capturable, a float lr, its step counts on the host). Every test is marked
`cuda` and skips where torch sees no card. No jax import, so it runs on a
card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_train_graphs_cuda.py

Replay against eager: where two eager runs are bit-equal (the card's
backward deterministic at these shapes), the replayed run must be too;
where they are not, it must lie within twice their distance of the
nearer one.
"""

import functools

import numpy as np
import pytest
import torch

from riffusion_tpu_torch import aot
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.training.finetune import ema_update
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

HW = 32  # 32x32 latents: the 1024- and 256-query sites take K1
STEPS = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and the Hopper kernels have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


def schedule(step: int) -> float:
    return 1e-3 * (1.0 + step) / (2.0 + step * step)


def _trainer(card) -> DiffusionTrainer:
    trainer = DiffusionTrainer(device=card, learning_rate=schedule, dtype=torch.float32)
    trainer.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    return trainer


def _steps(trainer, card, steps, start=0, ema=None):
    """run_finetune's loop from step `start`: the losses (floats, read at the
    end) and each step's (K1, dK/dV, dQ, plain) counts."""
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((2, HW, HW, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    ema_step = None if ema is None else trainer.program("ema_update", functools.partial(
        ema_update, ema, dict(trainer.master.named_parameters()), 0.9))
    gen = torch.Generator(device=card)
    losses, counts = [], []
    for step in range(start, start + steps):
        gen.manual_seed(1000 + step)
        COUNTS.reset()
        losses.append(trainer.step(latents, context, generator=gen))
        if ema_step is not None:
            ema_step()
        c = COUNTS
        counts.append((c.launches, c.bwd_dkv_launches, c.bwd_dq_launches, c.plain_calls))
    torch.cuda.synchronize()
    return [float(x) for x in losses], counts


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().flatten() for t in tensors])


def _run(card, monkeypatch, eager: bool) -> dict:
    if eager:
        monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    else:
        monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    trainer = _trainer(card)
    ema = {n: p.detach().clone() for n, p in trainer.master.named_parameters()}
    losses, counts = _steps(trainer, card, STEPS, ema=ema)
    return {"trainer": trainer, "losses": losses, "counts": counts,
            "masters": _flat(trainer.master.parameters()), "ema": _flat(ema.values())}


@pytest.fixture(scope="module")
def eager_runs(card):
    with pytest.MonkeyPatch.context() as mp:
        runs = [_run(card, mp, eager=True) for _ in range(2)]
    return runs, _flat(_trainer(card).master.parameters())


def _agrees(losses, flats: dict, eager_runs, first: int = 0):
    """Bit-equal to the eager runs where they are bit-equal to each other;
    else, from the nearer of them, within twice their distance: each flat
    (the masters, the EMA) as movement from the start, and the losses from
    step `first` on."""
    runs, start = eager_runs
    a, b = runs
    if a["losses"] == b["losses"] and all(torch.equal(a[k], b[k]) for k in flats):
        assert losses == a["losses"][first:]
        for key, flat in flats.items():
            assert torch.equal(flat, a[key]), key
        return
    for key, flat in flats.items():
        moved = (a[key] - start).norm()
        eager_rel = float((a[key] - b[key]).norm() / moved)
        ours = min(float((flat - r[key]).norm() / moved) for r in runs)
        assert ours <= max(2 * eager_rel, 1e-6), (key, ours, eager_rel)
    eager_loss = _loss_rel(a["losses"], b["losses"])
    ours = min(_loss_rel(losses, r["losses"][first:]) for r in runs)
    assert ours <= max(2 * eager_loss, 1e-7), (ours, eager_loss)


def _loss_rel(ours, ref) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(ours, ref))


def test_step_and_ema_replay_as_eager(card, eager_runs, monkeypatch):
    """The first step warms up (a real step) and captures "train_step" and
    "ema_update"; steps 2-4 replay. Every step counts the eager step's 6 K1
    forwards, 6 dK/dV and 6 dQ launches and no plain call."""
    ours = _run(card, monkeypatch, eager=False)
    programs = ours["trainer"].graph_store.programs
    assert sorted(programs) == ["ema_update", "train_step"]
    assert all(len(p) == 1 for p in programs.values())
    assert ours["counts"] == eager_runs[0][0]["counts"] == [(6, 6, 6, 0)] * STEPS
    _agrees(ours["losses"], {k: ours[k] for k in ("masters", "ema")}, eager_runs)


def test_restore_then_replay(card, eager_runs, tmp_path, monkeypatch):
    """A trainer that captured its step saves at step 2, takes one more
    step, restores the checkpoint (its graphs go: the load replaced AdamW's
    state tensors), and takes steps 3-4 (a new capture, then a replay):
    they agree with the uninterrupted eager runs as a replayed run does."""
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    trainer = _trainer(card)
    _steps(trainer, card, 2)
    first = trainer.graph_store.programs["train_step"]
    trainer.save_checkpoint(tmp_path, 2)
    _steps(trainer, card, 1, start=2)
    trainer.restore_checkpoint(tmp_path, 2)
    assert trainer.graph_store.programs == {}
    losses, counts = _steps(trainer, card, 2, start=2)
    assert trainer.graph_store.programs["train_step"] is not first
    assert counts == [(6, 6, 6, 0)] * 2
    _agrees(losses, {"masters": _flat(trainer.master.parameters())}, eager_runs, first=2)


def test_checkpoints_move_between_the_card_and_the_cpu(card, eager_runs, tmp_path,
                                                       monkeypatch):
    """A checkpoint written on the card (step counts on the device) restores
    into a CPU trainer (non-capturable, counts on the host) with the same
    masters, moments and counts; that trainer's checkpoint restores on the
    card (capturable, counts on the device), whose steps 3-4 through the
    graph agree with the uninterrupted eager runs as a replayed run does."""
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    gpu = _trainer(card)
    _steps(gpu, card, 2)
    gpu.save_checkpoint(tmp_path / "card", 2)
    cpu = DiffusionTrainer(device="cpu", learning_rate=schedule, dtype=torch.float32)
    cpu.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    assert cpu.restore_checkpoint(tmp_path / "card", 2) == (2, None)
    assert not any(g["capturable"] for g in cpu.optimizer.param_groups)
    for a, b in zip(cpu.master.parameters(), gpu.master.parameters()):
        assert torch.equal(a, b.cpu())
        for key, value in gpu.optimizer.state[b].items():
            assert torch.equal(cpu.optimizer.state[a][key], value.cpu()), key
    assert all(s["step"].device.type == "cpu" for s in cpu.optimizer.state.values())
    cpu.save_checkpoint(tmp_path / "cpu", 2)
    back = _trainer(card)
    back.restore_checkpoint(tmp_path / "cpu", 2)
    assert all(g["capturable"] for g in back.optimizer.param_groups)
    assert all(s["step"].device.type == "cuda" for s in back.optimizer.state.values())
    losses, counts = _steps(back, card, 2, start=2)
    assert counts == [(6, 6, 6, 0)] * 2 and len(back.graph_store.programs["train_step"]) == 1
    _agrees(losses, {"masters": _flat(back.master.parameters())}, eager_runs, first=2)


def test_a_host_sync_in_the_step_is_refused(card, monkeypatch):
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    synced = DiffusionTrainer._train_step

    def with_item(self, *args):
        loss = synced(self, *args)
        loss.item()
        return loss

    monkeypatch.setattr(DiffusionTrainer, "_train_step", with_item)
    trainer = _trainer(card)
    with pytest.raises(aot.CaptureError, match="capturing train_step failed"):
        _steps(trainer, card, 1)
    assert len(trainer.graph_store.programs["train_step"]) == 0


def _mesh_rank(rank: int, world: int) -> tuple:
    """Two steps of a trainer over a (1, 1, 1) mesh on the card, the store
    on: its optimizer's groups' capturable flags and lr types, the step
    counts' devices, the store's size, the count and the losses."""
    from riffusion_tpu_torch.parallel.mesh import make_mesh

    card = torch.device("cuda")
    torch_util.configure_numerics()
    trainer = DiffusionTrainer(device=card, learning_rate=schedule, dtype=torch.float32,
                               mesh=make_mesh((1, 1, 1), ("data", "model", "seq"),
                                              device_type="cuda"))
    trainer.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    losses, _ = _steps(trainer, card, 2)
    groups = trainer.optimizer.param_groups
    return ([g["capturable"] for g in groups], [type(g["lr"]).__name__ for g in groups],
            {s["step"].device.type for s in trainer.optimizer.state.values()},
            len(trainer.graph_store.programs), trainer.step_count, losses)


def test_a_mesh_on_the_card_keeps_the_eager_optimizer(card, monkeypatch):
    from riffusion_tpu_torch.parallel.mesh import spawn_world

    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    (capturable, lr_types, step_devices, programs, count, losses), = spawn_world(
        _mesh_rank, 1, backend="gloo", timeout_s=300.0)
    assert capturable == [False] and lr_types == ["float"] and step_devices == {"cpu"}
    assert (programs, count) == (0, 2) and np.all(np.isfinite(losses))
