"""
The one-pass AdamW (riffusion_tpu_torch/ops/adamw.py) on the CPU, where it
runs its plain version, and the trainer's choice of optimizer
(parallel/train.py):

- the plain version against torch.optim.AdamW over five steps, with and
  without weight decay, at a float and at a 0-d tensor lr, on fp32 leaves
  whose gradients come from bf16 and fp32 working leaves; the first step's
  bias correction seen on its own (AdamW's first step moves an element by
  lr, whatever its gradient's scale);
- the update from a working copy's bf16 gradient equals, bit for bit, the
  update from the same gradient handed to the master's `.grad` in fp32;
- a state_dict round trip in both directions between OnePassAdamW and
  torch.optim.AdamW, which then step alike;
- the launch count and the constants the wrapper shares with
  csrc/adamw.cu;
- the CPU trainer keeps torch's AdamW and its gradient hand-off; a trainer
  that takes the one-card optimizer (its `_capturable` forced on the CPU)
  runs no `riffusion.train.grads` stage, leaves no gradient behind, agrees
  with the hand-off trainer's first step, and its public `loss_and_grads` still hands
  fp32 gradients to the masters;
- tracing.export() reports `adamw_launches`.

The kernel itself on a card: tests/test_torch_adamw_cuda.py.
"""

import contextlib
import copy
import re

import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops import adamw
from riffusion_tpu_torch.ops.kernels import COUNTS, CSRC, FORWARD_KERNELS, TRAIN_KERNELS
from riffusion_tpu_torch.parallel import train as train_mod
from riffusion_tpu_torch.parallel.train import DiffusionTrainer

# leaf shapes (a conv, a linear, a norm, an odd size) and their working dtypes
LEAVES = [((8, 4, 3, 3), torch.bfloat16), ((16, 8), torch.bfloat16), ((16,), torch.float32),
          ((37,), torch.float32)]
STEPS = 5
# Both versions run the same fp32 operations; torch's rounds its bias
# corrections from Python floats where the plain version rounds them from
# fp64 tensors, the same values, so what is left is a few fp32 roundings:
# 1e-6 of the masters (magnitude ~2) is about 8 ulps. A step without its
# bias correction, or without the decay at wd 0.1 and lr 0.05, moves the
# masters by 5e-3 or more.
RTOL, ATOL = 1e-6, 1e-6


def _leaves(seed: int = 0):
    """Fresh fp32 masters and their working copies (LEAVES' dtypes)."""
    gen = torch.Generator().manual_seed(seed)
    masters = [torch.nn.Parameter(torch.randn(shape, generator=gen)) for shape, _ in LEAVES]
    working = [torch.nn.Parameter(m.detach().to(dtype)) for m, (_, dtype) in zip(masters, LEAVES)]
    return masters, working


def _grads(step: int):
    """Each leaf's gradient at `step`, in its working dtype, at scales from
    1e-3 to 10."""
    gen = torch.Generator().manual_seed(100 + step)
    return [(torch.randn(shape, generator=gen) * 10.0 ** (i - 3 + step % 2)).to(dtype)
            for i, (shape, dtype) in enumerate(LEAVES)]


def _copy(params):
    return [torch.nn.Parameter(p.detach().clone()) for p in params]


def _assert_state_close(ours, ref, ours_params, ref_params, rtol=RTOL, atol=ATOL):
    for p, q in zip(ours_params, ref_params):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=rtol, atol=atol)
        a, b = ours.state[p], ref.state[q]
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        assert float(a["step"]) == float(b["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(a[key], b[key], rtol=rtol, atol=atol)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1], ids=["no_decay", "decay"])
@pytest.mark.parametrize("tensor_lr", [False, True], ids=["float_lr", "tensor_lr"])
def test_plain_version_matches_torch_adamw(tensor_lr, weight_decay):
    masters, working = _leaves()
    ref_params = _copy(masters)
    lr = torch.tensor(0.05) if tensor_lr else 0.05
    ours = adamw.OnePassAdamW(masters, working=working, lr=lr, weight_decay=weight_decay)
    ref = torch.optim.AdamW(ref_params, lr=lr, weight_decay=weight_decay, foreach=False)
    for step in range(STEPS):
        for w, q, g in zip(working, ref_params, _grads(step)):
            w.grad, q.grad = g, g.float()
        ours.step()
        ref.step()
        _assert_state_close(ours, ref, masters, ref_params)


def test_the_first_step_is_bias_corrected():
    """m-hat = g and v-hat = g^2 after one step, so each element moves by
    lr * g / (|g| + eps): lr, within 1e-4, wherever |g| > 1e-3, at every
    gradient scale (without the correction it would move by lr * 0.1 /
    sqrt(0.001), 3.16 lr)."""
    masters, working = _leaves()
    start = [m.detach().clone() for m in masters]
    opt = adamw.OnePassAdamW(masters, working=working, lr=0.05, weight_decay=0.0)
    grads = _grads(0)
    for w, g in zip(working, grads):
        w.grad = g
    opt.step()
    for m, s, g in zip(masters, start, grads):
        big = g.float().abs() > 1e-3
        moved = ((s - m.detach()) * torch.sign(g.float()))[big]
        assert moved.numel() > 0
        torch.testing.assert_close(moved, torch.full_like(moved, 0.05), rtol=1e-4, atol=0.0)


def test_a_bf16_working_gradient_equals_the_same_gradient_in_fp32():
    masters, working = _leaves()
    handed = _copy(masters)
    from_working = adamw.OnePassAdamW(masters, working=working, lr=torch.tensor(0.05),
                                      weight_decay=0.1)
    from_master = adamw.OnePassAdamW(handed, lr=torch.tensor(0.05), weight_decay=0.1)
    for step in range(STEPS):
        for w, q, g in zip(working, handed, _grads(step)):
            w.grad, q.grad = g, g.float()
        from_working.step()
        from_master.step()
    _assert_state_close(from_working, from_master, masters, handed, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("direction", ["ours_to_torch", "torch_to_ours"])
def test_state_dict_round_trip(direction):
    """Two steps in one optimizer, its state_dict loaded into the other kind
    over a copy of the masters, then two more steps in both from the same
    gradients: the same state."""
    masters, _ = _leaves()
    other = _copy(masters)
    kinds = {"ours": lambda ps: adamw.OnePassAdamW(ps, lr=0.05, weight_decay=0.1),
             "torch": lambda ps: torch.optim.AdamW(ps, lr=0.05, weight_decay=0.1, foreach=False)}
    first, second = direction.split("_to_")
    a = kinds[first](masters)
    for step in range(2):
        for p, g in zip(masters, _grads(step)):
            p.grad = g.float()
        a.step()
    with torch.no_grad():
        for q, p in zip(other, masters):
            q.copy_(p)
    b = kinds[second](other)
    b.load_state_dict(copy.deepcopy(a.state_dict()))  # as a checkpoint: tensors of its own
    assert a.state_dict()["param_groups"] == b.state_dict()["param_groups"]
    for step in range(2, 4):
        for p, q, g in zip(masters, other, _grads(step)):
            p.grad, q.grad = g.float(), g.float()
        a.step()
        b.step()
    _assert_state_close(a, b, masters, other)


def test_the_optimizer_refuses_what_the_pass_does_not_compute():
    masters, _ = _leaves()
    for flag in ("amsgrad", "maximize"):
        with pytest.raises(ValueError, match=flag):
            adamw.OnePassAdamW(masters, lr=0.05, **{flag: True})


@pytest.mark.parametrize("numels,expected", [
    ([10] * 686, 20), ([10] * 72, 2), ([10] * 73, 4), ([0] * 3, 1), ([0] * 72 + [5], 3), ([], 0),
])
def test_launches(numels, expected):
    assert adamw.launches(numels) == expected


def test_constants_match_the_kernel_source():
    text = (CSRC / "adamw.cu").read_text()

    def constant(name: str) -> str:
        return re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)

    assert adamw.LEAVES_PER_LAUNCH == int(constant("kMaxLeaves"))
    assert "adamw" in TRAIN_KERNELS and "adamw" not in FORWARD_KERNELS


# --------------------------------------------------------------- the trainer

def schedule(step: int) -> float:
    return 1e-3 * (1.0 + step) / (2.0 + step * step)


def _batch(step: int):
    rng = np.random.default_rng(step)
    latents = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    context = rng.standard_normal((2, 77, 64)).astype(np.float32)
    return latents, context, torch.Generator().manual_seed(1000 + step)


def _trainer(monkeypatch, one_card: bool) -> DiffusionTrainer:
    """A bf16-compute CPU trainer; with `one_card` it takes the one-card
    optimizer and step (its `_capturable` forced: on the CPU the pass runs
    its plain version)."""
    with monkeypatch.context() as mp:
        if one_card:
            mp.setattr(DiffusionTrainer, "_capturable", property(lambda self: True))
        trainer = DiffusionTrainer(device="cpu", learning_rate=schedule, dtype=torch.bfloat16)
        trainer.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    return trainer


@contextlib.contextmanager
def _stages(monkeypatch):
    """The names of the device stages entered inside the block."""
    names, real = [], tracing.stage

    def stage(name):
        names.append(name)
        return real(name)

    with monkeypatch.context() as mp:
        mp.setattr(train_mod.tracing, "stage", stage)
        yield names


def test_the_cpu_trainer_keeps_torch_adamw_and_the_hand_off(monkeypatch):
    trainer = _trainer(monkeypatch, one_card=False)
    assert type(trainer.optimizer) is torch.optim.AdamW
    latents, context, gen = _batch(0)
    with _stages(monkeypatch) as names:
        trainer.step(latents, context, generator=gen)
    assert "riffusion.train.grads" in names


def test_the_one_card_step_reads_the_working_gradients(monkeypatch):
    """Each trainer's first step from the same weights and draws: the
    one-card one runs no grads stage and leaves no gradient anywhere, and
    its masters and moments agree with the hand-off trainer's. The two
    differ only in where the bf16 gradient is widened (bit-equal, test
    above) and in fp32 roundings of the update: 1.4e-6 of the masters'
    movement, one ulp at most, so 1e-5 passes it, where a gradient read
    from the wrong leaf or left out moves the masters by their whole
    movement. Later steps are compared nowhere: a one-ulp master can round
    the next bf16 working copy across a boundary, and Adam's normalised
    update amplifies the bf16 gradients that follow (4% of the movement by
    the second step). Two more one-card steps keep to the same rules."""
    patched = _trainer(monkeypatch, one_card=True)
    plain = _trainer(monkeypatch, one_card=False)
    assert isinstance(patched.optimizer, adamw.OnePassAdamW)
    assert all(g["capturable"] for g in patched.optimizer.param_groups)
    start = [p.detach().clone() for p in plain.master.parameters()]
    for step in range(3):
        latents, context, gen = _batch(step)
        with monkeypatch.context() as mp:
            mp.setattr(DiffusionTrainer, "_capturable", property(lambda self: True))
            with _stages(monkeypatch) as names:
                patched.step(latents, context, generator=gen)
        assert "riffusion.train.grads" not in names and "riffusion.train.optimizer" in names
        assert all(p.grad is None for p in patched.master.parameters())
        assert all(w.grad is None for w in patched.unet.parameters())
        if step:
            continue
        plain.step(latents, context, generator=_batch(step)[2])
        moved = torch.cat([(p.detach() - s).flatten() for p, s in
                           zip(plain.master.parameters(), start)]).norm()
        gap = torch.cat([(a.detach() - b.detach()).flatten() for a, b in
                         zip(patched.master.parameters(), plain.master.parameters())]).norm()
        assert float(gap / moved) < 1e-5, float(gap / moved)
        for key in ("exp_avg", "exp_avg_sq"):
            ours = torch.cat([patched.optimizer.state[p][key].flatten()
                              for p in patched.master.parameters()])
            ref = torch.cat([plain.optimizer.state[p][key].flatten()
                             for p in plain.master.parameters()])
            assert float((ours - ref).norm() / ref.norm()) < 1e-5, key
    assert {float(s["step"]) for s in patched.optimizer.state.values()} == {3.0}


def test_loss_and_grads_still_hands_fp32_gradients_to_the_masters(monkeypatch):
    trainer = _trainer(monkeypatch, one_card=True)
    latents, context, gen = _batch(0)
    with monkeypatch.context() as mp:
        mp.setattr(DiffusionTrainer, "_capturable", property(lambda self: True))
        with _stages(monkeypatch) as names:
            trainer.loss_and_grads(latents, context, generator=gen)
    assert "riffusion.train.grads" in names
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in trainer.master.parameters())
    assert all(w.grad is None for w in trainer.unet.parameters())


def test_tracing_export_reports_the_adamw_launches():
    COUNTS.reset()
    COUNTS.adamw_launches += 20
    try:
        counters = tracing.Tracer().export()["counters"]
    finally:
        COUNTS.reset()
    assert "adamw_launches" in tracing.KERNEL_COUNTERS and counters["adamw_launches"] == 20
