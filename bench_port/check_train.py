"""
What decides `correct` in a fine-tuning cell: the trainer's first three
steps, which set-up drove through the window's own loop, followed by the
plain reference (reference/train.py) in float32 with TF32 off from the same
weights, batches and draws, once the program's memory is freed; and one
more run of the EMA's program after the window, on inputs of the
benchmark's own.

The numbers read (each compared where the cell gives it a limit):

- loss_gap: the largest relative gap between a step's loss and the
  reference's, over the three steps (read, not compared: PERF.md gives why);
- grad_gap: each step's gradient, as AdamW's first moment holds it
  (g = (m - b1 * m_before) / (1 - b1), m_before nought before the first
  step), by the worst leaf and the worst step: the gap between the norm of
  the program's gradient and the reference's, over the larger of the
  reference leaf's norm and the median leaf's. The first step runs eagerly
  and captures the step's graph; the second and third replay it;
- change_gap: each parameter's change after the three steps, by the worst
  leaf, measured as grad_gap is. Leaves whose first reference gradient is
  under a thousandth of the median leaf's move by round-off alone (under
  AdamW a gradient of nothing still takes a full step) and are left out;
- ema_gap: the EMA's program run once more after the window, on an EMA at
  the run's start weights and parameters a seeded draw away from it
  (`ema_probe`), against the reference's update of the same inputs. Both
  sides start from the same numbers, so the update is compared element by
  element: the worst leaf's norm of the difference, over the larger of the
  reference's change of that leaf and the median leaf's. An update that
  leaves the EMA as it was reads 1.

The limits are the cell's (`check.limits` of workloads/<cell>.json); PERF.md
gives the readings each was set from.
"""

from __future__ import annotations

import statistics
import typing as T

import numpy as np
import torch

from bench_port import harness
from bench_port.reference import sd, train

#: A leaf moves by round-off alone where its reference gradient is under
#: this share of the median leaf's.
STILL_LEAF = 1e-3

#: The EMA probe's parameters lie a normal draw away from its EMA, at the
#: larger of the leaf's root mean square and this.
PROBE_SCALE = 0.02


def norm_gap(program: T.Mapping[str, float], ref: T.Mapping[str, float],
             leaves: T.Iterable[str]) -> T.Tuple[float, str]:
    """(worst gap of norms, its leaf) over `leaves`."""
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(program[k] - ref[k]) / max(ref[k], median, 1e-30)
        if gap > worst:
            worst, where = gap, k
    return worst, where


def ema_probe(start: T.Mapping[str, torch.Tensor], seed: int
              ) -> T.Iterator[T.Tuple[str, torch.Tensor, torch.Tensor]]:
    """(leaf, EMA, parameters) of the EMA probe, leaf by leaf in sorted
    order: the EMA at the run's start weights `start` (diffusers names), the
    parameters a normal draw away from them, from a generator on their
    device seeded from the run's seed."""
    device = next(iter(start.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFF, 13])
                        .generate_state(1)[0]))
    for key in sorted(start):
        ema = start[key].float()
        scale = max(float(torch.linalg.vector_norm(ema)) / max(ema.numel(), 1) ** 0.5,
                    PROBE_SCALE)
        yield key, ema, ema + scale * torch.randn(ema.shape, generator=gen, device=device)


def ema_gap(start: T.Mapping[str, torch.Tensor], seed: int, decay: float,
            served: T.Callable[[str, torch.Tensor, torch.Tensor], torch.Tensor]
            ) -> T.Tuple[float, str]:
    """(worst leaf's gap, the leaf) of `served(leaf, ema, params)`, the
    probe's EMA after the update under test, against the reference's."""
    gaps, changes = {}, {}
    for key, ema, params in ema_probe(start, seed):
        ref = train.ema_update(ema, params, decay)
        gaps[key] = float(torch.linalg.vector_norm(served(key, ema, params).float() - ref))
        changes[key] = float(torch.linalg.vector_norm(ref - ema))
    median = statistics.median(changes.values())
    worst = max(gaps, key=lambda k: gaps[k] / max(changes[k], median, 1e-30))
    return gaps[worst] / max(changes[worst], median, 1e-30), worst


def reference_readings(config, state, arrays, seed: int, batch: int, steps: int,
                       nx: sd.Numerics = sd.FP32, keep_rows: T.Optional[int] = None
                       ) -> T.Dict[str, T.Any]:
    """The reference's losses, each step's gradient norms and the change
    norms (`nx` and `keep_rows` plant the control and a fault:
    train.Trainer)."""
    device = next(iter(state.values())).device
    ref = train.Trainer(state, config, nx, keep_rows)
    initial = {k: v.detach().clone() for k, v in ref.params.items()}
    stream = train.batches(arrays["mean"], arrays["logvar"], arrays["ctx"], arrays["contexts"],
                           config["dataset"]["scaling_factor"], batch, seed)
    gen = torch.Generator(device=device)
    losses = []
    for step in range(steps):
        latents, contexts = next(stream)
        gen.manual_seed(train.step_seed(seed, step))
        losses.append(ref.step(latents, contexts, gen))
    with torch.no_grad():
        return {"losses": losses, "grad_norms": ref.grad_norms,
                "change_norms": {k: float(torch.linalg.vector_norm(ref.params[k] - initial[k]))
                                 for k in ref.params}}


def readings(program: T.Mapping[str, T.Any], ref: T.Mapping[str, T.Any],
             worst: T.Optional[T.Dict[str, str]] = None) -> T.Dict[str, float]:
    """loss_gap, grad_gap and change_gap; `worst` gets the leaf (and step)
    each norm gap was read at."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    grad_gap, grad_at = 0.0, ""
    for step, (mine, theirs) in enumerate(zip(program["grad_norms"], ref["grad_norms"])):
        gap, leaf = norm_gap(mine, theirs, theirs)
        if gap >= grad_gap:
            grad_gap, grad_at = gap, f"{leaf} (step {step})"
    first = ref["grad_norms"][0]
    median = statistics.median(first.values())
    moving = [k for k, g in first.items() if g >= STILL_LEAF * median]
    change_gap, change_leaf = norm_gap(program["change_norms"], ref["change_norms"], moving)
    if worst is not None:
        worst.update(grad_gap=grad_at, change_gap=change_leaf,
                     still_leaves=str(len(first) - len(moving)))
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "change_gap": float(change_gap)}


def check(record: harness.Record, states, arrays, seed: int, batch: int,
          program: T.Mapping[str, T.Any]) -> None:
    limits = record.cell["check"]["limits"]
    ref = reference_readings(record.config, sd.widened(states["unet"]), arrays, seed, batch,
                             len(program["losses"]))
    record.notes["loss_gaps"] = [(p - r) / r for p, r in zip(program["losses"], ref["losses"])]
    worst: T.Dict[str, str] = {}
    numbers = readings(program, ref, worst)
    del ref
    numbers["ema_gap"], worst["ema_gap"] = ema_gap(
        states["unet"], record.seed, record.config["finetune"]["ema_decay"],
        lambda key, ema, params: program["ema"][key])
    record.notes["worst_leaf"] = worst
    record.notes["readings"] = numbers
    record.checks = [harness.Check(name, value, limits[name])
                     for name, value in numbers.items() if name in limits]
