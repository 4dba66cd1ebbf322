"""
Where a fine-tuning step's time goes on the card: `DiffusionTrainer` at
full SD v1 width (random:full, fp32 masters, bf16 compute), UNet batch 4 on
64x64x4 latents with (4, 77, 768) contexts, AdamW and an EMA update as
`run_finetune` runs them, eagerly and replayed as CUDA graphs.

    python -m riffusion_tpu_torch.profile_train [--out result.json] [--mesh D M S]

Without --mesh the step and the EMA run in two modes, one after the other,
on one trainer: "eager" (RIFFUSION_TPU_NO_AOT=1: the device programs run op
by op) and then "graph" (the trainer's store: the first step warms up and
captures "train_step" and "ema_update", later steps replay; node counts
kept). With --mesh the step is the sharded one (parallel/train.py
DiffusionTrainer(mesh=)), which always runs eagerly, over a ("data",
"model", "seq") mesh of D x M x S ranks spawned on this host
(parallel.mesh.spawn_world: nccl with a card per rank, gloo where ranks
share a card), each calling it with the same batch; rank 0 reports, and
its profile also gives each riffusion.train.* span's host time (a gloo
all-reduce runs on the host: its device time is only the copies).

Prints, and writes as JSON with --out, the card's name and power limit,
then for each mode:
- the first step's seconds (in "graph" mode the warm-up step and both
  captures, with each program's warm-up and capture seconds and node
  count);
- the step time (host clock, each step ending in torch.cuda.synchronize)
  of 5 steps after 3 earlier ones (the first among them), and the peak
  device memory allocated and reserved since the mode began (after
  torch.cuda.empty_cache: the eager mode's cache does not count in the
  graph mode's), and the memory reserved between steps;
- for 2 further steps under torch.profiler: the device's busy time (the
  sum of kernel and copy times; one stream) against the steps' wall time
  (the idle share), the device operations, the launch counts, the
  attention kernels' time (K1 forward, dK/dV, dQ) and the 15 kernels with
  the most device time; in eager mode also each part's kernel time
  (`kernel_ms_by_part`: the kernels that start in the device range of a
  stage of STAGES or of AdamW's own annotation, and the backward's, which
  start in none of them; a replay has no ranges) and each
  riffusion.train.* span's host time;
- the SM clock, power and clock-event reasons over each window
  (profile_batch.ClockSampler).
The batch is random (a seeded torch.Generator on the card): a step's work
does not depend on the values.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The attention kernels of a step as the profiler names them: K1's forward
# (csrc/attention_fwd.cuh's bf16 body, which K2 also runs but training never
# reaches) and the two backward kernels (csrc/attention_bwd.cuh).
ATTENTION_KERNELS = {"k1_forward": "attention_fwd_bf16_kernel",
                     "dkv": "attention_dkv_bf16_kernel", "dq": "attention_dq_bf16_kernel"}

#: The single-device modes in the order they run: eager first, so that its
#: peak holds no graph pool.
MODES = ("eager", "graph")

#: The device stages of a step (parallel/train.py, and training/finetune.py's
#: ema_update), the parts an eager step's kernel time is given to. The spans
#: around them (riffusion.train.step, .upload, riffusion.launch) are no
#: parts.
STAGES = ("riffusion.train.copy", "riffusion.train.forward", "riffusion.train.backward",
          "riffusion.train.grads", "riffusion.train.allreduce", "riffusion.train.optimizer",
          "riffusion.train.ema")

#: The profiler gives a kernel to the innermost annotation open at its
#: launch, so AdamW's kernels lie in the device range of its own annotation
#: (Optimizer.step#OnePassAdamW.step on one card, Optimizer.step#AdamW.step
#: over a mesh), which stands for riffusion.train.optimizer.
OPTIMIZER_ANNOTATION = "Optimizer.step#"

#: The part of the kernels that start in no stage's range.
BACKWARD = "backward (outside every stage)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    parser.add_argument("--mesh", type=int, nargs=3, default=None, metavar=("D", "M", "S"),
                        help="profile the sharded step over a (data, model, seq) mesh")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch sees no CUDA device")
    if args.mesh is None:
        result = _profile(0, 1, None)
    else:
        from riffusion_tpu_torch.parallel.mesh import backend_for, spawn_world

        world = args.mesh[0] * args.mesh[1] * args.mesh[2]
        result = spawn_world(_profile, world, (tuple(args.mesh),),
                             backend=backend_for("cuda", world))[0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def _profile(rank: int, world: int, mesh_shape) -> dict:
    """The profile on this rank (every rank of a mesh steps; rank 0 alone
    samples the clocks, profiles, prints and returns the result)."""
    import functools

    import torch

    from riffusion_tpu_torch import aot
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.profile_batch import ClockSampler, _store
    from riffusion_tpu_torch.training.finetune import ema_update

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clocks = None
    if rank == 0:
        print(card, flush=True)
        clocks = ClockSampler()

    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.float32).unet
    mesh = None if mesh_shape is None else make_mesh(mesh_shape, ("data", "model", "seq"))
    trainer = DiffusionTrainer(device=dev, learning_rate=1e-5, dtype=torch.bfloat16, mesh=mesh)
    trainer.init_from(unet)
    trainer.graph_store = aot.GraphStore(aot.CudaGraphs(count_nodes=True))
    del unet
    params = dict(trainer.master.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    latents = torch.randn(4, 64, 64, 4, generator=gen, device=dev)
    context = torch.randn(4, 77, 768, generator=gen, device=dev)
    result: dict = {"card": card, "batch": 4, "latents": [64, 64, 4], "mesh": mesh_shape,
                    "ranks": world, "modes": {}}
    prior = os.environ.get("RIFFUSION_TPU_NO_AOT")  # the caller's switch, put back at the end
    for mode in MODES if mesh is None else ("eager",):
        _store(mode)
        ema_step = trainer.program("ema_update",
                                   functools.partial(ema_update, ema, params, 0.999))

        def step() -> float:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            trainer.step(latents, context, generator=gen)
            ema_step()  # inside its stage, riffusion.train.ema
            torch.cuda.synchronize()
            return time.monotonic() - t0

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = step()
        for _ in range(2):
            step()
        t0 = time.monotonic()
        times = [step() for _ in range(5)]
        entry: dict = {
            "first_step_s": first, "step_s": times, "step_s_median": statistics.median(times),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "max_memory_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            # what the mode holds between steps: the state, and the graph pool
            "memory_reserved_gib_held": torch.cuda.memory_reserved() / 2**30,
            "clocks": clocks.summary(t0, time.monotonic()) if clocks else None,
            "programs": {key: program.reports()
                         for key, program in trainer.graph_store.programs.items()},
        }
        result["modes"][mode] = entry
        if rank:  # the other ranks take their part in the profiled steps' collectives
            for _ in range(2):
                step()
            continue
        print(f"{mode}: first step {first:.4f} s; steps {[f'{x:.4f}' for x in times]} s "
              f"(median {entry['step_s_median']:.4f}); peak allocated "
              f"{entry['max_memory_allocated_gib']:.2f} GiB, reserved "
              f"{entry['max_memory_reserved_gib']:.2f} GiB (held between steps "
              f"{entry['memory_reserved_gib_held']:.2f} GiB); clocks {entry['clocks']}", flush=True)
        for key, reports in entry["programs"].items():
            for r in reports:
                print(f"  {key}: warm-up {r['warmup_s']:.3f} s, capture {r['capture_s']:.3f} s, "
                      f"{r['nodes']} nodes", flush=True)
        entry["profiled"] = _profiled(step, clocks, entry["step_s_median"], mode == "eager")
    _store("graph")
    if prior is not None:
        os.environ["RIFFUSION_TPU_NO_AOT"] = prior
    if clocks:
        clocks.stop()
    return result if rank == 0 else {}


def _profiled(step, clocks, step_s_median: float, parts: bool) -> dict:
    """2 steps under torch.profiler: busy time, idle share, device
    operations, launches, attention time, top kernels; with `parts`, each
    part's kernel time and each span's host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from riffusion_tpu_torch.ops import attention as attn

    attn.COUNTS.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        wall = sum(step() for _ in range(2))
        t1 = time.monotonic()
    annotations, kernels = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    attention_ms = {label: sum(t for n, (t, _) in by_name.items() if key in n)
                    for label, key in ATTENTION_KERNELS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "steps": 2,
        "wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        # the unprofiled steps' share, from the profiled busy time: an estimate
        "device_idle_share_unprofiled_estimate": 1.0 - busy_ms / 2 / (step_s_median * 1e3),
        "device_ops": len(kernels),
        "launches": {"k1": attn.COUNTS.launches, "dkv": attn.COUNTS.bwd_dkv_launches,
                     "dq": attn.COUNTS.bwd_dq_launches, "plain": attn.COUNTS.plain_calls},
        "attention_ms": attention_ms,
        "clocks": clocks.summary(t0, t1),
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
    }
    print(f"  2 profiled steps {wall:.4f} s: device busy {busy_ms:.1f} ms (idle share "
          f"{out['device_idle_share']:.4f} under the profiler; unprofiled estimate "
          f"{out['device_idle_share_unprofiled_estimate']:.4f}), {len(kernels)} device ops, "
          f"launches {out['launches']}, attention "
          f"{', '.join(f'{k} {v:.2f} ms' for k, v in attention_ms.items())}", flush=True)
    if parts:
        spans = kernel_ms_by_part(annotations, kernels)
        host_ms: dict = {}  # each span's host time (a gloo all-reduce is host time)
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name.startswith("riffusion.train."):
                host_ms[e.name] = host_ms.get(e.name, 0.0) + e.cpu_time_total / 1e3
        out.update(kernel_ms_by_part=spans, host_ms_by_span=host_ms)
        for name, ms in spans.items():
            print(f"  {name}: {ms:.2f} ms of kernel time")
        for name, ms in host_ms.items():
            print(f"  {name}: {ms:.2f} ms of host time")
    for name, (t, c) in top:
        print(f"  {t:9.2f} ms {c:6d}x {name[:100]}")
    return out


def device_events(prof) -> tuple:
    """A profile's device events: (the device ranges of the host's
    annotations, the kernels and copies that ran)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)
                   or e.name.startswith("riffusion.")]
    return annotations, [e for e in events if e not in annotations]


def kernel_ms_by_part(annotations, kernels) -> dict:
    """Each part's kernel ms in an eager step, from the profiler's device
    events: a kernel's time goes to the stage (STAGES, AdamW's annotation
    for the optimizer's) whose device range it starts in, or to BACKWARD
    where it starts in none. The backward runs on autograd's thread, whose
    launches no range of the caller's thread covers: its kernels are those
    outside every stage."""
    ranges = [(a.time_range.start, a.time_range.end,
               "riffusion.train.optimizer" if a.name.startswith(OPTIMIZER_ANNOTATION) else a.name)
              for a in annotations if a.name in STAGES or a.name.startswith(OPTIMIZER_ANNOTATION)]
    parts: dict = {}
    for k in kernels:
        part = next((name for start, end, name in ranges if start <= k.time_range.start < end),
                    BACKWARD)
        parts[part] = parts.get(part, 0.0) + k.time_range.elapsed_us() / 1e3
    return parts


if __name__ == "__main__":
    sys.exit(main())
