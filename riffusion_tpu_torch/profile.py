"""
Where the port's time goes on the card, at full SD v1 width (random:full
weights), each program captured into a CUDA graph and replayed as the
server and the trainer run it ("graph", aot.py) and eagerly ("eager",
RIFFUSION_TPU_NO_AOT=1):

    python -m riffusion_tpu_torch.profile request [--out result.json]
    python -m riffusion_tpu_torch.profile batch [--out result.json]
    python -m riffusion_tpu_torch.profile train [--out result.json] [--mesh D M S]

It prints, and writes as JSON with --out, the card's name and power limit
and, for each window it profiles, `device_summary`'s reading (busy time,
idle share, device operations, the riffusion.* spans, the top kernels and
the time of each __global__ kernel of ops.kernels.KERNELS), the window's
launch counts (every ops.kernels.COUNTS field) and its peak memory. The SM
clock, power draw, temperature and clock-event reasons are sampled every
200 ms (nvidia-smi) and summarised over each timed window.

- request: the single-clip path (`riffuse_audio`), og_beat seed, 50 PNDM
  steps: the first request (with graphs: warm-up and capture), 5 more and
  one profiled, in each mode.
- batch: the batched path (`riffuse_audio_batch`), og_beat seed: a first
  batch of 16 at the FAST preset, three more, two each of 8 and 4 FAST and
  of 16 at PNDM-50 (the first of each a capture with graphs), and one
  profiled FAST batch of 16 with K1's and K2's time apart
  (`forward_instances`: both run one __global__ body), in each mode; and K2
  alone at the batch-16 site (32, 4096, 8*40) bf16, median of 150 (CUDA
  events; about a second, which the clock sampler sees).
- train: `DiffusionTrainer` (fp32 masters, bf16 compute) at UNet batch 4 on
  64x64x4 latents with (4, 77, 768) contexts, AdamW and the EMA update as
  `run_finetune` runs them, eagerly then replayed on one trainer: the first
  step (with graphs: each program's warm-up, capture and node count), the
  median of 5 steps after 3, peak memory allocated and reserved and the
  memory held between steps, then 2 profiled steps; eagerly also each
  part's kernel time (`kernel_ms_by_part`). With --mesh, the sharded step
  (always eager) over a ("data", "model", "seq") mesh of D x M x S ranks on
  this host (nccl with a card per rank, gloo where ranks share one); rank 0
  reports. The batch is random: a step's work does not depend on values.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import typing as T
from pathlib import Path

from riffusion_tpu_torch.ops import kernels as kernel_table

REPO = Path(__file__).resolve().parent.parent

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

#: The table's __global__ kernels, as they occur in a profiler's kernel names.
_GLOBAL = re.compile(r"\b(%s)\b" % "|".join(sorted(
    {name for kernel in kernel_table.KERNELS.values() for name in kernel.kernels})))


def _smi_fields() -> str:
    """The fields to sample; the clock-event reasons' name depends on the
    nvidia-smi version."""
    for reasons in ("clocks_event_reasons.active", "clocks_throttle_reasons.active"):
        fields = f"clocks.sm,power.draw,temperature.gpu,{reasons}"
        probe = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                               capture_output=True, text=True)
        if probe.returncode == 0:
            return fields
    raise RuntimeError("nvidia-smi reads no clock-event reasons")


class ClockSampler:
    """nvidia-smi's readings every 200 ms, each stamped with the host's
    monotonic clock on arrival; `summary(t0, t1)` sums up a window."""

    def __init__(self):
        self.samples: T.List[T.Tuple[float, T.List[str]]] = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={_smi_fields()}", "--format=csv,noheader,nounits",
             "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            self.samples.append((time.monotonic(), [f.strip() for f in line.split(",")]))

    def stop(self) -> None:
        self._proc.terminate()
        self._proc.wait(timeout=10)
        self._reader.join(timeout=10)

    def summary(self, t0: float, t1: float) -> dict:
        rows = [fields for t, fields in self.samples if t0 <= t <= t1 and len(fields) == 4]
        if not rows:
            return {"samples": 0}
        out: dict = {"samples": len(rows)}
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            values = sorted(float(r[i]) for r in rows)
            out[key] = [values[0], statistics.median(values), values[-1]]
        out["clock_event_reasons"] = sorted({r[3] for r in rows})
        return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _modes(*modes: str) -> T.Iterator[str]:
    """Each of `modes` in turn, the programs run in it meanwhile ("graph":
    the store's captures and replays; "eager": RIFFUSION_TPU_NO_AOT=1);
    "graph" again after the last."""
    for mode in modes:
        if mode == "eager":
            os.environ["RIFFUSION_TPU_NO_AOT"] = "1"
        else:
            os.environ.pop("RIFFUSION_TPU_NO_AOT", None)
        yield mode
    os.environ.pop("RIFFUSION_TPU_NO_AOT", None)


def _wall(fn: T.Callable[[], T.Any]) -> float:
    """fn()'s seconds on the host clock, from an idle card to the end of
    its work there."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return time.monotonic() - t0


def device_events(prof) -> tuple:
    """A profile's device events: (the device ranges of the host's
    annotations, the kernels and copies that ran)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)
                   or e.name.startswith("riffusion.")]
    return annotations, [e for e in events if e not in annotations]


def device_summary(prof, wall_s: float) -> dict:
    """A profiled window of `wall_s` seconds on the device: busy time
    (kernels and copies), idle share (None where the trace shows no device
    work), operations, the riffusion.* spans' host and device time, the
    top 15 kernels, and the device time and launches of each __global__
    kernel of the table."""
    from torch.autograd import DeviceType

    stages: dict = {}
    for e in prof.events():
        if e.name.startswith("riffusion."):
            entry = stages.setdefault(e.name, {})
            side = "device_span_ms" if e.device_type == DeviceType.CUDA else "host_span_ms"
            entry[side] = entry.get(side, 0.0) + e.time_range.elapsed_us() / 1e3
    _, launched = device_events(prof)
    by_name: dict = {}
    for e in launched:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    by_global: dict = {}
    for name, (ms, count) in by_name.items():
        found = _GLOBAL.search(name)
        if found:
            total = by_global.setdefault(found.group(1), {"ms": 0.0, "count": 0})
            total["ms"] += ms
            total["count"] += count
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3) if launched else None,
        "device_ops": len(launched),
        "stages": stages,
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
        "kernel_ms": dict(sorted(by_global.items())),
    }


def _profiled(label: str, run: T.Callable[[], float], clocks: ClockSampler) -> tuple:
    """(`run`, which returns its wall seconds, under torch.profiler: the
    device summary, the launch counts, the clocks and the peak memory,
    printed under `label`; the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = kernel_table.COUNTS.snapshot()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        wall = run()
        t1 = time.monotonic()
    out = device_summary(prof, wall)
    out.update(launches=kernel_table.COUNTS.since(before),
               clocks=clocks.summary(t0, t1),
               max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"{label}: {wall:.4f} s: device busy {out['device_busy_ms']:.1f} ms (idle share "
          f"{out['device_idle_share']}), {out['device_ops']} device ops, launches "
          f"{out['launches']}, peak {out['max_memory_allocated_gib']:.2f} GiB", flush=True)
    for name, spans in out["stages"].items():
        print(f"  {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
    for name, total in out["kernel_ms"].items():
        print(f"  {name}: {total['ms']:.2f} ms over {total['count']} launches")
    for k in out["top_kernels"]:
        print(f"  {k['ms']:9.2f} ms {k['count']:6d}x {k['name'][:100]}", flush=True)
    return out, prof


def _serving():
    """The pipeline at full width on the card, the og_beat seed and the
    spectrogram parameters of the requests."""
    from PIL import Image

    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    image = Image.open(REPO / "seed_images" / "og_beat.png").convert("RGB")
    return pipe, image, SpectrogramParams(min_frequency=0, max_frequency=10000,
                                          num_frequencies=512)


def _inputs(i: int, steps: int):
    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput

    return InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42 + i),
                          end=PromptInput(prompt="jazzy saxophone", seed=123 + i),
                          alpha=0.5, num_inference_steps=steps)


def _request(clocks: ClockSampler) -> dict:
    pipe, image, params = _serving()

    def request(i: int) -> float:
        return _wall(lambda: pipe.riffuse_audio(_inputs(i, 50), image, params=params))

    result: dict = {"checkpoint": "random:full"}
    for mode in _modes("graph", "eager"):
        first_s = request(0)
        walls = [request(1 + i) for i in range(5)]
        print(f"{mode}: first request {first_s:.3f} s; requests {[round(w, 4) for w in walls]} "
              f"s, median {statistics.median(walls):.4f} s", flush=True)
        result[mode], _ = _profiled(f"{mode}: profiled request", lambda: request(99), clocks)
        result[mode].update(first_request_s=first_s, request_s=walls,
                            request_s_median=statistics.median(walls))
    return result


def forward_instances() -> T.Dict[str, T.Set[str]]:
    """{"k1": K1's instance names, "k2": K2's}: the table's kernels that one
    profiled bf16 call of each wrapper (batch 1) at its batch-16 site's
    sequence and head width launches; raises if the two share a name,
    which would make their times one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from riffusion_tpu_torch.ops import attention

    names = {}
    for label, (wrapper, s, h, d) in (("k1", ("attention", 1024, 8, 80)),
                                      ("k2", ("row_attention", 4096, 8, 40))):
        q, k, v = (torch.randn(1, s, h * d, device="cuda").to(torch.bfloat16) for _ in range(3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            getattr(attention, wrapper)(q, k, v, num_heads=h, scale=d**-0.5)
            torch.cuda.synchronize()
        own = kernel_table.KERNELS[wrapper].kernels
        names[label] = {e.name for e in device_events(prof)[1]
                        if (found := _GLOBAL.search(e.name)) and found.group(1) in own}
    if not names["k1"] or not names["k2"] or names["k1"] & names["k2"]:
        raise RuntimeError(f"K1's and K2's forward instances cannot be told apart: {names}")
    return names


def _batch(clocks: ClockSampler) -> dict:
    import torch

    from riffusion_tpu_torch.ops import attention
    from riffusion_tpu_torch.serving import FAST_PRESET

    pipe, image, params = _serving()
    result: dict = {"checkpoint": "random:full", "batches": []}

    def batch(n: int, scheduler: str, steps: int, what: str, mode: str) -> float:
        inputs = [_inputs(i, steps) for i in range(n)]
        wall = _wall(lambda: pipe.riffuse_audio_batch(inputs, image, params=params,
                                                      scheduler=scheduler))
        t1 = time.monotonic()
        entry = {"what": what, "mode": mode, "n": n, "scheduler": scheduler, "steps": steps,
                 "wall_s": wall, "clips_per_s": n / wall, "clocks": clocks.summary(t1 - wall, t1)}
        result["batches"].append(entry)
        print(f"{mode}: {what}: {n} clips in {wall:.4f} s ({n / wall:.4f} clips/s); "
              f"clocks {entry['clocks']}", flush=True)
        return wall

    instances = forward_instances()
    result.update(forward_instances={k: sorted(v) for k, v in instances.items()}, profiled={})
    fast = (FAST_PRESET["scheduler"], FAST_PRESET["steps"])
    for mode in _modes("graph", "eager"):
        batch(16, *fast, "first, 16 FAST", mode)
        for i in range(3):
            batch(16, *fast, f"16 FAST #{i + 1}", mode)
        for n, scheduler, steps, what in ((8, *fast, "8 FAST"), (4, *fast, "4 FAST"),
                                          (16, "pndm", 50, "16 PNDM-50")):
            batch(n, scheduler, steps, f"first, {what}", mode)
            batch(n, scheduler, steps, what, mode)
        out, prof = _profiled(f"{mode}: profiled batch of 16 FAST",
                              lambda: batch(16, *fast, "16 FAST, profiled", mode), clocks)
        out.update({f"{label}_ms": sum(e.time_range.elapsed_us() for e in device_events(prof)[1]
                                       if e.name in names) / 1e3
                    for label, names in instances.items()})
        result["profiled"][mode] = out
        print(f"  K1 {out['k1_ms']:.2f} ms, K2 {out['k2_ms']:.2f} ms", flush=True)

    b, s, h, d = 32, 4096, 8, 40  # K2 alone at the batch-16 site
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    for _ in range(3):
        attention.row_attention(q, k, v, num_heads=h, scale=d**-0.5)
    times = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(150):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        attention.row_attention(q, k, v, num_heads=h, scale=d**-0.5)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result["k2_alone"] = {"ms": statistics.median(times),
                          "clocks": clocks.summary(t0, time.monotonic())}
    print(f"K2 alone at (32, 4096, 8*40) bf16: {result['k2_alone']}", flush=True)
    return result


def _train(clocks: T.Optional[ClockSampler], rank: int, world: int, mesh_shape) -> dict:
    """The train profile on this rank (every rank of a mesh steps; rank 0
    alone profiles and prints)."""
    import functools

    import torch

    from riffusion_tpu_torch import aot
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.mesh import make_mesh
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.training.finetune import ema_update

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
    result: dict = {"batch": 4, "latents": [64, 64, 4], "mesh": mesh_shape, "ranks": world,
                    "modes": {}}
    # eager first, so that its peak holds no graph pool
    for mode in _modes(*("eager", "graph") if mesh is None else ("eager",)):
        ema_step = trainer.program("ema_update",
                                   functools.partial(ema_update, ema, params, 0.999))

        def step() -> float:  # the EMA inside its stage, riffusion.train.ema
            return _wall(lambda: (trainer.step(latents, context, generator=gen), ema_step()))

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
        entry["profiled"], prof = _profiled(f"{mode}: 2 profiled steps",
                                            lambda: sum(step() for _ in range(2)), clocks)
        if mode == "eager":
            parts = entry["profiled"]["kernel_ms_by_part"] = kernel_ms_by_part(*device_events(prof))
            for name, ms in parts.items():
                print(f"  {name}: {ms:.2f} ms of kernel time")
    return result


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


def _profile(rank: int, world: int, mode: str, mesh_shape) -> dict:
    """`mode`'s profile on this rank of `world`; rank 0 alone samples the
    clocks and returns the result."""
    card, clocks = _card(), None
    if rank == 0:
        print(card, flush=True)
        clocks = ClockSampler()
    try:
        if mode == "train":
            result = _train(clocks, rank, world, mesh_shape)
        else:
            result = {"request": _request, "batch": _batch}[mode](clocks)
    finally:
        if clocks:
            clocks.stop()
    return dict(result, card=card) if rank == 0 else {}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("request", "batch", "train"))
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    parser.add_argument("--mesh", type=int, nargs=3, default=None, metavar=("D", "M", "S"),
                        help="train: profile the sharded step over a (data, model, seq) mesh")
    args = parser.parse_args(argv)
    if args.mesh is not None and args.mode != "train":
        parser.error("--mesh profiles the train mode only")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile: torch sees no CUDA device")
    if args.mesh is None:
        result = _profile(0, 1, args.mode, None)
    else:
        from riffusion_tpu_torch.parallel.mesh import backend_for, spawn_world

        world = args.mesh[0] * args.mesh[1] * args.mesh[2]
        result = spawn_world(_profile, world, (args.mode, tuple(args.mesh)),
                             backend=backend_for("cuda", world))[0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
