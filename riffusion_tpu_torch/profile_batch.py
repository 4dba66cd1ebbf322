"""
Where a batch of requests' time goes on the card: the batched serving path
(`RiffusionPipeline.riffuse_audio_batch`, what the DynamicBatcher launches)
at full SD v1 width (random weights), og_beat seed, strength 0.75, run as
the server runs it (each batch's program captured into a CUDA graph on its
first call and replayed, riffusion_tpu_torch/aot.py) and eagerly
(RIFFUSION_TPU_NO_AOT=1).

    python -m riffusion_tpu_torch.profile_batch [--out result.json]

Prints, and writes as JSON with --out:
- the card's name and power limit;
- in each mode, the wall time of batches (host clock, ending in
  torch.cuda.synchronize): a first batch of 16 at the FAST preset
  (unipc_k:rho=2, 16 steps; with graphs, the warm-up and the capture),
  three more, and two each of 8 and 4 and of 16 at PNDM-50 (the first of
  each a capture with graphs);
- K2 (ops.attention.row_attention) alone at the batch-16 site
  (32, 4096, 8*40) bf16, CUDA events, median of 150 (about a second, so
  that the clock sampler sees it), in the same process;
- for one further FAST batch of 16 under torch.profiler in each mode: the
  device's busy time (the sum of kernel and copy times; one stream)
  against the batch's wall time, K1's and K2's device time (their
  instances of the forward body, `forward_instances`), and the 15 kernels
  with the most device time; eagerly also each pipeline stage's span on
  the host and on the device (the riffusion.* spans), which a replayed
  graph, one launch to the profiler, does not show;
- the card's SM clock, power draw, temperature and active clock-event
  reasons, sampled by nvidia-smi every 200 ms, summarised over each of the
  above (min, median, max), so that a kernel's time inside the batch and
  alone can be compared at the clocks each ran at.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import typing as T
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# The bf16 forward body both forward kernels run (csrc/attention_fwd.cuh):
# K1's and K2's instances of it are told apart by the names that one
# profiled call of each wrapper, at its batch-16 site's head width, gives.
FORWARD_KERNEL = "attention_fwd_bf16_kernel"
FORWARD_SITES = {"k1": ("attention", 1024, 8, 80), "k2": ("row_attention", 4096, 8, 40)}


def forward_instances(torch, attn) -> T.Dict[str, T.Set[str]]:
    """{"k1": K1's instance names, "k2": K2's}, from one profiled call of
    each wrapper (batch 1) at its batch-16 site's sequence and head width;
    raises if the two share a name, which would make their times one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {}
    for label, (wrapper, s, h, d) in FORWARD_SITES.items():
        q, k, v = (torch.randn(1, s, h * d, device="cuda").to(torch.bfloat16) for _ in range(3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            getattr(attn, wrapper)(q, k, v, num_heads=h, scale=d**-0.5)
            torch.cuda.synchronize()
        names[label] = {e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA and FORWARD_KERNEL in e.name}
    if not names["k1"] or not names["k2"] or names["k1"] & names["k2"]:
        raise RuntimeError(f"K1's and K2's forward instances cannot be told apart: {names}")
    return names


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


#: "graph": the programs through the store (the server's way); "eager":
#: RIFFUSION_TPU_NO_AOT=1
MODES = ("graph", "eager")


def _store(mode: str) -> None:
    """Run the programs that follow in `mode`."""
    if mode == "eager":
        os.environ["RIFFUSION_TPU_NO_AOT"] = "1"
    else:
        os.environ.pop("RIFFUSION_TPU_NO_AOT", None)


def _trace(prof, wall_s: float, cuda, instances: T.Dict[str, T.Set[str]]) -> dict:
    """A profiled batch's device side: busy time (kernels and copies), idle
    share of `wall_s` (None where the trace shows no device work), device
    operations, K1's and K2's time, the riffusion.* stage spans and the top
    kernels."""
    events = prof.events()
    stages: dict = {}
    for e in events:
        if not e.name.startswith("riffusion."):
            continue
        entry = stages.setdefault(e.name, {})
        side = "device_span_ms" if e.device_type == cuda else "host_span_ms"
        entry[side] = entry.get(side, 0.0) + e.time_range.elapsed_us() / 1e3
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("riffusion.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3) if kernels else None,
        "device_ops": len(kernels),
        "k1_ms": sum(by_name.get(n, (0.0, 0))[0] for n in instances["k1"]),
        "k2_ms": sum(by_name.get(n, (0.0, 0))[0] for n in instances["k2"]),
        "forward_instances": {k: sorted(v) for k, v in instances.items()},
        "stages": stages,
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    args = parser.parse_args(argv)

    import torch
    from PIL import Image
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import FAST_PRESET
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    if not torch.cuda.is_available():
        raise SystemExit("profile_batch: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    clocks = ClockSampler()

    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    image = Image.open(REPO / "seed_images" / "og_beat.png").convert("RGB")
    params = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=512)
    result: dict = {"card": card, "checkpoint": "random:full", "batches": []}

    def batch(n: int, scheduler: str, steps: int, what: str, mode: str) -> float:
        inputs = [InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42 + i),
                                 end=PromptInput(prompt="jazzy saxophone", seed=123 + i),
                                 alpha=0.5, num_inference_steps=steps) for i in range(n)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pipe.riffuse_audio_batch(inputs, image, params=params, scheduler=scheduler)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        entry = {"what": what, "mode": mode, "n": n, "scheduler": scheduler, "steps": steps,
                 "wall_s": t1 - t0, "clips_per_s": n / (t1 - t0),
                 "clocks": clocks.summary(t0, t1)}
        result["batches"].append(entry)
        print(f"{mode}: {what}: {n} clips in {t1 - t0:.4f} s ({n / (t1 - t0):.4f} clips/s); "
              f"clocks {entry['clocks']}", flush=True)
        return t1 - t0

    fast = (FAST_PRESET["scheduler"], FAST_PRESET["steps"])
    for mode in MODES:
        _store(mode)
        batch(16, *fast, "first, 16 FAST", mode)
        for i in range(3):
            batch(16, *fast, f"16 FAST #{i + 1}", mode)
        for n, scheduler, steps, what in ((8, *fast, "8 FAST"), (4, *fast, "4 FAST"),
                                          (16, "pndm", 50, "16 PNDM-50")):
            batch(n, scheduler, steps, f"first, {what}", mode)
            batch(n, scheduler, steps, what, mode)
    _store("graph")

    # K2 alone at the batch-16 site
    b, s, h, d = 32, 4096, 8, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    for _ in range(3):
        attn.row_attention(q, k, v, num_heads=h, scale=d**-0.5)
    times = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(150):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        attn.row_attention(q, k, v, num_heads=h, scale=d**-0.5)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    result["k2_alone"] = {"ms": statistics.median(times),
                          "clocks": clocks.summary(t0, time.monotonic())}
    print(f"K2 alone at (32, 4096, 8*40) bf16: {result['k2_alone']}", flush=True)
    del q, k, v

    instances = forward_instances(torch, attn)
    result["profiled"] = {}
    for mode in MODES:
        _store(mode)
        attn.COUNTS.reset()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            profiled_s = batch(16, *fast, "16 FAST, profiled", mode)
            t1 = time.monotonic()
        result["profiled"][mode] = p = _trace(prof, profiled_s, DeviceType.CUDA, instances)
        p.update(k1_launches=attn.COUNTS.launches, k2_launches=attn.COUNTS.row_launches,
                 plain_calls=attn.COUNTS.plain_calls,
                 max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                 clocks=clocks.summary(t0, t1))
        print(f"{mode}: profiled batch {profiled_s:.4f} s: device busy {p['device_busy_ms']:.1f} "
              f"ms (idle share {p['device_idle_share']}), {p['device_ops']} device ops, "
              f"K1/K2/plain {p['k1_launches']}/{p['k2_launches']}/{p['plain_calls']} launches, "
              f"K1 {p['k1_ms']:.2f} ms, K2 {p['k2_ms']:.2f} ms, peak "
              f"{p['max_memory_allocated_gib']:.2f} GiB")
        for name, spans in p["stages"].items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
        for k in p["top_kernels"]:
            print(f"  {k['ms']:9.2f} ms {k['count']:6d}x {k['name'][:100]}")
    _store("graph")
    clocks.stop()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
