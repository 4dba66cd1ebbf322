#!/usr/bin/env python3
"""
One run of one cell of the benchmark, as run.py makes it, with the
program's own spans and stage times (riffusion_tpu_torch/tracing.py) read
into the result:

    python3 bench_port/traced.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`main` is run.py's, built from the same pieces, with three additions
(marked there):
- `--trace 1` sets RIFFUSION_TPU_TRACE=1 before the driver runs; with
  `--trace 0` the caller's environment decides;
- where the program's tracing is on, after the driver returns,
  tracing.export() goes into the record's counters["tracing"] and the
  program's spans are appended to the record's spans as (name, start_us,
  duration_us), so that the breakdown's idle_gaps names each gap by the
  innermost span, a program span wherever the program was running;
- with `--trace 1`, the per-layer metrics of TRACED_METRICS
  (metrics/host_ms.py, metrics/device_ms.py) are read as BENCHMARK.json's
  are.
The `benchmark` change that makes these metrics the benchmark's puts the
three additions into run.py, adds TRACED_METRICS to BENCHMARK.json's
per_layer, and deletes this file.

Where the program's tracing is on, standard error holds, before the
compared numbers that end it, `tracing summary {...}`: each program
span's mean ms per request or step and each stage's device ms per replay,
over the window before the trace; the share of its replays whose stage
times were read; in a --trace 1 run, the traced window's idle seconds by
the label idle_gaps gives each gap; and the cross-checks of the new
metrics against the benchmark's own.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import typing as T
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location("bench_port_run", ROOT / "run.py")
run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run)  # type: ignore[union-attr]  # sets the process's start

from bench_port import harness  # noqa: E402
from bench_port.metrics import _program  # noqa: E402


def _metric(name: str, unit: str, source: str, layer: str, moves: str, cell: str) -> dict:
    return {"name": name, "unit": unit, "better": "lower", "source": source, "layer": layer,
            "moves": moves, "workloads": [cell]}


PLAYER, STEP4 = "riffusion-v1.player", "riffusion-v1-finetune.step4"

#: The per-layer metrics that read the program's spans and stage times.
TRACED_METRICS = [
    _metric("host_ms.front", "ms", "host_clock", "HTTP front (server.py)", "clip_latency_ms",
            PLAYER),
    _metric("host_ms.call", "ms", "host_clock",
            "Pipeline host part (riffusion_pipeline.py, aot.py)", "clip_latency_ms", PLAYER),
    _metric("device_ms.denoise", "ms", "program_counter", "UNet (models/unet.py, K1)",
            "clip_latency_ms", PLAYER),
    _metric("device_ms.vae", "ms", "program_counter", "VAE (models/vae.py, fp32)",
            "clip_latency_ms", PLAYER),
    _metric("device_ms.dsp", "ms", "program_counter", "DSP (spectrogram_converter.py, ops/)",
            "clip_latency_ms", PLAYER),
    _metric("host_ms.step", "ms", "host_clock", "Trainer host part (parallel/train.py)",
            "train_step_ms", STEP4),
    _metric("device_ms.unet", "ms", "program_counter",
            "UNet (models/unet.py, K1 and its backward)", "train_step_ms", STEP4),
    _metric("device_ms.optimizer", "ms", "program_counter",
            "Optimizer (AdamW, the masters' copies)", "train_step_ms", STEP4),
    _metric("device_ms.ema", "ms", "program_counter", "EMA (training/finetune.py)",
            "train_step_ms", STEP4),
]


def export(record: harness.Record) -> None:
    """Where the program's tracing is on: its export into the record's
    counters["tracing"], its spans appended to the record's spans."""
    try:
        from riffusion_tpu_torch import tracing
    except ImportError:  # a program without tracing of its own: nothing to read
        return
    if not tracing.enabled():
        return
    exported = tracing.export()
    record.counters["tracing"] = exported
    record.spans.extend((s["name"], s["start_ns"] / 1e3, s["dur_ns"] / 1e3)
                        for s in exported["spans"])


def idle_by_label(trace: harness.Trace, spans) -> T.Dict[str, float]:
    """The traced window's idle seconds, summed over every gap by the label
    that harness.Trace.idle_gaps gives it."""
    out: T.Dict[str, float] = {}
    for label, seconds in trace.idle_gaps(spans, n=len(trace.ops)):
        out[label] = out.get(label, 0.0) + seconds
    return out


def _mean(values) -> T.Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


def summary(record, metrics: T.Dict[str, float]) -> T.Dict[str, T.Any]:
    """The program's spans and stages over the window before the trace, the
    replays' read share, the idle time by label, the cross-checks."""
    traced = _program.exported(record)
    if traced is None:
        return {}
    spans = _program.spans_in(record, {s["name"] for s in traced["spans"]})
    ids = {s["id"] for s in spans if s["name"] in ("riffusion.request", "riffusion.train.step")}
    n = len(ids)
    total: T.Dict[str, float] = {}
    alone: T.Dict[str, T.List[float]] = {}  # spans of other ids: the EMA's, a batch's
    for s in spans:
        if s["id"] in ids:
            total[s["name"]] = total.get(s["name"], 0.0) + s["dur_ns"] / 1e6
        else:
            alone.setdefault(s["name"], []).append(s["dur_ns"] / 1e6)
    per = {name: ms / n for name, ms in sorted(total.items())} if n else {}
    replays = _program.replays_in(record)
    stages: T.Dict[str, T.List[float]] = {}
    for r in replays:
        for name, ms in (r["stages"] or {}).items():
            stages.setdefault(name, []).append(ms)
    keys = sorted({r["key"] for r in replays})
    out: T.Dict[str, T.Any] = {
        "counters": traced["counters"],
        "requests_or_steps": n,
        "span_ms_per_request_or_step": per,
        "other_span_ms_mean": {name: statistics.fmean(v) for name, v in sorted(alone.items())},
        "stage_ms_per_replay": {name: statistics.fmean(v) for name, v in sorted(stages.items())},
        "replays_read_share": {k: _mean(r["stages"] is not None for r in replays
                                        if r["key"] == k) for k in keys},
    }
    if record.device_trace is not None:
        out["idle_s_by_label"] = idle_by_label(record.device_trace, record.spans)
        out["traced_window_s"] = record.device_trace.window_s
    checks: T.Dict[str, T.Any] = {}
    if "device_ms.denoise" in metrics and n:
        device = sum(metrics.get(f"device_ms.{p}", 0.0) for p in ("denoise", "vae", "dsp"))
        waited = per.get("riffusion.readback", 0.0) + per.get("riffusion.launch", 0.0)
        checks["device_stages_over_launch_and_readback"] = device / waited
        server = _mean(r.server_s * 1e3 for r in record.untraced()[1]
                       if r.server_s == r.server_s)
        if server is not None:
            checks["call_ms_less_server_ms"] = per.get("riffusion.call", 0.0) - server
        front = harness.reader("front_ms").read(record, "front_ms.player")
        if front is not None and "host_ms.front" in metrics:
            checks["host_ms.front_less_front_ms"] = metrics["host_ms.front"] - front
    if "device_ms.unet" in metrics and record.device_trace is not None and record.steps:
        device = sum(metrics.get(f"device_ms.{p}", 0.0) for p in ("unet", "optimizer", "ema"))
        step_ms = harness.reader("train_step_ms").read(record, "train_step_ms")
        busy = record.device_trace.busy_s / record.device_trace.window_s
        checks["device_stages_over_busy_step"] = device / (step_ms * busy)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = run.parse_args(argv)
    if args.trace:  # addition: the program's tracing on in a traced run
        os.environ["RIFFUSION_TPU_TRACE"] = "1"
    harness.cache_dirs(run.REPO)
    bench = harness.manifest(run.REPO)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])

    import torch

    if not torch.cuda.is_available():
        return run.fail("torch sees no CUDA card; the benchmark runs only on one")
    if torch.cuda.device_count() < cell["chips"]:
        return run.fail(f"{args.workload} needs {cell['chips']} cards, torch sees "
                        f"{torch.cuda.device_count()}")

    record = harness.Record(cell=cell, config=cfg, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), started=run.STARTED)
    driver = harness.traffic(cell["kind"])
    clocks = harness.ClockSampler()
    try:
        driver.run(record)
    finally:
        clocks.stop()
    export(record)  # addition: the program's export and spans into the record

    found = harness.forbidden_modules()
    if found:
        return run.fail(f"modules of JAX or of the JAX package were loaded: {found}")

    section = "per_layer" if args.trace else "end_to_end"
    # addition: the traced metrics beside the benchmark's per-layer ones
    entries = bench[section] + (TRACED_METRICS if args.trace else [])
    metrics = {}
    for entry in entries:
        if not harness.applies(entry, args.workload):
            continue
        value = harness.reader(entry["name"]).read(record, entry["name"])
        if value is None:
            if section == "end_to_end":
                return run.fail(f"the run measured no {entry['name']}")
            continue
        metrics[entry["name"]] = (value, entry["unit"])

    device = dict(platform="gpu", count=cell["chips"], memory_peak_bytes=record.memory_peak_bytes,
                  **harness.card())
    breakdown = None
    if record.device_trace is not None:
        trace = record.device_trace
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps(record.spans)}
    record.notes["clocks"] = clocks.summary(*record.window)
    print("record " + json.dumps(record.notes, default=str), flush=True)
    if "tracing" in record.counters:  # addition: the summary of the program's tracing
        values = {name: value for name, (value, _) in metrics.items()}
        print("tracing summary " + json.dumps(summary(record, values)), file=sys.stderr)
    print(f"failed: {record.failed} of {record.attempted} attempted", file=sys.stderr)
    for error in record.notes.get("requests", {}).get("errors", []):
        print(f"a failed request: {error}", file=sys.stderr)
    for check in record.checks:
        print(f"compared {check.name}: {check.value} (limit {check.limit})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(record, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
