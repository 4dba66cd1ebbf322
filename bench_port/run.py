#!/usr/bin/env python3
"""
One run of one cell of riffusion_tpu_torch's benchmark on this machine's
cards:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (workloads/<cell>.json) names its configuration and its traffic;
the traffic's driver (traffic/<kind>.py) sets the system up from the seed,
warms up every shape the window uses, measures for `--seconds`, then
checks what the window produced against the plain reference. With
`--trace 0` the result holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (metrics/<family>.py each), read from a
run that traces the window's first seconds on the device.

The last line of standard output is the result: `correct`, `attempted`,
`failed`, `metrics`, `device`, with --trace 1 a `breakdown`, and last the
numbers compared with their limits, which also end standard error. Without
a CUDA card, with fewer cards than the cell asks for, or with a JAX module
loaded once the window has closed, it prints no result and exits 1.
"""

from __future__ import annotations

import time

STARTED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from bench_port import harness  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def fail(message: str) -> int:
    print(f"bench_port: {message}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = parse_args(argv)
    harness.cache_dirs(REPO)
    bench = harness.manifest(REPO)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])

    import torch

    if not torch.cuda.is_available():
        return fail("torch sees no CUDA card; the benchmark runs only on one")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} cards, torch sees "
                    f"{torch.cuda.device_count()}")

    record = harness.Record(cell=cell, config=cfg, seed=args.seed, seconds=args.seconds,
                            trace=bool(args.trace), started=STARTED)
    driver = harness.traffic(cell["kind"])
    clocks = harness.ClockSampler()
    try:
        driver.run(record)
    finally:
        clocks.stop()

    found = harness.forbidden_modules()
    if found:
        return fail(f"modules of JAX or of the JAX package were loaded: {found}")

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for entry in bench[section]:
        if not harness.applies(entry, args.workload):
            continue
        value = harness.reader(entry["name"]).read(record, entry["name"])
        if value is None:
            if section == "end_to_end":
                return fail(f"the run measured no {entry['name']}")
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
