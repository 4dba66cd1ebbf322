"""
The benchmark's general parts: finding a cell, its configuration, its
traffic driver and its metric readers by name; the run record that the
drivers fill and the readers read; the device trace of the measured window
and its reduction; the card's clock and power beside the window; the check
that no JAX module was loaded; and the result line.

Everything that belongs to one configuration, one cell or one metric lives
in a file of its own that is found by the name BENCHMARK.json gives:

    configs/<config>.json     a configuration (widths, precision, source)
    workloads/<cell>.json     a cell: its configuration, traffic, chips, why,
                              the traffic's parameters and the check's limits
    traffic/<kind>.py         the driver of a traffic kind (`run(record)`)
    metrics/<family>.py       the reader of a metric, or of a family of them
                              ("mfu" reads mfu.player and mfu.train):
                              `read(record, name)`, None
                              where it finds nothing to read
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import types
import typing as T
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

#: Module names that no run may hold (compared by the part before the
#: first dot): JAX and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "riffusion_tpu")

#: Seconds of the measured window that a --trace 1 run traces, at the
#: window's end: a replayed request issues some 70,000 device operations,
#: and the trace has to be read within the run's time. Reading it costs
#: the host seconds, after the window; the host-clock per-layer metrics
#: read the untraced part before the trace.
TRACE_SECONDS = 5.0


def load_json(path: Path) -> T.Any:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def manifest(repo: Path = REPO) -> T.Dict[str, T.Any]:
    return load_json(repo / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> T.Dict[str, T.Any]:
    path = root / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no cell {name!r}: {path} does not exist")
    return dict(load_json(path), name=name)


def config(name: str, root: Path = ROOT) -> T.Dict[str, T.Any]:
    return load_json(root / "configs" / f"{name}.json")


def _module(path: Path, name: str) -> types.ModuleType:
    if not path.is_file():
        raise SystemExit(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    return module


def traffic(kind: str, root: Path = ROOT) -> types.ModuleType:
    return _module(root / "traffic" / f"{kind}.py", f"bench_port_traffic_{kind}")


def reader(metric: str, root: Path = ROOT) -> types.ModuleType:
    family = metric.split(".", 1)[0]
    return _module(root / "metrics" / f"{family}.py", f"bench_port_metric_{family}")


def applies(entry: T.Mapping[str, T.Any], cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


# ------------------------------------------------------------ the run record


@dataclasses.dataclass
class Request:
    """One request a client sent: host clock of send and of the whole
    response read, whether it succeeded, and the program's wall for it."""

    key: T.Tuple
    sent: float
    done: float = 0.0
    ok: bool = False
    error: str = ""
    server_s: float = float("nan")

    @property
    def wall_s(self) -> float:
        return self.done - self.sent


@dataclasses.dataclass
class Check:
    """One number compared: its reading and its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: T.Dict[str, T.Any]
    config: T.Dict[str, T.Any]
    seed: int
    seconds: float
    trace: bool
    started: float  # host clock at the process's start
    device: str = "cuda"
    setup_s: float = float("nan")
    window: T.Tuple[float, float] = (float("nan"), float("nan"))
    requests: T.List[Request] = dataclasses.field(default_factory=list)
    steps: T.List[float] = dataclasses.field(default_factory=list)  # host clock, each step issued
    data_s: T.List[T.Tuple[float, float]] = dataclasses.field(default_factory=list)  # (start, s)
    counters: T.Dict[str, T.Any] = dataclasses.field(default_factory=dict)
    spans: T.List[T.Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    device_trace: T.Optional["Trace"] = None
    checks: T.List[Check] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    notes: T.Dict[str, T.Any] = dataclasses.field(default_factory=dict)
    traced_from: float = float("inf")  # host clock at the trace's start

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self) -> T.List[Request]:
        """Requests that completed, read whole, inside the window."""
        t0, t1 = self.window
        return [r for r in self.requests if r.ok and t0 <= r.done <= t1]

    def untraced(self) -> T.Tuple[float, T.List[Request]]:
        """The window's part before its trace, where a traced run's host
        clock reads what an untraced one would: (its seconds, the requests
        completed in it)."""
        t1 = min(self.window[1], self.traced_from)
        return t1 - self.window[0], [r for r in self.in_window() if r.done <= t1]


# ------------------------------------------------------------ device trace


@dataclasses.dataclass
class Trace:
    """The device side of a traced window: each kernel, copy and set as
    (name, start_us, duration_us) on the wall clock, the traced window's
    length, and the seconds in which any device operation ran."""

    ops: T.List[T.Tuple[str, float, float]]
    window_s: float
    busy_s: float

    def top_ops(self, n: int = 10) -> T.List[T.List[T.Any]]:
        by_name: T.Dict[str, float] = {}
        for name, _, dur in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], total / 1e6] for name, total in top]

    def idle_gaps(self, spans: T.Sequence[T.Tuple[str, float, float]], n: int = 10
                  ) -> T.List[T.List[T.Any]]:
        """The longest stretches with no device operation, each named by
        the innermost of the benchmark's host `spans` (name, start_us,
        duration_us) at the gap's middle."""
        gaps = []
        end = None
        for _, start, dur in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and start > end:
                gaps.append((start - end, end, start))
            end = start + dur if end is None else max(end, start + dur)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [s for s in spans if s[1] <= mid <= s[1] + s[2]]
            label = min(inside, key=lambda s: s[2])[0] if inside else "outside every span"
            out.append([label, length / 1e6])
        return out


def _union_seconds(intervals: T.List[T.Tuple[float, float]]) -> float:
    total, end = 0.0, None
    start_run = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start_run
            start_run, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start_run
    return total / 1e6


def _annotation(event) -> bool:
    """A device-side copy of a host span (the program's record_function
    ranges), not an operation that ran."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else event.name().startswith("riffusion.")


def _mark(name: str) -> None:
    """An instant on the profiler's clock, from this thread."""
    from torch.profiler import record_function

    with record_function(name):
        pass


class WindowTrace:
    """torch.profiler over the last TRACE_SECONDS of a measured window that
    ends at `end` (all of it, where it is shorter): `poll()` from the
    window's loop starts it on time, `finish()` after the window ends and
    reads it."""

    def __init__(self, enabled: bool, end: float):
        self.enabled = enabled
        self.start_at = end - TRACE_SECONDS
        self.prof = None
        self.t0 = float("inf")
        self.result: T.Optional[Trace] = None

    def poll(self) -> None:
        if not self.enabled or self.prof is not None or time.monotonic() < self.start_at:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.monotonic()
        _mark("bench.trace_start")

    def finish(self) -> None:
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        _mark("bench.trace_end")
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        ops = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3) for e in events
               if e.device_type() == DeviceType.CUDA and not _annotation(e)]
        # keep what ran inside the traced window, between the two marks on
        # the profiler's own clock (work queued before it may run into it)
        marks = {e.name(): e.start_ns() / 1e3 for e in events
                 if e.name() in ("bench.trace_start", "bench.trace_end")}
        lo, hi = marks["bench.trace_start"], marks["bench.trace_end"]
        ops = [(n, max(s, lo), min(s + d, hi) - max(s, lo)) for n, s, d in ops
               if s + d > lo and s < hi]
        busy = _union_seconds([(s, s + d) for _, s, d in ops])
        self.result = Trace(ops=ops, window_s=(hi - lo) / 1e6, busy_s=busy)


def sync(device: str) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


@contextlib.contextmanager
def span(spans: T.List[T.Tuple[str, float, float]], name: str) -> T.Iterator[None]:
    """A benchmark span on the host: (name, start_us, duration_us) on the
    wall clock, the profiler's, appended to `spans` from any thread."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        spans.append((name, t0 / 1e3, (time.time_ns() - t0) / 1e3))


# ------------------------------------------------------------ clocks, power


class ClockSampler:
    """nvidia-smi's SM clock and power draw every 200 ms (the arithmetic of
    riffusion_tpu_torch/profile_batch.py's sampler, kept here);
    `summary(t0, t1)` gives each one's min, median and max in the window."""

    FIELDS = "clocks.sm,power.draw,temperature.gpu"

    def __init__(self):
        self.samples: T.List[T.Tuple[float, T.List[str]]] = []
        try:
            self._proc: T.Optional[subprocess.Popen] = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.FIELDS}", "--format=csv,noheader,nounits",
                 "-i", "0", "-lms", "200"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None
            return
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:  # type: ignore[union-attr]
            self.samples.append((time.monotonic(), [f.strip() for f in line.split(",")]))

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)
        self._reader.join(timeout=10)

    def summary(self, t0: float, t1: float) -> T.Dict[str, T.Any]:
        rows = [f for t, f in self.samples if t0 <= t <= t1 and len(f) == 3]
        out: T.Dict[str, T.Any] = {"samples": len(rows)}
        for i, key in enumerate(("sm_mhz", "power_w", "temp_c")):
            try:
                values = sorted(float(r[i]) for r in rows)
            except ValueError:
                continue
            if values:
                out[key] = [values[0], statistics.median(values), values[-1]]
        return out


def card() -> T.Dict[str, T.Any]:
    """The card's name (torch's), and its power limit (nvidia-smi's)."""
    import torch

    out: T.Dict[str, T.Any] = {"kind": torch.cuda.get_device_name(0)}
    try:
        line = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader,nounits", "-i", "0"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
        out["power_limit_w"] = float(line.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return out


# ------------------------------------------------------------ import check


def forbidden_modules(names: T.Iterable[str] = ()) -> T.List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(names) or list(sys.modules)
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES})


# ------------------------------------------------------------ the result


def result_line(record: Record, metrics: T.Dict[str, T.Tuple[float, str]],
                device: T.Dict[str, T.Any], breakdown: T.Optional[dict]) -> str:
    out: T.Dict[str, T.Any] = {
        "correct": bool(record.checks) and all(c.ok for c in record.checks)
        and record.failed == 0,
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": {k: {"value": v, "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in record.checks}
    return json.dumps(out)


def cache_dirs(repo: Path) -> None:
    """Fixed build and kernel-cache directories inside the checkout."""
    cache = repo / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["RIFFUSION_TPU_NO_EMBED_CACHE"] = "1"
