"""
Spans and device stage times of the port, kept in memory for an operator
or a benchmark to read: the one place the port's `record_function` ranges
go through.

- `span(name)` always enters `torch.profiler.record_function(name)`, so a
  profiler (`python -m riffusion_tpu_torch.profile`) sees the same ranges
  whatever the switch says. With
  the switch on it also appends one record to a bounded ring: the name,
  the enclosing span's name, the id of the request or step (a span opened
  with `root=True`, or with no span open on its thread, takes a new id;
  the spans inside it share it), the thread, the start on
  `time.time_ns()` (the wall clock the profiler's events carry) and the
  duration. Per-name counts and seconds are kept beside the ring and drop
  nothing.
- `stage(name)` is a span around a device stage of a program (VAE encode,
  denoise, the train step's forward). While aot.py captures a program with
  the switch on, each stage also records a pair of timing events into the
  graph (`CudaGraphs.timing_event`: two event-record nodes a stage), which
  the program's entry keeps (`StageTimes`). A replay's stage times are
  read at the same graph's next launch, before its copies, and only if
  its last event has completed: a replay still running then is counted
  unread, and its times are never read after the next replay has
  overwritten them. Nothing synchronises for them. The last replay before
  a program is freed is neither read nor counted; an eager run records no
  events (its ranges serve the profiler).
- `export()` gives the rings, the aggregates and the counters ("dropped"
  spans and replays, "stage_read", "stage_unread", `EVENT_COUNTERS`, and
  the process's `KERNEL_COUNTERS` as ops.kernels.COUNTS holds them,
  replays included);
  it is the only exporter.

With the switch off nothing is recorded and no graph changes: a stage is
the `record_function` range alone.

    RIFFUSION_TPU_TRACE=1   records spans, and stage times in the programs
                            captured while it is set
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import typing as T

from torch.profiler import record_function

from riffusion_tpu_torch.ops import kernels

#: Records a ring holds; the oldest are dropped (and counted) beyond it.
CAPACITY = 100_000

#: The ops.kernels.COUNTS fields `export()` adds to its counters: the NHWC
#: GroupNorm kernel's calls (ops/group_norm.py), the GroupNorm calls on the
#: card that ran torch's F.group_norm instead (models/layers.py), K1's
#: launches and those of them that ran its warp-specialised body, the
#: self-attention sites routed to the plain composition, and the one-pass
#: AdamW's launches (ops/adamw.py).
KERNEL_COUNTERS = ("group_norm_launches", "group_norm_library_calls", "launches",
                   "k1_ws_launches", "plain_self_sites", "adamw_launches")

#: Host events `count()` adds up: SDXL's second text tower's runs
#: (riffusion_pipeline.py) and the sharded trainer's all-reduce calls
#: (parallel/train.py).
EVENT_COUNTERS = ("text_encoder_2_calls", "allreduce_calls")


def enabled() -> bool:
    return os.environ.get("RIFFUSION_TPU_TRACE", "") not in ("", "0")


class Span(T.NamedTuple):
    name: str
    parent: T.Optional[str]  # the enclosing span's name on the same thread
    id: int  # the request's or the step's
    thread: int
    start_ns: int  # time.time_ns()
    dur_ns: int


class Replay(T.NamedTuple):
    """One replay of a captured program with stages: its key, the id of the
    span that launched it, the host's time at its launch, and each stage's
    device milliseconds (summed over a stage's occurrences), or None where
    it was still running at the next launch."""

    key: str
    id: T.Optional[int]
    start_ns: int
    stages: T.Optional[T.Dict[str, float]]


class Tracer:
    """The rings, aggregates and counters of one process's spans and
    replays (module functions use `TRACER`)."""

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.spans: T.Deque[Span] = collections.deque(maxlen=capacity)
        self.replays: T.Deque[Replay] = collections.deque(maxlen=capacity)
        self.totals: T.Dict[str, T.List[float]] = {}  # name: [count, seconds]
        self.stage_totals: T.Dict[str, T.List[float]] = {}  # name: [count, device seconds]
        self.counters = dict.fromkeys(("dropped", "replays_dropped", "stage_read",
                                       "stage_unread") + EVENT_COUNTERS, 0)

    def _stack(self) -> T.List[T.Tuple[str, int]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_id(self) -> T.Optional[int]:
        """The id of the innermost span open on this thread."""
        stack = self._stack()
        return stack[-1][1] if stack else None

    def span(self, name: str, root: bool = False) -> T.ContextManager:
        if not enabled():
            return record_function(name)
        return self._recorded(name, root)

    @contextlib.contextmanager
    def _recorded(self, name: str, root: bool) -> T.Iterator[None]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        ident = next(self._ids) if root or parent is None else parent[1]
        stack.append((name, ident))
        start = time.time_ns()
        try:
            with record_function(name):
                yield
        finally:
            record = Span(name, parent[0] if parent else None, ident, threading.get_ident(),
                          start, time.time_ns() - start)
            stack.pop()
            with self._lock:
                self.counters["dropped"] += len(self.spans) == self.spans.maxlen
                self.spans.append(record)
                total = self.totals.setdefault(name, [0, 0.0])
                total[0] += 1
                total[1] += record.dur_ns / 1e9

    def count(self, name: str) -> None:
        """Count one of EVENT_COUNTERS' events, where the switch is on."""
        if enabled():
            with self._lock:
                self.counters[name] += 1

    def stage(self, name: str) -> T.ContextManager:
        if not enabled():
            return record_function(name)
        return self._stage(name)

    @contextlib.contextmanager
    def _stage(self, name: str) -> T.Iterator[None]:
        capture = getattr(self._local, "capture", None)
        with self._recorded(name, False):
            if capture is None:
                yield
                return
            new_event, pairs = capture
            start = new_event()
            start.record()
            yield
            end = new_event()
            end.record()
            pairs.append((name, start, end))

    @contextlib.contextmanager
    def capture(self, new_event: T.Callable[[], T.Any]) -> T.Iterator[T.List]:
        """Around a capture on this thread: the stages it runs record events
        from `new_event()` into the list given, as (name, start, end)."""
        pairs: T.List = []
        self._local.capture = (new_event, pairs)
        try:
            yield pairs
        finally:
            self._local.capture = None

    def _replay(self, replay: Replay) -> None:
        with self._lock:
            self.counters["replays_dropped"] += len(self.replays) == self.replays.maxlen
            self.replays.append(replay)
            if replay.stages is None:
                self.counters["stage_unread"] += 1
                return
            self.counters["stage_read"] += 1
            for name, ms in replay.stages.items():
                total = self.stage_totals.setdefault(name, [0, 0.0])
                total[0] += 1
                total[1] += ms / 1e3

    def export(self) -> T.Dict[str, T.Any]:
        """The rings (oldest first), the aggregates and the counters, as
        plain data."""
        with self._lock:
            return {
                "spans": [s._asdict() for s in self.spans],
                "replays": [r._asdict() for r in self.replays],
                "totals": {n: {"count": c, "s": s} for n, (c, s) in self.totals.items()},
                "stages": {n: {"count": c, "s": s} for n, (c, s) in self.stage_totals.items()},
                "counters": dict(self.counters, **{
                    name: getattr(kernels.COUNTS, name) for name in KERNEL_COUNTERS}),
            }

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.replays.clear()
            self.totals.clear()
            self.stage_totals.clear()
            for key in self.counters:
                self.counters[key] = 0


class StageTimes:
    """A captured program's stage events (`Tracer.capture`), owned by its
    entry in aot.GraphProgram, and the replay they hold times of."""

    def __init__(self, key: str, pairs: T.Sequence[T.Tuple[str, T.Any, T.Any]]):
        self.key, self.pairs = key, list(pairs)
        self._pending: T.Optional[T.Tuple[int, T.Optional[int]]] = None

    def read(self) -> None:
        """Before a replay: the last replay's stage times if its last event
        has completed, else that replay counted unread."""
        if self._pending is None:
            return
        start_ns, ident = self._pending
        self._pending = None
        stages = None
        if self.pairs[-1][2].query():
            stages = {}
            for name, start, end in self.pairs:
                stages[name] = stages.get(name, 0.0) + start.elapsed_time(end)
        TRACER._replay(Replay(self.key, ident, start_ns, stages))

    def replayed(self, start_ns: int) -> None:
        """After a replay launched at `start_ns`: its times are read at the
        next launch."""
        self._pending = (start_ns, TRACER.current_id())


TRACER = Tracer()
span = TRACER.span
stage = TRACER.stage
count = TRACER.count
export = TRACER.export
reset = TRACER.reset
