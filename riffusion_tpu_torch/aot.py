"""
Whole-request programs as captured CUDA graphs: the port's counterpart of
riffusion_tpu/aot.py and of the compiled programs it stores.

The JAX package runs every request as one compiled program per
configuration key (riffusion_pipeline.py `_riffuse_program`,
`_riffuse_batch_program`, `_txt2img_program`, `_txt2img_batch_program`,
`_magic_mix_program`) and obtains each executable once (`AotProgram`). On
the card the counterpart of a compiled whole program is a captured CUDA
graph. `GraphProgram(fn, key)` holds one: `fn` is a pure function of
tensors (or None) whose Python choices all come from `key`, and its
signature is the key with the inputs' shapes and dtypes (`signature`, as
JAX's `_aval_signature`). The trainer's programs (parallel/train.py
"train_step", training/finetune.py "ema_update", the counterparts of the
JAX trainer's jitted step and EMA) also update state outside their inputs
in place, as JAX's step donates its parameters: their warm-up is a real
step, the capture runs nothing, and every replay is a step; their owner
drops them (`GraphStore.clear`) when it replaces that state's tensors.

- The first call with a signature copies the inputs into static buffers
  and runs `fn` on them once, eagerly, on a side stream: the warm-up, which
  builds the kernels, cuDNN's algorithms and cuFFT's plans, and whose
  outputs are the call's result. Then it captures `fn` on the same buffers
  into a torch.cuda.CUDAGraph and keeps the static inputs and outputs as
  long as the graph.
- Every later call copies its inputs into the static buffers, replays the
  graph and returns copies of the static outputs.
- ops.kernels.COUNTS counts kernel launches in Python, which a replay
  does not run. The launches counted while capturing (none of which ran)
  are taken back, and added again on every replay, so every call counts
  what an eager call counts.
- A capture that fails raises CaptureError, naming the key and the last
  torch operation the program called (a host sync, `.item()` or a
  host-to-device copy, is the usual one). Nothing retries eagerly.
- `stage_report(*args)` says how the graph was obtained: "source"
  ("captured" by this call, or "replayed" when it existed), "warmup_s" and
  "capture_s" (the counterparts of JAX's trace_lower_s and compile_s) and
  "nodes" (the graph's node count, when the store was asked to count
  them).
- Every call runs inside a `riffusion.launch` span (tracing.py): the
  copies, the replay and the output copies on the host (the card runs on),
  or the warm-up and the capture; `eager(fn)` opens the same span around a
  program that runs without a graph, so an owner opens none. A graph captured with
  RIFFUSION_TPU_TRACE=1 also records a pair of timing events at each of
  the program's stages (`tracing.stage`), which its entry keeps: each
  replay's stage times are read at the graph's next launch, where the
  replay has completed (tracing.StageTimes). A graph captured with the
  switch off has only the program's own nodes.

Memory. The programs of one `GraphStore` (one per pipeline, one per
trainer) capture into one pool (`torch.cuda.graph_pool_handle()`), so a
capture reuses what the earlier ones freed. That is safe for two reasons:
- the owner serialises its programs: the pipeline's `_dispatch_lock`
  (riffusion_pipeline.py `_dispatch_program`) queues one at a time, the
  trainer's caller steps one thread; each runs on the current stream, and
  its outputs are copied out of the static buffers before another
  replays, so no two graphs' scratch is live at once;
- the store holds every graph's static inputs and outputs, so a later
  capture never takes their memory.

Captures take `CAPTURE_LOCK`, one at a time in the process, in torch's
"global" capture mode; the pipeline's readback waits under the same lock,
so no other thread of the server synchronises with the card while a graph
is being captured.

There is no disk store: a CUDA graph cannot be serialised for another
process. The parts of a restart that can come off disk already do: the
kernels' builds (csrc/build/) and the text embeddings (embed_cache.py).

    RIFFUSION_TPU_NO_AOT=1   runs every program eagerly (the JAX package's
                             switch); the CPU always does
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import threading
import time
import typing as T

import torch
from torch.overrides import TorchFunctionMode

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.ops import kernels

Args = T.Tuple[T.Optional[torch.Tensor], ...]

#: One capture at a time in the process (torch's rule too), and no wait on
#: the card from another thread while one is under way.
CAPTURE_LOCK = threading.Lock()


def enabled() -> bool:
    return not os.environ.get("RIFFUSION_TPU_NO_AOT")


def captures(device: torch.device) -> bool:
    """Whether programs on `device` go through the store: on a CUDA device
    while the store is on."""
    return device.type == "cuda" and enabled()


def eager(fn: T.Callable) -> T.Callable:
    """`fn` as a device program run without a graph (on the CPU, over a
    mesh, or with the store off): each call inside the `riffusion.launch`
    span that a GraphProgram's call opens."""

    def launch(*args: T.Any) -> T.Any:
        with tracing.span("riffusion.launch"):
            return fn(*args)

    return launch


def signature(key: str, args: Args) -> str:
    """The key with each input's shape and dtype ("none" for None)."""
    parts = []
    for x in args:
        if x is None:
            parts.append("none")
        elif isinstance(x, torch.Tensor):
            parts.append(f"{tuple(x.shape)}:{x.dtype}")
        else:
            raise TypeError(f"a program of {key} takes tensors or None, got {type(x).__name__}")
    return f"{key}|{';'.join(parts)}"


class CaptureError(RuntimeError):
    """A program could not be captured into a CUDA graph."""


class _LastOp(TorchFunctionMode):
    """Remembers the last torch function a program called."""

    name = "no torch operation"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.name = getattr(func, "__qualname__", None) or repr(func)
        return func(*args, **(kwargs or {}))


def _clone(outputs: T.Any) -> T.Any:
    """Copies of a program's outputs: a tensor, None, or a tuple of them."""
    if isinstance(outputs, tuple):
        return tuple(_clone(x) for x in outputs)
    return None if outputs is None else outputs.clone()


def _tensors(outputs: T.Any) -> T.List[torch.Tensor]:
    if isinstance(outputs, tuple):
        return [t for x in outputs for t in _tensors(x)]
    return [] if outputs is None else [outputs]


class CudaGraphs:
    """What the store asks of the card: a warm-up run, a capture, a replay.
    `count_nodes` keeps each graph's topology to count its nodes (through
    libcuda's cuGraphGetNodes), for measurement; the topology of a whole
    request is tens of thousands of nodes, so serving leaves it off."""

    def __init__(self, count_nodes: bool = False):
        self.count_nodes = count_nodes

    def pool(self) -> T.Any:
        return torch.cuda.graph_pool_handle()

    def warmup(self, fn: T.Callable, args: Args) -> T.Any:
        """fn(*args) on a side stream, ordered after the current stream's
        work and before its later work, synchronised (on the current device
        for a program without inputs)."""
        device = next((x.device for x in args if x is not None), None)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            outputs = fn(*args)
        current.wait_stream(side)
        for x in _tensors(outputs):
            x.record_stream(current)
        torch.cuda.synchronize(device)
        return outputs

    def capture(self, fn: T.Callable, args: Args, pool: T.Any) -> T.Tuple[T.Any, T.Any]:
        """(graph, static outputs) of fn(*args) captured into `pool`."""
        graph = torch.cuda.CUDAGraph(keep_graph=True) if self.count_nodes \
            else torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            outputs = fn(*args)
        if self.count_nodes:
            graph.instantiate()
        return graph, outputs

    def replay(self, graph: T.Any) -> None:
        graph.replay()

    def timing_event(self) -> T.Any:
        """An event a stage records inside a capture, as a node of the
        graph, for its device time (tracing.stage)."""
        return torch.cuda.Event(enable_timing=True, external=True)

    def nodes(self, graph: T.Any) -> T.Optional[int]:
        if not self.count_nodes:
            return None
        count = ctypes.c_size_t(0)
        libcuda = ctypes.CDLL("libcuda.so.1")
        libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_size_t)]
        rc = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                     ctypes.byref(count))
        if rc != 0:
            raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
        return int(count.value)


@dataclasses.dataclass
class _Captured:
    graph: T.Any
    inputs: Args  # the static buffers every call copies into
    outputs: T.Any  # the static outputs every replay writes
    launched: T.Dict[str, int]  # COUNTS' increments of one run
    report: T.Dict[str, T.Any]
    stages: T.Optional[tracing.StageTimes]  # captured with the tracing switch on


class GraphProgram:
    """`fn` captured once per signature and replayed (see the module
    docstring). Callers serialise their calls (the pipeline's dispatch
    lock); `pool` is the memory pool the captures share (a pool of their
    own when None)."""

    def __init__(self, fn: T.Callable, key: str, pool: T.Any = None,
                 graphs: T.Optional[CudaGraphs] = None):
        self.fn, self.key = fn, key
        self.graphs = graphs or CudaGraphs()
        self.pool = pool
        self._captured: T.Dict[str, _Captured] = {}

    def __len__(self) -> int:
        return len(self._captured)

    def reports(self) -> T.List[T.Dict[str, T.Any]]:
        """Each captured signature's stage report."""
        return [dict(entry.report) for entry in self._captured.values()]

    def __call__(self, *args: T.Optional[torch.Tensor]) -> T.Any:
        with tracing.span("riffusion.launch"):
            sig = signature(self.key, args)
            entry = self._captured.get(sig)
            if entry is None:
                return self._capture(sig, args)
            if entry.stages is not None:
                entry.stages.read()
            for static, x in zip(entry.inputs, args):
                if static is not None:
                    static.copy_(x)
            start_ns = time.time_ns()
            self.graphs.replay(entry.graph)
            if entry.stages is not None:
                entry.stages.replayed(start_ns)
            kernels.COUNTS.add(entry.launched)
            return _clone(entry.outputs)

    def _capture(self, sig: str, args: Args) -> T.Any:
        static = tuple(None if x is None else x.clone() for x in args)
        t0 = time.perf_counter()
        outputs = self.graphs.warmup(self.fn, static)
        warmup_s = time.perf_counter() - t0

        tracker, failures = _LastOp(), []

        def traced(*xs):
            try:
                with tracker:
                    return self.fn(*xs)
            except BaseException as exc:
                failures.append(exc)
                raise

        before = kernels.COUNTS.snapshot()
        timed = (tracing.TRACER.capture(self.graphs.timing_event) if tracing.enabled()
                 else contextlib.nullcontext(None))
        t0 = time.perf_counter()
        try:
            with CAPTURE_LOCK, timed as pairs:
                graph, static_out = self.graphs.capture(traced, static, self.pool)
        except Exception as exc:
            kernels.COUNTS.restore(before)
            first = failures[0] if failures else exc
            raise CaptureError(f"capturing {self.key} failed at {tracker.name}: "
                               f"{type(first).__name__}: {first}") from first
        capture_s = time.perf_counter() - t0
        launched = kernels.COUNTS.since(before)
        kernels.COUNTS.restore(before)
        self._captured[sig] = _Captured(
            graph=graph, inputs=static, outputs=static_out, launched=launched,
            report={"key": self.key, "warmup_s": warmup_s, "capture_s": capture_s,
                    "nodes": self.graphs.nodes(graph)},
            stages=tracing.StageTimes(self.key, pairs) if pairs else None,
        )
        return outputs

    def stage_report(self, *args: T.Optional[torch.Tensor]) -> T.Dict[str, T.Any]:
        """How the graph of these inputs' signature was obtained: captured by
        this call (which runs the program once, as its warm-up), or replayed
        from an earlier capture (warmup_s and capture_s 0)."""
        sig = signature(self.key, args)
        if sig in self._captured:
            return dict(self._captured[sig].report, source="replayed", warmup_s=0.0,
                        capture_s=0.0)
        self._capture(sig, args)
        return dict(self._captured[sig].report, source="captured")


class GraphStore:
    """One owner's programs (a pipeline's, or a trainer's), one GraphProgram
    per key, all capturing into one pool."""

    def __init__(self, graphs: T.Optional[CudaGraphs] = None):
        self.graphs = graphs or CudaGraphs()
        self.programs: T.Dict[str, GraphProgram] = {}
        self._pool: T.Any = None

    def program(self, key: str, fn: T.Callable) -> GraphProgram:
        """The program of `key`, made around `fn` on the key's first use."""
        if key not in self.programs:
            if self._pool is None:
                self._pool = self.graphs.pool()
            self.programs[key] = GraphProgram(fn, key, pool=self._pool, graphs=self.graphs)
        return self.programs[key]

    def clear(self) -> None:
        """Drop every program and its graphs (the pool stays for the next
        captures): for an owner whose programs read state outside their
        inputs, after that state was replaced by other tensors."""
        self.programs.clear()
