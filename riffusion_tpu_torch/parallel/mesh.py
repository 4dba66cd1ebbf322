"""
Process groups and device meshes: the counterpart of
riffusion_tpu/parallel/mesh.py over torch.distributed.

The JAX package runs one controller over a mesh of devices, and XLA
inserts the collectives. Here every rank is a process (SPMD): each calls
the same entry point with the same arguments, computes its share, and
explicit collectives over the mesh's axis groups join the shares
(`gather_rows` here, the tensor-parallel all-reduce in tp_serving.py).

- `init_distributed` joins the process group a launcher describes
  (torchrun's RANK / WORLD_SIZE / LOCAL_RANK and MASTER_ADDR /
  MASTER_PORT).
- `make_mesh` lays the ranks of that group out as a named
  `torch.distributed.device_mesh.DeviceMesh`; it raises when no group is
  initialized (it never builds a single-device mesh quietly).
- `factor_mesh_shape` is a copy of the JAX package's pure function.
- `spawn_world` starts a world of processes on this host, each with its
  process group joined, runs one function on every rank and returns what
  each returned (the tests, the dryrun and chip_smoke.py use it).

The JAX package's `replicated` / `batch_sharding` name GSPMD placements.
Nothing in the port needs them: every rank holds the whole of a replicated
tensor, and a rank's share of a batch is a slice it computes itself.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
import typing as T

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: How long a collective may wait for its peers before it fails (seconds).
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(
    backend: T.Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S
) -> None:
    """Join the process group that RANK, WORLD_SIZE and MASTER_ADDR /
    MASTER_PORT describe (torchrun sets them). With a card, the CUDA device
    becomes LOCAL_RANK's (modulo the cards this host has, so that ranks
    beyond the card count share cards) and the backend nccl; without one,
    gloo. `backend` overrides that choice: NCCL refuses two ranks on one
    card, so ranks that share a card use gloo, which moves CUDA tensors
    through the host."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed needs {missing} in the environment (torchrun "
                           "sets them)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def backend_for(device: str, ranks_here: int) -> str:
    """nccl where each of this host's `ranks_here` ranks has a card of its
    own, gloo where ranks share cards (NCCL refuses two ranks on one card)
    or run on the CPU."""
    cards = torch.cuda.device_count() if device == "cuda" else 0
    return "nccl" if ranks_here <= cards else "gloo"


def make_mesh(
    shape: T.Optional[T.Tuple[int, ...]] = None,
    axis_names: T.Tuple[str, ...] = ("data", "model"),
    devices: T.Optional[T.Sequence[int]] = None,
    device_type: T.Optional[str] = None,
) -> DeviceMesh:
    """A DeviceMesh over the ranks of the default process group, axes named
    `axis_names`. With shape=None every rank goes on the first axis (pure
    data parallel). `devices` is the sequence of global ranks to lay out
    (default: every rank, in order); the axis sizes must multiply to its
    length. `device_type` is "cuda" where a card is present, else "cpu".
    Raises when no process group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_distributed, "
                           "torchrun or spawn_world); it builds no single-device mesh")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    return DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def factor_mesh_shape(n: int, num_axes: int) -> T.Tuple[int, ...]:
    """Greedy near-balanced factorization of n devices into num_axes axes
    (e.g. 8, 3 -> (2, 2, 2); 4, 2 -> (2, 2); 6, 2 -> (2, 3))."""
    shape = [1] * num_axes
    remaining = n
    axis = 0
    f = 2
    while remaining > 1:
        while remaining % f != 0:
            f += 1
        shape[axis % num_axes] *= f
        remaining //= f
        axis += 1
    return tuple(shape)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh axis named `axis`."""
    return int(mesh.shape[_axis_index(mesh, axis)])


def _axis_index(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis (its axes: {names})")
    return names.index(axis)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The ranks' `x` (one shape on every rank) along the mesh axis `axis`,
    concatenated on dim 0 in axis order, on every rank of it. It is an
    all-reduce of a zero buffer that holds this rank's rows at its place:
    exact (integers are summed as int32), and it runs on either backend
    with CUDA tensors (gloo reduces CUDA tensors but gathers only CPU
    ones)."""
    d, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    wide = x.dtype if x.dtype.is_floating_point else torch.int32
    buf = torch.zeros((d,) + tuple(x.shape), dtype=wide, device=x.device)
    buf[r] = x
    dist.all_reduce(buf, group=mesh.get_group(axis))
    return buf.flatten(0, 1).to(x.dtype)


def data_share(mesh: DeviceMesh, n: int, axis: str = "data") -> T.Tuple[int, int]:
    """(start, stop) of this rank's contiguous share of n items split over
    the mesh axis `axis`; n must divide by the axis size."""
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"batch {n} not divisible by {axis} axis {d}")
    k = n // d
    r = mesh.get_local_rank(axis)
    return r * k, (r + 1) * k


# ------------------------------------------------------------ worlds on one host


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: T.Optional[str], timeout_s: float,
               fn: T.Callable, args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    # ranks share this host's cores (and the test runner's workers)
    torch.set_num_threads(1)
    try:
        init_distributed(backend, timeout_s)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # sent to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn_world(
    fn: T.Callable[..., T.Any],
    world_size: int,
    args: tuple = (),
    *,
    backend: T.Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> T.List[T.Any]:
    """Run fn(rank, world_size, *args) in `world_size` fresh processes on
    this host, each inside a process group joined through init_distributed
    (`backend` as there) with one intra-op thread, and return the ranks'
    results in rank order. `fn` and its results must pickle (a
    module-level function). A rank that raises, dies, or outlives
    `timeout_s` (the collectives' own limit too) makes this raise with its
    traceback, after every rank process is stopped."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world_size, port, backend, timeout_s, fn, args, results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out: T.Dict[int, T.Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if i not in out and p.exitcode is not None}
                if dead:
                    raise RuntimeError(f"rank(s) exited without a result (rank: exit code) {dead}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world_size} did not finish in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[rank] for rank in range(world_size)]
