"""
The port's hand-written kernels as one table: each kernel's CUDA source, its
C entry point and that entry point's ctypes argument types, the `__global__`
kernels its launches run (the names a profiler gives them), the two build
rounds, the build and the load, and `COUNTS`, the package's launch counters.

The wrappers (ops/attention.py, ops/group_norm.py, ops/adamw.py) take a
kernel's entry point from `entry(name)` and count into `COUNTS`. Adding a
kernel touches its .cu, its ops/*.py and one `KERNELS` entry.

Build. The kernels are built with nvcc at first use (shared libraries with
a plain C entry point each, loaded with ctypes) into csrc/build/, as
`{name}-{digest}.so`, keyed by a hash of the source and the headers beside
it. `entry(name)` builds the whole round the kernel first belongs to, so
serving builds and loads only `FORWARD_KERNELS` and a trainer only
`TRAIN_KERNELS` (which `DiffusionTrainer.init_from` starts itself).
`build_kernels(names, csrc=DIR)` builds and loads the named kernels from
another copy of csrc/ (chip_smoke.py's mutants, scripts/
time_kernel_variants.py): the wrappers then launch those until the kernels
are loaded again from another tree.

Counters. `COUNTS` counts each kernel's launches and the calls that took a
plain version instead (its fields say whose). A wrapper called while a CUDA
graph is captured counts its launch there; the graph's program (aot.py)
takes those counts back and adds them again on each replay.

K1's bodies. K1 (csrc/attention.cu) runs one of two bodies: the
warp-specialised attention_fwd_ws.cuh at the head widths of
`K1_WS_HEAD_DIMS` (serving's bf16 forward without the log-sum-exp), and
attention_fwd.cuh's, K2's too, everywhere else. `k1_instance` names the
instance a width runs, as a profiler shows it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
import typing as T
from pathlib import Path

__all__ = ["KERNELS", "FORWARD_KERNELS", "TRAIN_KERNELS", "CSRC", "BUILD_DIR", "COUNTS",
           "Counts", "entry", "build_kernels", "built_on_disk", "ptxas_instances",
           "K1_WS_HEAD_DIMS", "k1_instance", "check_register_caps"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"


class Kernel(T.NamedTuple):
    source: str  # a file of csrc/
    entry: str  # its C entry point
    argtypes: T.Tuple[T.Any, ...]  # the entry point's ctypes argument types
    kernels: T.Tuple[str, ...]  # the __global__ kernels its launches run


_P, _I64, _I32, _F32, _F64 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                              ctypes.c_double)
# q, k, v, out, lse; q, k, v, out (batch, seq) strides; batch, s_q, s_kv,
# heads, head_dim; scale; dtype, device; stream
_FORWARD_ARGS = (_P,) * 5 + (_I64,) * 8 + (_I32,) * 5 + (_F32, _I32, _I32, _P)
# q, k, v, dout, lse, delta, g0, g1; q, k, v, dout, g0 strides; then as above
_BACKWARD_ARGS = (_P,) * 8 + (_I64,) * 10 + (_I32,) * 5 + (_F32, _I32, _I32, _P)
_FORWARD_BODY = ("attention_fwd_bf16_kernel", "attention_f32_kernel")

KERNELS = {
    # K1's entry point takes its body last (1: the warp-specialised one)
    "attention": Kernel("attention.cu", "riff_attention_forward", _FORWARD_ARGS + (_I32,),
                        _FORWARD_BODY + ("attention_fwd_bf16_kernel_ws",)),
    "row_attention": Kernel("row_attention.cu", "riff_row_attention_forward", _FORWARD_ARGS,
                            _FORWARD_BODY),
    "attention_dkv": Kernel("attention_dkv.cu", "riff_attention_bwd_dkv", _BACKWARD_ARGS,
                            ("attention_dkv_bf16_kernel", "attention_dkv_f32_kernel")),
    "attention_dq": Kernel("attention_dq.cu", "riff_attention_bwd_dq", _BACKWARD_ARGS,
                           ("attention_dq_bf16_kernel", "attention_dq_f32_kernel")),
    # x, gamma, beta, y, partials; batch, hw, channels, groups, rows, chunk,
    # chunks; eps; silu, dtype, param dtype, device; stream
    "group_norm": Kernel("group_norm.cu", "riff_group_norm",
                         (_P,) * 5 + (_I32,) * 7 + (_F32,) + (_I32,) * 4 + (_P,),
                         ("group_norm_stats_kernel", "group_norm_apply_kernel")),
    # params, exp_avgs, exp_avg_sqs, grads, steps (pointer arrays); numels,
    # grad_bf16 (arrays), leaves; lr; beta1, beta2, eps, weight decay;
    # blocks, device; stream
    "adamw": Kernel("adamw.cu", "riff_adamw",
                    (_P,) * 5 + (ctypes.POINTER(_I64), ctypes.POINTER(_I32), _I32, _P, _F64,
                                 _F64, _F32, _F32, _I32, _I32, _P),
                    ("adamw_kernel", "adamw_count_kernel")),
}
FORWARD_KERNELS = ("attention", "row_attention", "group_norm")  # what serving launches
TRAIN_KERNELS = ("attention", "attention_dkv", "attention_dq", "adamw")  # what a trainer launches

#: The head widths whose bf16 K1 forward without the log-sum-exp runs the
#: warp-specialised body (attention_fwd_ws.cuh): 64, SDXL's every
#: self-attention site, and SD v1's 40 and 80, where it also measured faster
#: than attention_fwd.cuh's in one call (PERF.md).
K1_WS_HEAD_DIMS = (40, 64, 80)


def k1_instance(head_dim: int, lse: bool = False) -> str:
    """The bf16 instance K1 launches at `head_dim` (with the log-sum-exp
    write where `lse`) as a profiler names it, without its namespace and
    parameters: `name<DP, DN, ...>`, DP the width padded to 16 and DN the
    width of P V (attention.cu's and the bodies' dispatch)."""
    dp = -(-head_dim // 16) * 16
    if head_dim in K1_WS_HEAD_DIMS and not lse:
        return f"attention_fwd_bf16_kernel_ws<{dp}, {head_dim}, 128, {2 if dp > 64 else 3}>"
    dn = 40 if head_dim == 40 else dp
    return f"attention_fwd_bf16_kernel<{dp}, {dn}, 2, {'true' if lse else 'false'}>"


@dataclasses.dataclass
class Counts:
    launches: int = 0  # K1 (ops/attention.py), either body
    k1_ws_launches: int = 0  # those of K1's that ran the warp-specialised body
    row_launches: int = 0  # K2
    bwd_dkv_launches: int = 0
    bwd_dq_launches: int = 0
    plain_calls: int = 0  # attention wrapper calls that took the plain version
    group_norm_launches: int = 0  # ops/group_norm.py, on the card
    group_norm_plain_calls: int = 0
    group_norm_library_calls: int = 0  # models/layers.py GroupNorm: F.group_norm on the card
    plain_self_sites: int = 0  # models/layers.py Attention: card self-attention routed "plain"
    adamw_launches: int = 0  # ops/adamw.py

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)

    def snapshot(self) -> T.Dict[str, int]:
        return dataclasses.asdict(self)

    def since(self, before: T.Mapping[str, int]) -> T.Dict[str, int]:
        """What was counted after `before` (a snapshot)."""
        return {k: v - before[k] for k, v in self.snapshot().items()}

    def restore(self, before: T.Mapping[str, int]) -> None:
        for name, value in before.items():
            setattr(self, name, value)

    def add(self, counted: T.Mapping[str, int]) -> None:
        """Count again what `since` gave (a captured graph's replay)."""
        for name, value in counted.items():
            setattr(self, name, getattr(self, name) + value)


COUNTS = Counts()


@dataclasses.dataclass(frozen=True)
class BuiltKernel:
    fn: T.Any  # the ctypes entry point
    source: Path  # the .cu it was built from
    path: Path
    build_seconds: float  # 0.0 when an earlier build of the same source was reused
    compiler_log: str


_build_lock = threading.Lock()
_built: T.Dict[str, BuiltKernel] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(source: Path) -> str:
    """Hash of a source and every header beside it (what it may include)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return h.hexdigest()[:16]


def _stem(name: str, csrc: Path = CSRC) -> Path:
    """The build's path without its suffix, keyed by the source's digest."""
    return BUILD_DIR / f"{name}-{_digest(csrc / KERNELS[name].source)}"


def built_on_disk(names: T.Sequence[str]) -> bool:
    """Whether csrc/build/ already holds a build of each named source."""
    return all(_stem(name).with_suffix(".so").is_file() for name in names)


def build_kernels(
    names: T.Sequence[str] = tuple(KERNELS), rebuild: bool = False, csrc: Path = CSRC,
) -> T.Dict[str, BuiltKernel]:
    """Compile the named sources of `csrc` for sm_90a (once per hash, or
    anew with `rebuild`), one nvcc per source, all started together, and
    load them: each is what `entry` gives from then on."""
    csrc = Path(csrc).resolve()
    with _build_lock:
        todo = [n for n in names if rebuild or n not in _built
                or _built[n].source != csrc / KERNELS[n].source]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in todo:
            source = csrc / KERNELS[name].source
            stem = _stem(name, csrc)
            so_path, log_path = stem.with_suffix(".so"), stem.with_suffix(".log")
            proc = tmp = None
            if rebuild or not so_path.is_file():
                tmp = stem.with_suffix(f".{os.getpid()}.tmp.so")
                cmd = [
                    _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(source),
                ]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
            jobs[name] = (source, so_path, log_path, tmp, proc, time.perf_counter())
        for name, (source, so_path, log_path, tmp, proc, start) in jobs.items():
            seconds = 0.0
            if proc is not None:
                out, _ = proc.communicate()
                seconds = time.perf_counter() - start
                log_path.write_text(out)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}) building {source}:\n{out}")
                os.replace(tmp, so_path)
            log = log_path.read_text() if log_path.is_file() else ""
            check_register_caps(log, source)
            fn = getattr(ctypes.CDLL(str(so_path)), KERNELS[name].entry)
            fn.restype = ctypes.c_int
            fn.argtypes = list(KERNELS[name].argtypes)
            _built[name] = BuiltKernel(fn=fn, source=source, path=so_path, build_seconds=seconds,
                                       compiler_log=log)
        return {n: _built[n] for n in names}


def entry(name: str) -> T.Any:
    """Kernel `name`'s loaded C entry point; at its first use, the build of
    the first round that holds it (FORWARD_KERNELS, else TRAIN_KERNELS)."""
    built = _built.get(name)
    if built is None:
        built = build_kernels(FORWARD_KERNELS if name in FORWARD_KERNELS else TRAIN_KERNELS)[name]
    return built.fn


WS_THREADS = 384  # attention_fwd_ws.cuh's block: a producer and two consumer warpgroups


def check_register_caps(compiler_log: str, source: Path) -> None:
    """Raise unless each warp-specialised instance (`..._ws<...>`, one block
    of WS_THREADS an SM) launches with its block's share of the SM's 65,536
    registers: its warpgroups move registers between them with setmaxnreg,
    and a consumer that asks for more than the producer gave up waits for
    ever."""
    share = 65536 // WS_THREADS // 8 * 8
    for instance, registers, _ in ptxas_instances(compiler_log):
        used = int(re.search(r"Used (\d+) registers", registers).group(1))
        if "_ws<" in instance and used != share:
            raise RuntimeError(f"{source}: {instance} launches with {used} registers, not its "
                               f"block's {share}: its setmaxnreg would not be met")


def ptxas_instances(compiler_log: str) -> T.List[T.Tuple[str, str, str]]:
    """(instance, registers, spills) of each kernel instance in an nvcc
    `-Xptxas -v` log: the instance as `name<args>` read from the mangled
    name (`_ZN4riff25attention_fwd_bf16_kernelILi48ELi40ELi2ELb0EEEv...` ->
    `attention_fwd_bf16_kernel<48, 40, 2, 0>`, `..._kernel_wsILi64E...` ->
    `attention_fwd_bf16_kernel_ws<64, ...>`; a bfloat16 or float type
    argument as `bf16` or `float`), ptxas's "Used ... registers"
    line and its spill line."""
    found, instance, spills = [], "?", ""
    for line in compiler_log.splitlines():
        entry_fn = re.search(
            r"Compiling entry function '(\w+?_kernel(?:_[a-z]+)?)I"
            r"((?:L[ib]\d+E|13__nv_bfloat16|f)+)E", line)
        if entry_fn:  # the name after the mangling's last length prefix, and its arguments
            name = re.split(r"\d+(?=[a-z])", entry_fn.group(1))[-1]
            args = [value or ("bf16" if bf16 else "float") for value, bf16 in
                    re.findall(r"L[ib](\d+)E|13__nv_(bfloat16)|f", entry_fn.group(2))]
            instance = f"{name}<{', '.join(args)}>"
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            found.append((instance, line.split(":", 1)[-1].strip(), spills))
    return found
