"""
The kernel sources against what other files assume of them, on the CPU:
- the kernel table (ops/kernels.py): each entry's source defines its
  `extern "C"` entry point, whose parameters, read from the source, match
  the entry's ctypes argument types in number and kind, so a signature
  edited on one side only fails here, not as corrupt arguments on the card;
  the two build rounds hold exactly what serving and a trainer launch; the
  entries' `__global__` names are the sources' kernels;
- the planted faults of `chip_smoke.py --mutants`: each MUTANTS entry's text
  occurs exactly once in its file under riffusion_tpu_torch/csrc/, so a
  kernel edit that leaves a mutant stale fails here, not only on the card;
  each entry names kernels that exist;
- `entry(name)` builds, at a kernel's first use, the first round that holds
  it, so AdamW's kernel needs no trainer to have built its round first.
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import pytest

from riffusion_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parent.parent


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MUTANTS = _load(REPO / "chip_smoke.py").MUTANTS


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutant_text_occurs_once_in_its_source(mutant):
    what, file, old, new, named = mutant
    text = (kernels.CSRC / file).read_text()
    assert text.count(old) == 1, f"{what!r}: {text.count(old)} occurrences in {file}"
    assert new != old and new not in text
    assert named and set(named) <= set(kernels.KERNELS)


def _global_kernels():
    """The names of the __global__ kernels defined in the kernel sources."""
    kernel = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    return {name for path in kernels.CSRC.glob("*.cu*")
            for name in kernel.findall(path.read_text())}


TABLE_GLOBALS = sorted({name for k in kernels.KERNELS.values() for name in k.kernels})


@pytest.mark.parametrize("key", TABLE_GLOBALS)
def test_profiler_kernel_key_is_a_kernel_in_the_sources(key):
    """Each name the profiler groups device time by is a __global__ kernel
    of the sources, so a renamed kernel cannot leave a profile counting
    nothing."""
    assert key in _global_kernels(), f"the kernel table names {key!r}, which no source defines"


def test_table_names_every_kernel_of_the_sources():
    assert set(TABLE_GLOBALS) == _global_kernels()


def test_global_kernels_are_found():
    """The pattern above finds every kernel the sources define: one bf16
    forward body (K1's and K2's), two backward bodies, their fp32 check
    instances, the NHWC GroupNorm's two launches, and the one-pass AdamW's
    update and step counts."""
    assert _global_kernels() == {
        "attention_fwd_bf16_kernel", "attention_f32_kernel", "attention_dkv_bf16_kernel",
        "attention_dq_bf16_kernel", "attention_dkv_f32_kernel", "attention_dq_f32_kernel",
        "group_norm_stats_kernel", "group_norm_apply_kernel", "adamw_kernel",
        "adamw_count_kernel"}


def _c_kind(param: str) -> str:
    """A C parameter's kind: "pointer", or its scalar type."""
    if "*" in param:
        return "pointer"
    return " ".join(re.sub(r"\bconst\b", "", param).split()[:-1])


def _ctypes_kind(argtype) -> str:
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_longlong: "long long", ctypes.c_int: "int", ctypes.c_float: "float",
            ctypes.c_double: "double"}[argtype]


@pytest.mark.parametrize("name", sorted(kernels.KERNELS), ids=lambda n: kernels.KERNELS[n].entry)
def test_entry_point_takes_its_argument_types(name):
    kernel = kernels.KERNELS[name]
    source = kernels.CSRC / kernel.source
    found = re.search(rf'extern "C" int {kernel.entry}\(([^)]*)\)', source.read_text())
    assert found, f"{source.name} defines no extern \"C\" int {kernel.entry}(...)"
    params = [p.strip() for p in found.group(1).split(",")]
    assert len(params) == len(kernel.argtypes)
    assert [_c_kind(p) for p in params] == [_ctypes_kind(t) for t in kernel.argtypes]


def test_build_rounds():
    """Serving builds and loads only what it launches: the two forward
    attention kernels and the NHWC GroupNorm; a trainer only K1 and its
    backward kernels and the one-pass AdamW."""
    assert sorted(kernels.FORWARD_KERNELS) == ["attention", "group_norm", "row_attention"]
    assert sorted(kernels.TRAIN_KERNELS) == ["adamw", "attention", "attention_dkv",
                                             "attention_dq"]
    assert set(kernels.FORWARD_KERNELS) | set(kernels.TRAIN_KERNELS) == set(kernels.KERNELS)


@pytest.mark.parametrize("name,round_", [
    ("group_norm", kernels.FORWARD_KERNELS), ("row_attention", kernels.FORWARD_KERNELS),
    ("attention", kernels.FORWARD_KERNELS), ("adamw", kernels.TRAIN_KERNELS),
    ("attention_dq", kernels.TRAIN_KERNELS),
], ids=["group_norm", "row_attention", "attention", "adamw", "attention_dq"])
def test_entry_builds_the_kernels_round_at_first_use(monkeypatch, name, round_):
    asked = []

    def build(names):
        asked.append(tuple(names))
        return {n: kernels.BuiltKernel(fn=f"fn of {n}", source=kernels.CSRC / "x.cu",
                                       path=Path("x.so"), build_seconds=0.0, compiler_log="")
                for n in names}

    monkeypatch.setattr(kernels, "build_kernels", build)
    assert kernels.entry(name) == f"fn of {name}"
    assert asked == [round_]
