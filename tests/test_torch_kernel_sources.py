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
    """The pattern above finds every kernel the sources define: two bf16
    forward bodies (K2's and K1's outside serving, and K1's warp-specialised
    one), two backward bodies, their fp32 check
    instances, the NHWC GroupNorm's two launches, and the one-pass AdamW's
    update and step counts."""
    assert _global_kernels() == {
        "attention_fwd_bf16_kernel", "attention_fwd_bf16_kernel_ws", "attention_f32_kernel",
        "attention_dkv_bf16_kernel",
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


@pytest.mark.parametrize("head_dim,lse", [(40, False), (64, False), (80, False), (40, True),
                                          (80, True), (24, False), (128, True)])
def test_k1_instance_names_read_as_their_head_width(head_dim, lse):
    """bench_port's rooflines find K1's launches by `attention_fwd_bf16_kernel`
    in a profiler's name and read the head width from the second template
    argument: every instance K1 launches at the cells' widths, on either
    body, gives it (the others give their padded width)."""
    from bench_port.metrics import _attention

    name = kernels.k1_instance(head_dim, lse)
    assert _attention.FORWARD in name
    expected = head_dim if head_dim in (40, 64, 80) else -(-head_dim // 16) * 16
    for shown in (f"void riff::{name}(riff::Params)",
                  f"void riff::{name}(riff::Params, CUtensorMap_st, CUtensorMap_st, "
                  "CUtensorMap_st)"):
        assert _attention.head_dim(shown) == expected


@pytest.mark.parametrize("head_dim", kernels.K1_WS_HEAD_DIMS)
def test_k1_ws_widths_have_the_named_instances(head_dim):
    """Each width ops/attention.py routes to the warp-specialised body has
    that body's instance in csrc/attention_fwd_ws.cuh's dispatch, with the
    template arguments `k1_instance` names: a width routed there without one
    would be refused on the card."""
    args = kernels.k1_instance(head_dim).split("<", 1)[1].rstrip(">")
    text = (kernels.CSRC / "attention_fwd_ws.cuh").read_text()
    assert f"case {head_dim}: return (int)launch_fwd_ws<{args}>(" in text


def test_warp_specialised_builds_are_held_to_their_register_share():
    """ptxas's log names the warp-specialised instance as `k1_instance` does,
    and a build whose launch registers are not its block's share of the SM
    (65,536 over 384 threads: 168) is refused: its consumers' setmaxnreg
    would wait for registers the producer never gives up."""
    log = ("ptxas info    : Compiling entry function '_ZN4riff28attention_fwd_bf16_kernel_wsILi64E"
           "Li64ELi128ELi3EEEvNS_6ParamsE14CUtensorMap_stS2_S2_' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n")
    assert kernels.ptxas_instances(log)[0][0] == kernels.k1_instance(64)
    kernels.check_register_caps(log, Path("attention.cu"))
    with pytest.raises(RuntimeError, match="setmaxnreg"):
        kernels.check_register_caps(log.replace("Used 168", "Used 128"), Path("attention.cu"))
