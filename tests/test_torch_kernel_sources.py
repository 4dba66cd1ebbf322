"""
The kernel sources against what other files assume of them, on the CPU:
- the planted faults of `chip_smoke.py --mutants`: each MUTANTS entry's text
  occurs exactly once in its file under riffusion_tpu_torch/csrc/, so a
  kernel edit that leaves a mutant stale fails here, not only on the card;
  each entry names kernels that exist;
- the profilers' kernel names: each name the profiling scripts look for in
  a trace is a __global__ kernel of the sources, so a renamed kernel cannot
  leave a profile counting nothing.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from riffusion_tpu_torch.ops import attention as attn

REPO = Path(__file__).resolve().parent.parent


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MUTANTS = _load(REPO / "chip_smoke.py").MUTANTS


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutant_text_occurs_once_in_its_source(mutant):
    what, file, old, new, kernels = mutant
    text = (attn._CSRC / file).read_text()
    assert text.count(old) == 1, f"{what!r}: {text.count(old)} occurrences in {file}"
    assert new != old and new not in text
    assert kernels and set(kernels) <= set(attn.KERNELS)


def _profiler_keys():
    from riffusion_tpu_torch import profile_batch, profile_train

    request = _load(REPO / "scripts" / "profile_torch_request.py")
    return ([("profile_torch_request", key) for key in request.ATTENTION_KERNELS]
            + [("profile_train", key) for key in profile_train.ATTENTION_KERNELS.values()]
            + [("profile_batch", profile_batch.FORWARD_KERNEL)])


def _global_kernels():
    """The names of the __global__ kernels defined in the kernel sources."""
    kernel = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    return {name for path in attn._CSRC.glob("*.cu*") for name in kernel.findall(path.read_text())}


PROFILER_KEYS = _profiler_keys()


@pytest.mark.parametrize("script,key", PROFILER_KEYS, ids=[f"{s}-{k}" for s, k in PROFILER_KEYS])
def test_profiler_kernel_key_is_a_kernel_in_the_sources(script, key):
    assert key in _global_kernels(), f"{script} looks for {key!r}, which no source defines"


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
