"""
The planted faults of `chip_smoke.py --mutants` against the kernel sources
they edit, on the CPU: each MUTANTS entry's text occurs exactly once in its
file under riffusion_tpu_torch/csrc/, so a kernel edit that leaves a mutant
stale fails here, not only on the card. Each entry names kernels that exist.
"""

import importlib.util
from pathlib import Path

import pytest

from riffusion_tpu_torch.ops import attention as attn

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MUTANTS = _chip_smoke().MUTANTS


@pytest.mark.parametrize("mutant", MUTANTS, ids=[m[0] for m in MUTANTS])
def test_mutant_text_occurs_once_in_its_source(mutant):
    what, file, old, new, kernels = mutant
    text = (attn._CSRC / file).read_text()
    assert text.count(old) == 1, f"{what!r}: {text.count(old)} occurrences in {file}"
    assert new != old and new not in text
    assert kernels and set(kernels) <= set(attn.KERNELS)
