"""
The port never imports jax or flax: a fresh interpreter imports every
riffusion_tpu_torch module, runs the tiny slice on the CPU, and checks
sys.modules. Also a static check that no source of the port imports them,
and that it calls no library attention or compiler.
"""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "riffusion_tpu_torch"

_PROGRAM = r"""
import importlib, pkgutil, sys
import numpy as np
from PIL import Image
import riffusion_tpu_torch
for mod in pkgutil.walk_packages(riffusion_tpu_torch.__path__, "riffusion_tpu_torch."):
    importlib.import_module(mod.name)

from riffusion_tpu.datatypes import InferenceInput, PromptInput
from riffusion_tpu.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

pipe = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
image = Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8))
inputs = InferenceInput(start=PromptInput(prompt="a", seed=1), end=PromptInput(prompt="b", seed=2),
                        alpha=0.5, num_inference_steps=2)
out, audio = pipe.riffuse_audio(inputs, image, params=SpectrogramParams(num_frequencies=64))
assert out.size == (64, 64) and audio.duration_seconds > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("LOADED", bad)
"""


def test_port_runs_without_jax():
    # one intra-op thread, as tests/torch_port_util.py gives the in-process tests
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_sources_import_no_jax_and_no_library_attention():
    imports = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile")
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) > 10
    for path in sources:
        text = path.read_text()
        assert not imports.search(text), path
        assert not banned.search(text), path
