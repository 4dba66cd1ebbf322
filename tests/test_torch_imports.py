"""
The port never imports jax, flax or the JAX package (riffusion_tpu), not
even its modules that are free of JAX, nor the weight-file libraries the
card machine lacks (safetensors, msgpack, transformers): a fresh
interpreter imports every riffusion_tpu_torch module (serving and server
among them), runs the tiny slice on the CPU, single and batched, then a
fine-tune of two steps with its export reloaded, and checks sys.modules.
Also a static check that no source of the port, nor chip_smoke.py or
scripts/profile_torch_request.py, imports them, and that the port calls no
library attention or compiler.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "riffusion_tpu_torch"
BANNED_IMPORTS = {"jax", "jaxlib", "flax", "riffusion_tpu", "safetensors", "msgpack",
                  "transformers"}

_PROGRAM = r"""
import importlib, pkgutil, sys
import numpy as np
from PIL import Image
import riffusion_tpu_torch
for mod in pkgutil.walk_packages(riffusion_tpu_torch.__path__, "riffusion_tpu_torch."):
    importlib.import_module(mod.name)

from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

pipe = RiffusionPipeline.load_checkpoint("random:tiny", device="cpu")
image = Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8))
inputs = InferenceInput(start=PromptInput(prompt="a", seed=1), end=PromptInput(prompt="b", seed=2),
                        alpha=0.5, num_inference_steps=2)
params = SpectrogramParams(num_frequencies=64)
out, audio = pipe.riffuse_audio(inputs, image, params=params)
assert out.size == (64, 64) and audio.duration_seconds > 0
# the batched path, through the server module's batcher
from riffusion_tpu_torch.server import DynamicBatcher
batcher = DynamicBatcher(pipe, window_ms=10, scheduler="unipc_k:rho=2")
out, audio = batcher.submit(inputs, image, None, params, seed_image_id="s", mask_image_id=None)
batcher.shutdown()
assert len(pipe.riffuse_audio_batch([inputs, inputs], image, params=params)) == 2
# the training slice: dataset, two steps, the export reloaded and riffused
import tempfile
from pathlib import Path
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    (tmp / "audio").mkdir()
    wave = np.sin(np.arange(44100) * 2 * np.pi * 440 / 44100) * 16000
    AudioSegment(wave.astype(np.int16), 44100).export(str(tmp / "audio" / "a.wav"))
    build_latent_dataset(pipe, tmp / "audio", tmp / "ds", params=params, clip_duration_ms=640)
    stats = run_finetune(FinetuneConfig(checkpoint="random:tiny", dataset_dir=str(tmp / "ds"),
                                        output_dir=str(tmp / "run"), steps=2, batch_size=1,
                                        device="cpu"), log=lambda s: None)
    tuned = RiffusionPipeline.load_checkpoint(stats["export_dir"], device="cpu")
    assert tuned.riffuse(inputs, image).size == (64, 64)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "riffusion_tpu", "safetensors",
                                    "msgpack", "transformers"))
print("LOADED", bad)
"""


def test_port_runs_without_jax():
    # one intra-op thread, as tests/torch_port_util.py gives the in-process tests
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _imported_top_levels(source: str) -> set:
    """The first dotted part of every module an import statement names."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_no_library_attention():
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile")
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) > 10
    for path in sources + [REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_request.py"]:
        text = path.read_text()
        # the top-level name exactly: riffusion_tpu_torch is the port itself
        assert not _imported_top_levels(text) & BANNED_IMPORTS, path
        if path.is_relative_to(PACKAGE):
            assert not banned.search(text), path
    assert _imported_top_levels("from riffusion_tpu.datatypes import InferenceInput\n"
                                "import riffusion_tpu.serving as s\n") == {"riffusion_tpu"}
    assert _imported_top_levels("from riffusion_tpu_torch import cli\n") == {"riffusion_tpu_torch"}
