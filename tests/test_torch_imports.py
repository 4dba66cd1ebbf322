"""
The port never imports jax, flax or the JAX package (riffusion_tpu), not
even its modules that are free of JAX, nor the libraries the card machine
lacks (safetensors, msgpack, transformers, ml_dtypes): a fresh
interpreter imports every riffusion_tpu_torch module (serving and server
among them), runs the tiny slice on the CPU, single and batched, then a
fine-tune of two steps with its export reloaded, and checks sys.modules;
another runs the command line and the embedding disk cache.
A third drives the playground's modules, the audio engine, the stem
splitter and fft_util with an import hook that records every attempt to
import JAX or the JAX package (none may be made).
Also a static check that no source of the port, nor chip_smoke.py,
imports them, that the port calls no
library attention or compiler, and that no module of the port imports
streamlit at module level (the playground imports it inside render()).
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
                  "transformers", "ml_dtypes"}

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
                                    "msgpack", "transformers", "ml_dtypes"))
print("LOADED", bad)
"""

_CLI_PROGRAM = r"""
import os, sys, tempfile
import numpy as np
import torch
from riffusion_tpu_torch import cli, embed_cache
from riffusion_tpu_torch.audio.segment import AudioSegment
with tempfile.TemporaryDirectory() as tmp:
    os.environ["RIFFUSION_TPU_EMBED_CACHE_DIR"] = tmp
    key = embed_cache.entry_key("random:tiny:s0:bfloat16", torch.bfloat16, "plain", "x",
                                device="cpu")
    embed_cache.put(key, torch.ones(1, 3, 4, dtype=torch.bfloat16))
    assert embed_cache.get(key).dtype == torch.bfloat16
    wave = np.sin(np.arange(22050) * 2 * np.pi * 440 / 44100) * 16000
    AudioSegment(wave.astype(np.int16), 44100).export(os.path.join(tmp, "a.wav"))
    cli.main(["audio-to-image", "--audio", os.path.join(tmp, "a.wav"),
              "--image", os.path.join(tmp, "a.png"), "--num-frequencies", "64",
              "--device", "cpu"])
    cli.main(["print-exif", "--image", os.path.join(tmp, "a.png")])
    cli.main(["text-to-audio", "--prompt", "x", "--audio", os.path.join(tmp, "t.wav"),
              "--num-inference-steps", "1", "--width", "64", "--checkpoint", "random:tiny",
              "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "riffusion_tpu", "ml_dtypes"))
print("LOADED", bad)
"""


_FRONTENDS_PROGRAM = r"""
import sys
attempts = []


class Spy:
    # records each import of JAX or the JAX package that is tried
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "riffusion_tpu"):
            attempts.append(name)
        return None


sys.meta_path.insert(0, Spy())
import importlib, os, pkgutil, tempfile
import numpy as np
import riffusion_tpu_torch
for mod in pkgutil.walk_packages(riffusion_tpu_torch.__path__, "riffusion_tpu_torch."):
    importlib.import_module(mod.name)
from riffusion_tpu_torch.audio import native
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.audio_splitter import AudioSplitter
from riffusion_tpu_torch.streamlit import util
from riffusion_tpu_torch.streamlit.tasks import audio_to_audio, interpolation, text_to_audio_batch
from riffusion_tpu_torch.util import fft_util
wave = (np.sin(np.arange(22050)[:, None] * 2 * np.pi * 440 / 48000) * 9000).astype(np.int16)
segment = AudioSegment(np.repeat(wave, 2, 1), 48000).set_frame_rate(44100)
segment = segment.append(segment, crossfade=50)
native.compress_dynamic_range_int16(segment.raw_data, 44100)
assert len(AudioSplitter(device="cpu").split(segment)) == 4
fft_util.compute_fft(segment)
audio_to_audio.slice_audio_into_clips(segment, audio_to_audio.clip_start_times(12.0))
interpolation.shaped_alphas(4, 2.0)
with tempfile.TemporaryDirectory() as tmp:
    manifest = text_to_audio_batch.run_batch(
        {"params": {"num_inference_steps": 1, "width": 64, "checkpoint": "random:tiny"},
         "entries": [{"prompt": "a"}, {"prompt": "b", "seed": 3}]}, device="cpu", output_dir=tmp)
    assert len(manifest) == 2 and os.path.exists(os.path.join(tmp, "index.json"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "riffusion_tpu", "streamlit"))
print("LOADED", bad)
print("TRIED", sorted(set(attempts)))
"""


def test_frontends_run_without_jax_or_streamlit():
    """The playground's modules, imported and driven in a fresh interpreter
    (the engine, the splitter, fft_util, the restyle helpers, the batch page
    on random:tiny), neither load nor try to import JAX or the JAX package,
    and load no streamlit (util only asks whether it is installed)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _FRONTENDS_PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout and "TRIED []" in proc.stdout, proc.stdout


def test_no_streamlit_import_at_module_level():
    """streamlit is optional: the port imports it only inside functions."""
    sources = sorted(PACKAGE.rglob("*.py"))
    assert PACKAGE / "streamlit" / "playground.py" in sources
    for path in sources:
        tree = ast.parse(path.read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                top.update(alias.name.split(".")[0] for alias in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                top.add(node.module.split(".")[0])
        assert "streamlit" not in top, path


def test_port_runs_without_jax():
    # one intra-op thread, as tests/torch_port_util.py gives the in-process tests
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_cli_and_embed_cache_run_without_jax():
    """cli.py and embed_cache.py, driven in a fresh interpreter (a DSP
    command, print-exif, text-to-audio, a cache round trip in bf16), load
    neither JAX, the JAX package nor ml_dtypes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CLI_PROGRAM], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
    for name in ("cli.py", "embed_cache.py"):
        assert not _imported_top_levels((PACKAGE / name).read_text()) & BANNED_IMPORTS, name


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
    for path in sources + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        # the top-level name exactly: riffusion_tpu_torch is the port itself
        assert not _imported_top_levels(text) & BANNED_IMPORTS, path
        if path.is_relative_to(PACKAGE):
            assert not banned.search(text), path
    assert _imported_top_levels("from riffusion_tpu.datatypes import InferenceInput\n"
                                "import riffusion_tpu.serving as s\n") == {"riffusion_tpu"}
    assert _imported_top_levels("from riffusion_tpu_torch import cli\n") == {"riffusion_tpu_torch"}
