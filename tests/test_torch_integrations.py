"""
The port's deployment shims and conversion script against the JAX
package's, on random:tiny on the CPU:

- the Cog predictor (riffusion_tpu_torch/integrations/cog_riffusion.py)
  and the Baseten Model (.../baseten.py) hand a recording pipeline the
  same InferenceInput as the JAX shims (integrations/), field by field,
  with Python's `random` seeded alike (the Cog seeds) and MODEL_ID / the
  checkpoint pointed at random:tiny;
- one real CPU run of each port shim: the Cog predictor's wav and jpeg
  paths, the image's size and the audio's length; the Baseten Model's
  prediction and its error entry for a malformed instance;
- scripts/convert_checkpoint_torch.py, run through runpy on
  test_checkpoint_fixture.py's tiny diffusers directory: the export reloads
  bit-equal to loading the source directory, with the tokenizer files
  copied.
"""

import dataclasses
import json
import random
import runpy
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_checkpoint_fixture import tiny_diffusers_checkpoint  # noqa: F401  (fixture)
from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu_torch.integrations import baseten, cog_riffusion
from riffusion_tpu_torch.models import weights

REPO = Path(__file__).resolve().parent.parent


class RecordingPipeline:
    """Records the InferenceInput each call hands on and returns a small
    gray image (and, for riffuse_audio, one second of silence in the
    package's own AudioSegment)."""

    device = "cpu"

    def __init__(self, segment_cls):
        self.calls = []
        self.segment_cls = segment_cls

    def riffuse(self, inputs, init_image=None, mask_image=None, **kw):
        self.calls.append(dataclasses.asdict(inputs))
        image = Image.new("RGB", (64, 64), (128, 128, 128))
        image.save = lambda *a, **k: None  # the JAX shim writes under /tmp
        return image

    def riffuse_audio(self, inputs, init_image=None, mask_image=None, **kw):
        self.calls.append(dataclasses.asdict(inputs))
        return (Image.new("RGB", (64, 64), (128, 128, 128)),
                self.segment_cls(np.zeros(44100, np.int16), 44100))


class SilentConverter:
    """Stands in for SpectrogramImageConverter in the recording test (the
    audio is not what it checks)."""

    def __init__(self, segment_cls):
        self.segment_cls = segment_cls

    def __call__(self, params=None, device=None):
        return self

    def audio_from_spectrogram_image(self, image):
        segment = self.segment_cls(np.zeros(4410, np.int16), 44100)
        segment.export = lambda *a, **k: None  # the JAX shim writes under /tmp
        return segment


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    """Outputs of the Cog shims go to this test's directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return tmp_path


PREDICTIONS = [
    dict(prompt_a="funky synth solo", num_inference_steps=3, seed_image_id="og_beat"),
    dict(prompt_a="church bells", prompt_b="techno", alpha=0.3, denoising=0.6,
         num_inference_steps=4, seed_image_id="vibes"),
]


def test_cog_predictors_hand_on_the_same_inputs(in_tmp, monkeypatch):
    from integrations import cog_riffusion as jax_cog
    from riffusion_tpu.audio.segment import AudioSegment as JaxSegment
    from riffusion_tpu_torch.audio.segment import AudioSegment

    calls = []
    for module, segment_cls in ((jax_cog, JaxSegment), (cog_riffusion, AudioSegment)):
        monkeypatch.setattr(module, "SpectrogramImageConverter", SilentConverter(segment_cls))
        predictor = module.RiffusionPredictor()
        predictor.model = RecordingPipeline(segment_cls)
        for kwargs in PREDICTIONS:
            random.seed(1234)
            out = predictor.predict(**{"prompt_b": None, "alpha": 0.5, "denoising": 0.75,
                                       **kwargs})
            assert Path(out["audio"]).suffix == ".wav"
            assert Path(out["spectrogram"]).suffix == ".jpeg"
        calls.append(predictor.model.calls)
    theirs, ours = calls
    assert ours == theirs
    assert ours[0]["alpha"] == 0.0 and ours[0]["end"]["prompt"] == "funky synth solo"
    assert ours[1]["alpha"] == 0.3 and ours[1]["start"]["denoising"] == 0.6
    assert ours[0]["start"]["seed"] != ours[0]["end"]["seed"]  # random seeds, drawn alike


def test_cog_predictor_runs_on_the_cpu(in_tmp, monkeypatch):
    """setup() loads MODEL_ID (random:tiny here) on DEVICE with JAX's
    local_files_only; predict() writes a wav of 5.11 s and a 512x512 jpeg."""
    from riffusion_tpu_torch.audio.segment import AudioSegment

    monkeypatch.setattr(cog_riffusion, "MODEL_ID", "random:tiny")
    monkeypatch.setattr(cog_riffusion, "DEVICE", "cpu")
    assert cog_riffusion.RiffusionPredictor.__mro__[1].__name__ == "BasePredictor"
    predictor = cog_riffusion.RiffusionPredictor()
    predictor.setup(local_files_only=True)
    random.seed(0)
    out = predictor.predict(prompt_a="church bells", prompt_b=None, alpha=0.5, denoising=0.75,
                            num_inference_steps=2, seed_image_id="og_beat")
    assert Path(out["audio"]).parent == in_tmp and Path(out["audio"]).exists()
    with Image.open(out["spectrogram"]) as image:
        assert image.size == (512, 512) and image.format == "JPEG"
    segment = AudioSegment.from_file(str(out["audio"]))
    assert abs(segment.duration_seconds - 5.11) < 0.02


def _instances():
    return [
        {"start": {"prompt": "church bells", "seed": 7}, "end": {"prompt": "techno", "seed": 8},
         "alpha": 0.25, "num_inference_steps": 2, "seed_image_id": "og_beat"},
        {"start": {"prompt": "jazz", "seed": 1, "denoising": 0.6},
         "end": {"prompt": "rain", "seed": 2}, "alpha": 0.5, "num_inference_steps": 3,
         "seed_image_id": "vibes"},
        {"start": {"prompt": "x"}, "alpha": "not a number"},
    ]


def test_baseten_models_hand_on_the_same_inputs():
    from integrations import baseten as jax_baseten
    from riffusion_tpu.audio.segment import AudioSegment as JaxSegment
    from riffusion_tpu_torch.audio.segment import AudioSegment

    outs, calls = [], []
    for module, segment_cls in ((jax_baseten, JaxSegment), (baseten, AudioSegment)):
        model = module.Model(config={"seed_images_dir": str(REPO / "seed_images")})
        model._pipeline = RecordingPipeline(segment_cls)
        outs.append(model.predict({"instances": _instances()})["predictions"])
        model.predict(_instances()[1])  # a bare request is one instance
        calls.append(model._pipeline.calls)
    assert calls[0] == calls[1] and len(calls[1]) == 3 and calls[1][2] == calls[1][1]
    theirs, ours = outs
    assert "error" in ours[2] and "error" in theirs[2]
    for a, b in zip(ours[:2], theirs[:2]):
        assert json.loads(a).keys() == json.loads(b).keys()


def test_baseten_model_runs_on_the_cpu():
    """load() takes the checkpoint and device of the config (cuda unless it
    says otherwise); predict() serves each instance through the port's
    compute_request and gives a malformed one its error entry."""
    model = baseten.Model(config={"checkpoint": "random:tiny", "device": "cpu"})
    with pytest.raises(RuntimeError, match="load"):
        model.predict({})
    model.load()
    assert model._pipeline.device == torch.device("cpu")
    predictions = model.predict({"instances": [_instances()[0], _instances()[2]]})["predictions"]
    out = json.loads(predictions[0])
    assert abs(out["duration_s"] - 5.11) < 0.02 and out["image"].startswith("data:image/jpeg")
    assert out["audio"].startswith("data:audio/")
    assert set(predictions[1]) == {"error"}


def test_baseten_model_defaults(monkeypatch):
    """Without a config: riffusion/riffusion-model-v1 on cuda, as the JAX
    Model loads it on its accelerator."""
    seen = []
    monkeypatch.setattr(baseten.RiffusionPipeline, "load_checkpoint",
                        classmethod(lambda cls, **kw: seen.append(kw) or "pipe"))
    model = baseten.Model()
    model.load()
    assert seen == [{"checkpoint": "riffusion/riffusion-model-v1", "device": "cuda"}]
    assert model._seed_images_dir == REPO / "seed_images"


def test_convert_checkpoint_script(tiny_diffusers_checkpoint, tmp_path, monkeypatch):  # noqa: F811
    """scripts/convert_checkpoint_torch.py through runpy: a native export
    that loads bit-equal to the source directory, its sampler kept and the
    tokenizer files copied beside it."""
    root, _ = tiny_diffusers_checkpoint
    out = tmp_path / "converted"
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint_torch.py", str(root), str(out)])
    runpy.run_path(str(REPO / "scripts" / "convert_checkpoint_torch.py"), run_name="__main__")
    assert (out / weights.NATIVE_META).exists() and (out / "unet.pt").exists()
    for name in ("vocab.json", "merges.txt"):
        assert (out / name).read_bytes() == (Path(root) / "tokenizer" / name).read_bytes()
    source = weights.load_bundle(str(root), device="cpu")
    converted = weights.load_bundle(str(out), device="cpu")
    assert converted.scheduler_name == source.scheduler_name
    assert type(converted.tokenizer).__name__ == "CLIPTokenizer"
    for a, b in ((source.unet, converted.unet), (source.vae, converted.vae),
                 (source.text_encoder, converted.text_encoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for key in sa:
            assert sa[key].dtype == sb[key].dtype and torch.equal(sa[key], sb[key]), key
