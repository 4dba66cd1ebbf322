"""
Every page of the port's playground (riffusion_tpu_torch/streamlit/) and its
router rendered through the in-repo streamlit stub (tests/st_stub.py), so a
crash in any render path fails the suite without streamlit installed: the
first paint of each page with "Device: cpu" and random:tiny, the router on
each page, and the deep paths (a prompt filled in, a file uploaded) that run
the tiny model, the converters and the splitter on the CPU. Each deep path
must reach the audio player with non-silent audio.
"""

import importlib
import io
import json
import sys

import numpy as np
import pytest

import st_stub
from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.streamlit.playground import PAGES as JAX_PAGES
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.streamlit import util as streamlit_util  # before any stub
from riffusion_tpu_torch.streamlit.playground import PAGES

_BASE_VALUES = {
    "Device": "cpu",
    "Output format": "wav",
    "Custom Checkpoint": "random:tiny",
}


@pytest.fixture()
def played(monkeypatch):
    """random:tiny as the default checkpoint; the audio the pages hand to
    the player, recorded as (name, segment)."""
    monkeypatch.setattr(streamlit_util, "DEFAULT_CHECKPOINT", "random:tiny")
    shown = []
    monkeypatch.setattr(streamlit_util, "display_and_download_audio",
                        lambda segment, name, extension="mp3": shown.append((name, segment)))
    yield shown
    streamlit_util.load_riffusion_checkpoint.cache_clear()


def _render(module_name, values=None):
    """Install the stub, import the page, run render()."""
    stub = st_stub.StreamlitStub(values=values)
    old = sys.modules.get("streamlit")
    sys.modules["streamlit"] = stub
    try:
        importlib.import_module(module_name).render()
    finally:
        if old is not None:
            sys.modules["streamlit"] = old
        else:
            sys.modules.pop("streamlit", None)
    return stub


def _assert_played(shown, names):
    assert [name for name, _ in shown] == names
    for name, segment in shown:
        assert segment.frame_count > 0 and np.abs(segment.raw_data.astype(int)).max() > 100, name


def test_pages_are_the_jax_pages():
    assert list(PAGES) == list(JAX_PAGES)
    assert all(PAGES[t] == JAX_PAGES[t].replace("riffusion_tpu.", "riffusion_tpu_torch.")
               for t in PAGES)


@pytest.mark.parametrize("title,module", sorted(PAGES.items()))
def test_page_first_paint_via_stub(title, module, played):
    _render(module, values=dict(_BASE_VALUES))
    assert played == []


@pytest.mark.parametrize("title", sorted(PAGES))
def test_router_via_stub(title, played):
    _render("riffusion_tpu_torch.streamlit.playground", values={**_BASE_VALUES, "Page": title})


# ------------------------------------------------------------- deep paths


def _wav_upload(duration_s=1.0, name="in.wav", channels=1):
    sr = 44100
    t = np.arange(int(duration_s * sr)) / sr
    wave = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    buf = io.BytesIO()
    AudioSegment.from_float(np.repeat(wave[None], channels, 0), sr).export(buf, format="wav")
    buf.seek(0)
    buf.name = name
    return buf


def test_text_to_audio_deep(played):
    """txt2img -> spectrogram -> audio through the page, two clips."""
    _render("riffusion_tpu_torch.streamlit.tasks.text_to_audio",
            values={**_BASE_VALUES, "Prompt": "piano", "Steps": 2, "Width": 64,
                    "Number of clips": 2, "Guidance": 1.5})
    _assert_played(played, ["piano_42", "piano_43"])


def test_text_to_audio_batch_deep(played, tmp_path):
    spec = {
        "params": {"num_inference_steps": 2, "width": 64, "checkpoint": "random:tiny"},
        "entries": [{"prompt": "piano", "seed": 3}, {"prompt": "drums"}],
    }
    buf = io.BytesIO(json.dumps(spec).encode())
    buf.name = "batch.json"
    _render("riffusion_tpu_torch.streamlit.tasks.text_to_audio_batch",
            values={**_BASE_VALUES, "Upload JSON": buf,
                    "Output directory (optional)": str(tmp_path / "out")})
    index = json.loads((tmp_path / "out" / "index.json").read_text())
    assert [r["prompt"] for r in index] == ["piano", "drums"]
    _assert_played(played, ["batch_0", "batch_1"])


def test_image_to_audio_deep(played):
    """An uploaded spectrogram PNG with its EXIF params -> audio."""
    from riffusion_tpu_torch.spectrogram_image_converter import SpectrogramImageConverter
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    converter = SpectrogramImageConverter(SpectrogramParams(num_frequencies=64), device="cpu")
    image = converter.spectrogram_image_from_audio(AudioSegment.from_file(_wav_upload()))
    buf = io.BytesIO()
    image.save(buf, exif=image.getexif(), format="PNG")
    buf.seek(0)
    buf.name = "spec.png"
    _render("riffusion_tpu_torch.streamlit.tasks.image_to_audio",
            values={**_BASE_VALUES, "Upload a spectrogram image": buf})
    _assert_played(played, ["image_to_audio"])
    assert abs(played[0][1].duration_seconds - 1.0) < 0.02


def test_sample_clips_deep(played):
    _render("riffusion_tpu_torch.streamlit.tasks.sample_clips",
            values={**_BASE_VALUES, "Upload audio": _wav_upload(duration_s=2.0),
                    "Number of clips": 2, "Duration (ms)": 500, "Seed": 4,
                    "Compute spectrograms": True})
    assert len(played) == 2 and all(abs(s.duration_ms - 500) < 2 for _, s in played)


def test_split_audio_deep(played):
    _render("riffusion_tpu_torch.streamlit.tasks.split_audio",
            values={**_BASE_VALUES, "Upload audio": _wav_upload(duration_s=1.0, channels=2)})
    names = [name for name, _ in played]
    assert sorted(names[:4]) == ["bass", "drums", "other", "vocals"]
    assert names[4:] == ["recombined"]


def test_audio_to_audio_deep(played):
    """A 1 s upload restyled in img2img mode: one 5 s clip (padded) through
    img2img on the tiny model and back to audio."""
    _render("riffusion_tpu_torch.streamlit.tasks.audio_to_audio",
            values={**_BASE_VALUES, "Upload audio": _wav_upload(duration_s=1.0),
                    "Prompt": "lofi", "Steps": 2})
    _assert_played(played, ["audio_to_audio"])
    assert abs(played[0][1].duration_seconds - 5.0) < 0.02


def test_interpolation_deep(played):
    """One frame of the walk (both prompts filled) from og_beat through the
    batched program and its fused audio tail."""
    _render("riffusion_tpu_torch.streamlit.tasks.interpolation",
            values={**_BASE_VALUES, "Prompt": "lofi", "Interpolation steps": 1,
                    "Inference steps": 2})
    _assert_played(played, ["interpolation"])
    assert abs(played[0][1].duration_seconds - 5.11) < 0.02
