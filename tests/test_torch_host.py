"""
The port's own copies of the JAX package's host modules against their
originals: spectrogram_params, datatypes, audio/segment, util/audio_util
(apply_filters, stitch_segments, overlay_segments),
util/base64_util, util/dataclass_util, models/tokenizer and serving. The
port imports none of the JAX package (tests/test_torch_imports.py), so each
copy is held here to the module it was copied from, on the same inputs.

Both packages' AudioSegment and apply_filters reach a C++ audio engine
(the same source; tests/test_torch_native.py holds the two engines bit-equal).
The comparisons here hold the engine's numpy versions instead: the port's,
asked for with RIFFUSION_TPU_TORCH_NO_NATIVE=1, against the JAX package's
fallbacks, where the two must agree exactly.
"""

import dataclasses
import io
import json
import threading

import numpy as np
import pytest
from PIL import Image

from torch_port_util import jax_twin
from riffusion_tpu import datatypes as jax_datatypes
from riffusion_tpu import serving as jax_serving
from riffusion_tpu import spectrogram_params as jax_params
from riffusion_tpu.audio import native as jax_native
from riffusion_tpu.audio import segment as jax_segment
from riffusion_tpu.models import tokenizer as jax_tokenizer
from riffusion_tpu.util import audio_util as jax_audio_util
from riffusion_tpu.util import base64_util as jax_base64_util
from riffusion_tpu.util import dataclass_util as jax_dataclass_util
from riffusion_tpu_torch import datatypes, serving, spectrogram_params
from riffusion_tpu_torch.audio import segment
from riffusion_tpu_torch.models import tokenizer
from riffusion_tpu_torch.util import audio_util, base64_util, dataclass_util

SR = 44100


@pytest.fixture
def jax_numpy_audio(monkeypatch):
    """Both packages' audio helpers on their numpy versions: the JAX
    package's fallbacks, the port's on request."""
    monkeypatch.setattr(jax_native, "_load_lib", lambda: None)
    monkeypatch.setenv("RIFFUSION_TPU_TORCH_NO_NATIVE", "1")


@pytest.mark.parametrize("name", ["PromptInput", "InferenceInput", "InferenceOutput",
                                  "SpectrogramParams"])
def test_dataclass_fields_and_defaults_match(name):
    module, jax_module = ((spectrogram_params, jax_params) if name == "SpectrogramParams"
                          else (datatypes, jax_datatypes))
    ours, theirs = getattr(module, name), getattr(jax_module, name)
    describe = [(f.name, str(f.type), f.default) for f in dataclasses.fields(ours)]
    assert describe == [(f.name, str(f.type), f.default) for f in dataclasses.fields(theirs)]
    assert ours.__dataclass_params__.frozen and theirs.__dataclass_params__.frozen


def test_spectrogram_params_derived_values_and_exif_round_trip():
    for kw in ({}, {"stereo": True, "num_frequencies": 64, "step_size_ms": 20,
                    "power_for_image": 0.5, "max_frequency": 8000}):
        ours, theirs = spectrogram_params.SpectrogramParams(**kw), jax_params.SpectrogramParams(**kw)
        assert (ours.n_fft, ours.win_length, ours.hop_length) == \
            (theirs.n_fft, theirs.win_length, theirs.hop_length)
        assert ours.to_exif() == theirs.to_exif()
        # through a PNG's EXIF, read back by each package from the other's tags
        image = Image.new("RGB", (8, 8))
        exif = image.getexif()
        exif.update(ours.to_exif().items())
        buf = io.BytesIO()
        image.save(buf, format="PNG", exif=exif)
        tags = dict(Image.open(io.BytesIO(buf.getvalue())).getexif())
        assert spectrogram_params.SpectrogramParams.from_exif(tags) == ours
        assert jax_params.SpectrogramParams.from_exif(tags) == theirs
    assert [(t.name, t.value) for t in spectrogram_params.SpectrogramParams.ExifTags] == \
        [(t.name, t.value) for t in jax_params.SpectrogramParams.ExifTags]
    with pytest.raises(KeyError):
        spectrogram_params.SpectrogramParams.from_exif({})


_PAYLOADS = {
    "valid": {"start": {"prompt": "a", "seed": 1}, "end": {"prompt": "b", "seed": 2,
              "guidance": 3}, "alpha": 0.25, "mask_image_id": None},
    "unknown field": {"start": {"prompt": "a", "seed": 1}, "end": {"prompt": "b", "seed": 2},
                      "alpha": 0.5, "extra": 1},
    "missing field": {"start": {"prompt": "a", "seed": 1}, "end": {"prompt": "b", "seed": 2}},
    "wrong type": {"start": {"prompt": "a", "seed": "1"}, "end": {"prompt": "b", "seed": 2},
                   "alpha": 0.5},
    "bool for a number": {"start": {"prompt": "a", "seed": 1}, "end": {"prompt": "b", "seed": 2},
                          "alpha": True},
    "null not allowed": {"start": {"prompt": "a", "seed": 1}, "end": {"prompt": "b", "seed": 2},
                         "alpha": None},
    "not an object": [1, 2],
}


@pytest.mark.parametrize("case", list(_PAYLOADS))
def test_from_dict_decodes_and_rejects_as_the_original(case):
    payload = _PAYLOADS[case]

    def decode(util, module):
        try:
            return "ok", dataclasses.asdict(util.from_dict(module.InferenceInput, payload))
        except util.DecodeError as e:
            return "error", str(e)

    ours = decode(dataclass_util, datatypes)
    assert ours == decode(jax_dataclass_util, jax_datatypes)
    assert ours[0] == ("ok" if case == "valid" else "error")


def _bpe_files(root):
    """A small CLIP-style vocabulary and merge list."""
    chars = sorted(set("abcdefghijklmnopqrstuvwxyz!,.'0123456789"))
    merges = [("c", "h"), ("ch", "u"), ("r", "c"), ("b", "e"), ("l", "l"), ("be", "ll"),
              ("s</w>", "x"), ("t", "e"), ("te", "c"), ("h", "n"), ("o", "</w>")]
    vocab = {}
    for token in chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]:
        vocab.setdefault(token, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))


def test_tokenizer_ids_match(tmp_path):
    texts = ["church bells", "  Techno   beat!! ", "a (loud:1.5) [quiet]", "x " * 100, "",
             "ünïcode café &amp; 42"]
    hashed = tokenizer.HashTokenizer(vocab_size=1024)
    jax_hashed = jax_tokenizer.HashTokenizer(vocab_size=1024)
    _bpe_files(tmp_path)
    bpe = tokenizer.CLIPTokenizer.from_pretrained(str(tmp_path))
    jax_bpe = jax_tokenizer.CLIPTokenizer.from_pretrained(str(tmp_path))
    for ours, theirs in ((hashed, jax_hashed), (bpe, jax_bpe)):
        for text in texts:
            assert ours.encode(text) == theirs.encode(text)
        assert ours(texts) == theirs(texts)
        assert ours(texts[0], max_length=5) == theirs(texts[0], max_length=5)
    assert bpe.encode("church bells") != hashed.encode("church bells")
    with pytest.raises(FileNotFoundError):
        tokenizer.CLIPTokenizer.from_pretrained(str(tmp_path / "missing"))


def _wave(channels=2, seconds=0.3, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 330 * t)[None]
            + 0.05 * rng.standard_normal((channels, t.size))).astype(np.float32)


def test_audio_segment_matches_the_original(jax_numpy_audio, tmp_path):
    for normalize in (False, True):
        ours = segment.AudioSegment.from_float(_wave() * 20000, SR, normalize=normalize)
        theirs = jax_segment.AudioSegment.from_float(_wave() * 20000, SR, normalize=normalize)
        np.testing.assert_array_equal(ours.raw_data, theirs.raw_data)
    other = segment.AudioSegment.from_float(_wave(seed=1) * 9000, SR)
    jax_other = jax_segment.AudioSegment.from_float(_wave(seed=1) * 9000, SR)
    pairs = {
        "gain": (ours.apply_gain(-7.5), theirs.apply_gain(-7.5)),
        "slice": (ours[50:210], theirs[50:210]),
        "negative slice": (ours[-100:], theirs[-100:]),
        "mono": (ours.set_channels(1), theirs.set_channels(1)),
        "stereo from mono": (ours.set_channels(1).set_channels(2),
                             theirs.set_channels(1).set_channels(2)),
        "resample": (ours.set_frame_rate(22050), theirs.set_frame_rate(22050)),
        "crossfade": (ours.append(other, crossfade=40), theirs.append(jax_other, crossfade=40)),
        "concat": (ours + other, theirs + jax_other),
        "overlay": (ours.overlay(other, position_ms=100), theirs.overlay(jax_other, position_ms=100)),
        "fades": (ours.fade_in(30).fade_out(50), theirs.fade_in(30).fade_out(50)),
    }
    for name, (a, b) in pairs.items():
        assert a.frame_rate == b.frame_rate, name
        np.testing.assert_array_equal(a.raw_data, b.raw_data, err_msg=name)
    assert (ours.dBFS, ours.max_dBFS, len(ours), ours.duration_seconds) == \
        (theirs.dBFS, theirs.max_dBFS, len(theirs), theirs.duration_seconds)
    wav = ours.export(format="wav").read()
    assert wav == theirs.export(format="wav").read()
    path = tmp_path / "x.wav"
    ours.export(str(path)).close()
    np.testing.assert_array_equal(segment.AudioSegment.from_file(str(path)).raw_data,
                                  jax_segment.AudioSegment.from_file(str(path)).raw_data)
    np.testing.assert_array_equal(segment.AudioSegment.from_file(io.BytesIO(wav)).raw_data,
                                  ours.raw_data)
    assert segment._ffmpeg_path() == jax_segment._ffmpeg_path()


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "compressed"])
def test_apply_filters_matches_the_original(jax_numpy_audio, compression):
    wave = _wave(seconds=0.1) * np.linspace(0.05, 1.0, int(0.1 * SR))[None]
    ours = audio_util.audio_from_waveform(wave, SR, normalize=True)
    theirs = jax_audio_util.audio_from_waveform(wave, SR, normalize=True)
    np.testing.assert_array_equal(ours.raw_data, theirs.raw_data)
    np.testing.assert_array_equal(
        audio_util.apply_filters(ours, compression=compression).raw_data,
        jax_audio_util.apply_filters(theirs, compression=compression).raw_data,
    )
    if not compression:  # both packages' compressor turns silence into NaN gain
        silent = segment.AudioSegment.silent(10, SR)
        assert audio_util.apply_filters(silent).dBFS == -float("inf")


@pytest.mark.parametrize("crossfade_s", [0.0, 0.04], ids=["butt", "crossfade"])
def test_stitch_and_overlay_segments_match_the_original(jax_numpy_audio, crossfade_s):
    """Three clips stitched with a crossfade (the stream command's track),
    and mixed on top of one another."""
    ours = [segment.AudioSegment.from_float(_wave(seed=i) * 9000, SR) for i in range(3)]
    theirs = [jax_segment.AudioSegment.from_float(_wave(seed=i) * 9000, SR) for i in range(3)]
    stitched = audio_util.stitch_segments(ours, crossfade_s=crossfade_s)
    np.testing.assert_array_equal(
        stitched.raw_data, jax_audio_util.stitch_segments(theirs, crossfade_s=crossfade_s).raw_data)
    assert abs(stitched.duration_seconds - (3 * ours[0].duration_seconds - 2 * crossfade_s)) < 1e-3
    short = [ours[0], ours[1][:120], ours[2][50:]]
    jax_short = [theirs[0], theirs[1][:120], theirs[2][50:]]
    mixed = audio_util.overlay_segments(short)
    np.testing.assert_array_equal(mixed.raw_data,
                                  jax_audio_util.overlay_segments(jax_short).raw_data)
    assert len(mixed) == len(ours[0])
    with pytest.raises(ValueError, match="at least one segment"):
        audio_util.overlay_segments([])


def test_base64_encode_matches_the_original():
    buf = io.BytesIO(bytes(range(256)) * 3)
    assert base64_util.encode(buf) == jax_base64_util.encode(buf)


class _Recorder:
    """A pipeline stand-in that records each launch and answers at once."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def riffuse_audio(self, inputs, **kw):
        with self.lock:
            self.calls.append(("single", kw["scheduler"], inputs.num_inference_steps))
        return "image", "segment"

    def riffuse_audio_batch(self, inputs_list, **kw):
        with self.lock:
            self.calls.append(("batch", len(inputs_list), kw["scheduler"],
                               inputs_list[0].num_inference_steps))
        return [("image", "segment")] * len(inputs_list)


def _drive(module, make_inputs, strengths):
    rec = _Recorder()
    batcher = module.DynamicBatcher(rec, max_batch=8, window_ms=1000, scheduler="unipc_k:rho=2",
                                    steps_override=16, strength_gated=True)
    threads = [
        threading.Thread(target=batcher.submit,
                         args=(make_inputs(i, s), None, None, None, "og_beat", None))
        for i, s in enumerate(strengths)
    ]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.shutdown()
    return sorted(rec.calls, key=str), dict(batcher.stats)


def test_batcher_buckets_and_presets_match_the_original():
    def port_inputs(i, strength):
        return datatypes.InferenceInput(
            start=datatypes.PromptInput(prompt="a", seed=i, denoising=strength),
            end=datatypes.PromptInput(prompt="b", seed=i, denoising=strength),
            alpha=0.5, num_inference_steps=50)

    def jax_inputs(i, strength):
        return jax_twin(port_inputs(i, strength))

    ours = serving.DynamicBatcher(_Recorder(), buckets=(1, 2, 4, 8, 16))
    theirs = jax_serving.DynamicBatcher(_Recorder(), buckets=(1, 2, 4, 8, 16))
    try:
        assert [ours._bucket(n) for n in range(1, 20)] == [theirs._bucket(n) for n in range(1, 20)]
    finally:
        ours.shutdown()
        theirs.shutdown()
    # five at the gated strength (one launch, padded to 8), one off it
    strengths = [0.75] * 5 + [0.65]
    calls, stats = _drive(serving, port_inputs, strengths)
    assert (calls, stats) == _drive(jax_serving, jax_inputs, strengths)
    assert calls == sorted([("batch", 8, "unipc_k:rho=2", 16), ("single", "dpmpp", 24)], key=str)


def test_load_seed_image_matches_the_original(tmp_path):
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(4, 4, 3)).save(tmp_path / "s.png")
    ours, theirs = (m.load_seed_image(tmp_path, "s") for m in (serving, jax_serving))
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
    assert serving.load_seed_image(tmp_path, "missing") is None
