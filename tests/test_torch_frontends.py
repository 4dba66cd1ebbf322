"""
The playground's host layer and pages (riffusion_tpu_torch/streamlit/), the
stem splitter and fft_util against the JAX package's modules on the same
numpy inputs, on the CPU.

Tolerances: the helpers (clip starts and slicing, the 32 stride, alphas,
sampled clips, spectrogram params, the scheduler map, compute_fft) must
agree exactly; the splitter's stems within one int16 step (both STFTs are
float32 FFTs that round differently); spectrogram images of the same clip
within one level on at least 99% of pixels (the CLI tests' bound).

The pages' pipeline calls are held with a recording stand-in for the
pipeline that `load_riffusion_checkpoint` returns in both packages: the
restyle (serial in each mode, and batched), the interpolation batch, the
batch page and text-to-audio make the same calls with the same arguments,
and stitch what comes back into the same samples. Last, one batched
restyle end to end on the port's random:tiny model.
"""

import dataclasses
import hashlib
import io
import json
import sys

import numpy as np
import pytest
from PIL import Image

import st_stub
from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from conftest import synth_waveform
from riffusion_tpu import audio_splitter as jax_splitter
from riffusion_tpu.audio.segment import AudioSegment as JaxAudioSegment
from riffusion_tpu.diffusion import schedulers as jax_sched
from riffusion_tpu.streamlit import util as jax_util
from riffusion_tpu.streamlit.tasks import audio_to_audio as jax_a2a
from riffusion_tpu.streamlit.tasks import image_to_audio as jax_i2a
from riffusion_tpu.streamlit.tasks import interpolation as jax_interp
from riffusion_tpu.streamlit.tasks import sample_clips as jax_clips
from riffusion_tpu.streamlit.tasks import split_audio as jax_split_page
from riffusion_tpu.streamlit.tasks import text_to_audio as jax_t2a
from riffusion_tpu.streamlit.tasks import text_to_audio_batch as jax_batch
from riffusion_tpu.util import fft_util as jax_fft_util
from riffusion_tpu_torch import audio_splitter
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.diffusion import schedulers as sched
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.streamlit import util
from riffusion_tpu_torch.streamlit.tasks import audio_to_audio as a2a
from riffusion_tpu_torch.streamlit.tasks import image_to_audio as i2a
from riffusion_tpu_torch.streamlit.tasks import interpolation as interp
from riffusion_tpu_torch.streamlit.tasks import sample_clips
from riffusion_tpu_torch.streamlit.tasks import split_audio as split_page
from riffusion_tpu_torch.streamlit.tasks import text_to_audio as t2a
from riffusion_tpu_torch.streamlit.tasks import text_to_audio_batch as batch_page
from riffusion_tpu_torch.util import fft_util

SR = 44100


def _pair(seconds, channels=1, seed=42):
    """The same synthesized clip as each package's AudioSegment."""
    data = synth_waveform(seconds, channels=channels, seed=seed) * 32767
    return AudioSegment.from_float(data, SR), JaxAudioSegment.from_float(data, SR)


def _assert_images_agree(a, b):
    a, b = np.asarray(a, np.int16), np.asarray(b, np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("duration", [3.0, 5.0, 5.01, 9.8, 17.034, 30.0])
def test_clip_starts_and_slices_match(duration):
    ours, theirs = _pair(duration, channels=2)
    starts = a2a.clip_start_times(duration)
    np.testing.assert_array_equal(starts, jax_a2a.clip_start_times(duration))
    clips = a2a.slice_audio_into_clips(ours, starts)
    jax_clips_ = jax_a2a.slice_audio_into_clips(theirs, starts)
    assert len(clips) == len(jax_clips_) == len(starts)
    for a, b in zip(clips, jax_clips_):
        np.testing.assert_array_equal(a.raw_data, b.raw_data)
        assert abs(a.duration_seconds - 5.0) < 0.01
    assert (a2a.CLIP_DURATION_S, a2a.OVERLAP_S) == (jax_a2a.CLIP_DURATION_S, jax_a2a.OVERLAP_S)


@pytest.mark.parametrize("size", [(568, 512), (501, 512), (64, 64), (100, 33)])
def test_scale_image_to_32_stride_matches(size):
    image = Image.fromarray(np.random.default_rng(0).integers(0, 255, size[::-1] + (3,),
                                                              dtype=np.uint8))
    ours, theirs = a2a.scale_image_to_32_stride(image), jax_a2a.scale_image_to_32_stride(image)
    assert ours.size == theirs.size == (size[0] - size[0] % 32, size[1] - size[1] % 32)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def test_shaped_alphas_and_specs_match():
    for n in (1, 2, 4, 5, 9):
        for power in (0.5, 1.0, 2.0, 3.3):
            assert interp.shaped_alphas(n, power) == jax_interp.shaped_alphas(n, power)
    for ours, theirs in ((interp.InterpolationSpec, jax_interp.InterpolationSpec),
                         (a2a.ClipParams, jax_a2a.ClipParams)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == \
            [(f.name, f.default) for f in dataclasses.fields(theirs)]


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_sample_clips_match_with_a_seed(mono):
    ours, theirs = _pair(3.0, channels=2)
    a = sample_clips.sample_clips(ours, num_clips=4, duration_ms=700, mono=mono, seed=11)
    b = jax_clips.sample_clips(theirs, num_clips=4, duration_ms=700, mono=mono, seed=11)
    assert [s for s, _ in a] == [s for s, _ in b]
    for (_, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x.raw_data, y.raw_data)
    assert sample_clips.sample_clip_starts(500, 700, 3, seed=1) == [0, 0, 0]


def test_params_for_ui_and_params_from_image_match():
    for use_20k in (False, True):
        assert dataclasses.asdict(t2a.params_for_ui(use_20k)) == \
            dataclasses.asdict(jax_t2a.params_for_ui(use_20k))
        plain = Image.new("RGB", (8, 8))
        assert dataclasses.asdict(i2a.params_from_image(plain, use_20k)) == \
            dataclasses.asdict(jax_i2a.params_from_image(plain, use_20k))
    image = Image.new("RGB", (8, 8))
    exif = image.getexif()
    exif.update(SpectrogramParams(num_frequencies=64, stereo=True).to_exif().items())
    buf = io.BytesIO()
    image.save(buf, format="PNG", exif=exif)
    stamped = Image.open(io.BytesIO(buf.getvalue()))
    assert i2a.params_from_image(stamped) == SpectrogramParams(num_frequencies=64, stereo=True)
    assert dataclasses.asdict(i2a.params_from_image(stamped)) == \
        dataclasses.asdict(jax_i2a.params_from_image(stamped))


def test_scheduler_map_and_constants_match():
    assert util.SCHEDULER_OPTIONS == jax_util.SCHEDULER_OPTIONS
    for option in util.SCHEDULER_OPTIONS:
        name = util.scheduler_name(option)
        assert name == jax_util.scheduler_name(option)
        assert name in sched.SCHEDULER_NAMES and name in jax_sched.SCHEDULER_NAMES
    for module in (util, jax_util):
        with pytest.raises(ValueError, match="Unknown scheduler"):
            module.scheduler_name("NopeScheduler")
    assert util.get_scheduler is util.scheduler_name
    assert (util.DEFAULT_CHECKPOINT, util.AUDIO_EXTENSIONS, util.IMAGE_EXTENSIONS) == \
        (jax_util.DEFAULT_CHECKPOINT, jax_util.AUDIO_EXTENSIONS, jax_util.IMAGE_EXTENSIONS)
    assert util.default_output_extension() == jax_util.default_output_extension()
    assert (batch_page.EXAMPLE_INPUT, batch_page.DEFAULT_PARAMS) == \
        (jax_batch.EXAMPLE_INPUT, jax_batch.DEFAULT_PARAMS)


def test_devices_default_to_cuda_and_the_cpu_only_on_request(monkeypatch):
    """select_device offers cuda first and takes it unless cpu is picked;
    every device parameter of the port defaults to cuda."""
    import inspect

    monkeypatch.setitem(sys.modules, "streamlit", st_stub.StreamlitStub())
    assert util.DEVICE_OPTIONS == ["cuda", "cpu"]
    assert util.select_device() == "cuda"
    monkeypatch.setitem(sys.modules, "streamlit", st_stub.StreamlitStub({"Device": "cpu"}))
    assert util.select_device() == "cpu"
    functions = [util.load_riffusion_checkpoint, util.spectrogram_image_converter,
                 util.spectrogram_image_from_audio, util.audio_segment_from_spectrogram_image,
                 util.audio_bytes_from_spectrogram_image, util.run_txt2img, util.run_img2img,
                 util.run_img2img_magic_mix, util.get_audio_splitter, a2a.restyle_segment,
                 a2a.restyle_audio, a2a._restyle_clips_batched, interp.run_interpolation_batch,
                 batch_page.run_batch, t2a.generate_clips, audio_splitter.split_audio,
                 audio_splitter.AudioSplitter.__init__]
    for fn in functions:
        fn = getattr(fn, "__wrapped__", fn)
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_streamlit_counter_and_cached_loaders(monkeypatch):
    monkeypatch.setitem(sys.modules, "streamlit", st_stub.StreamlitStub())
    counter = util.StreamlitCounter(key="c")
    counter.increment()
    counter.increment()
    assert counter.value == 2 and util.StreamlitCounter(key="c").value == 2
    # without streamlit the caches are lru_caches (util is imported before any stub)
    assert util.pipeline_lock() is util.pipeline_lock()
    assert hasattr(util.load_riffusion_checkpoint, "cache_clear")
    for alias in (util.load_stable_diffusion_pipeline, util.load_stable_diffusion_img2img_pipeline,
                  util.load_magic_mix_pipeline):
        assert alias is util.load_riffusion_checkpoint


def test_load_riffusion_checkpoint_takes_no_traced_unet(monkeypatch):
    """no_traced_unet is accepted and reaches the loader as
    use_traced_unet, as the JAX package's util passes it (the loader drops
    it)."""
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    seen = []
    monkeypatch.setattr(RiffusionPipeline, "load_checkpoint",
                        classmethod(lambda cls, **kw: seen.append(kw) or "pipe"))
    load = util.load_riffusion_checkpoint.__wrapped__
    assert load("random:tiny", no_traced_unet=True, device="cpu") == "pipe"
    assert load("random:tiny", device="cpu") == "pipe"
    assert seen == [{"checkpoint": "random:tiny", "use_traced_unet": use, "device": "cpu"}
                    for use in (False, True)]


# ------------------------------------------------- splitter and fft_util


def test_audio_splitter_stems_match_jax():
    """Both splitters on the CPU: every stem within one int16 step of the
    JAX package's, and the four stems sum back to the input."""
    ours, theirs = _pair(2.0, channels=2)
    a = audio_splitter.AudioSplitter(device="cpu").split(ours)
    b = jax_splitter.AudioSplitter(device="cpu").split(theirs)
    assert list(a) == list(b) == ["bass", "drums", "vocals", "other"]
    total = np.zeros(a["bass"].raw_data.shape)
    for name in a:
        assert a[name].frame_rate == SR
        assert np.abs(a[name].raw_data.astype(int) - b[name].raw_data).max() <= 1, name
        total += a[name].raw_data
    n = min(total.shape[0], ours.frame_count)
    orig = ours.raw_data[:n].astype(np.float64)
    assert np.sqrt(np.mean((total[:n] - orig) ** 2) / np.mean(orig ** 2)) < 0.15


def test_mono_stems_match_jax():
    ours, theirs = _pair(1.0, channels=1, seed=3)
    a = audio_splitter.AudioSplitter(device="cpu").split(ours)
    b = jax_splitter.AudioSplitter(device="cpu").split(theirs)
    for name in a:
        assert np.abs(a[name].raw_data.astype(int) - b[name].raw_data).max() <= 1, name


def test_split_audio_file_round_trip_matches_jax(tmp_path):
    ours, _ = _pair(1.0, channels=2, seed=5)
    src = tmp_path / "in.wav"
    ours.export(str(src), format="wav").close()
    paths = audio_splitter.split_audio(src, tmp_path / "ours", device="cpu")
    jax_paths = jax_splitter.split_audio(src, tmp_path / "theirs", device="cpu")
    assert [p.name for p in paths] == [p.name for p in jax_paths] == \
        ["bass.wav", "drums.wav", "other.wav", "vocals.wav"]
    stems = {}
    for p, q in zip(paths, jax_paths):
        a, b = AudioSegment.from_file(str(p)), JaxAudioSegment.from_file(str(q))
        assert a.frame_rate == b.frame_rate == SR
        assert np.abs(a.raw_data.astype(int) - b.raw_data).max() <= 1
        stems[p.stem] = a
    mixed = split_page.recombine(stems, ["bass", "drums"])
    jax_stems = {p.stem: JaxAudioSegment.from_file(str(p)) for p in paths}
    np.testing.assert_array_equal(mixed.raw_data,
                                  jax_split_page.recombine(jax_stems, ["bass", "drums"]).raw_data)


def test_compute_fft_matches_jax(tmp_path):
    ours, theirs = _pair(1.5, channels=2)
    for window_ms in (100, 37):
        freqs, mag = fft_util.compute_fft(ours, window_ms)
        jax_freqs, jax_mag = jax_fft_util.compute_fft(theirs, window_ms)
        np.testing.assert_array_equal(freqs, jax_freqs)
        np.testing.assert_array_equal(mag, jax_mag)
    freqs, mag = fft_util.compute_fft(ours)
    assert freqs[0] == 0 and freqs[-1] == pytest.approx(SR / 2)
    assert mag[np.argmin(np.abs(freqs - 110))] > np.median(mag) * 10  # the 110 Hz partial
    out = tmp_path / "fft.png"
    fft_util.plot_ffts({"a": ours}, show=False, save_path=str(out))
    assert out.stat().st_size > 0


# ------------------------------------------------- the pages' pipeline calls


def _describe(value):
    """A call's arguments in a form both packages share: dataclasses as
    dicts, images as uint8 arrays, sequences element by element."""
    if dataclasses.is_dataclass(value):
        return {"dataclass": type(value).__name__, **dataclasses.asdict(value)}
    if isinstance(value, Image.Image):
        return np.asarray(value.convert("RGB"))
    if isinstance(value, (list, tuple)):
        return [_describe(v) for v in value]
    return value


def _assert_same_calls(ours, theirs):
    assert [c[0] for c in ours] == [c[0] for c in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        b = {k: v for k, v in b.items() if not (k == "mesh" and v is None)}
        assert sorted(a) == sorted(b), name
        for key in a:
            _assert_same_value(a[key], b[key], f"{name}.{key}")


def _assert_same_value(a, b, where):
    if isinstance(a, np.ndarray):
        _assert_images_agree(a, b)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for x, y in zip(a, b):
            _assert_same_value(x, y, where)
    else:
        assert a == b, where


def _answer_image(size, salt):
    """A deterministic stand-in image of `size`."""
    w, h = size
    rng = np.random.default_rng(int(hashlib.sha256(f"{size}{salt}".encode()).hexdigest()[:8], 16))
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _answer_segment(cls, image, salt):
    """A deterministic stand-in clip: 10 ms per image column, stereo."""
    n = int(image.width * 441)
    rng = np.random.default_rng(len(salt) + image.width)
    return cls(np.round(rng.standard_normal((n, 2)) * 3000).astype(np.int16), SR)


class RecordingPipeline:
    """Stands in for the pipeline that load_riffusion_checkpoint returns:
    records each call and its arguments, answers with stand-in images (and
    clips of the package's own AudioSegment)."""

    def __init__(self, segment_cls):
        self.segment_cls = segment_cls
        self.calls = []

    def _record(self, name, **kw):
        self.calls.append((name, {k: _describe(v) for k, v in kw.items()}))

    def txt2img(self, **kw):
        self._record("txt2img", **kw)
        return _answer_image((kw["width"], kw["height"]), kw["prompt"])

    def img2img(self, **kw):
        self._record("img2img", **kw)
        return _answer_image(kw["init_image"].size, kw["prompt"])

    def img2img_magic_mix(self, **kw):
        self._record("img2img_magic_mix", **kw)
        return _answer_image(kw["init_image"].size, kw["prompt"])

    def riffuse(self, inputs, **kw):
        self._record("riffuse", inputs=inputs, **kw)
        return _answer_image(kw["init_image"].size, inputs.start.prompt)

    def riffuse_audio_batch(self, inputs_list, init_image, **kw):
        self._record("riffuse_audio_batch", inputs_list=inputs_list, init_image=init_image, **kw)
        images = init_image if isinstance(init_image, list) else [init_image] * len(inputs_list)
        out = []
        for i, image in enumerate(images):
            answer = _answer_image(image.size, i)
            out.append((answer, _answer_segment(self.segment_cls, answer, str(i))))
        return out

    def txt2img_audio_batch(self, **kw):
        self._record("txt2img_audio_batch", **kw)
        out = []
        for prompt in kw["prompts"]:
            answer = _answer_image((kw["width"], kw["height"]), prompt)
            out.append((answer, _answer_segment(self.segment_cls, answer, prompt)))
        return out


@pytest.fixture()
def recorders(monkeypatch):
    """(port's, JAX package's) recording pipelines behind each package's
    load_riffusion_checkpoint; audio_segment_from_spectrogram_image answers
    with stand-in clips and records the images it is given."""
    pair = []
    for module, segment_cls in ((util, AudioSegment), (jax_util, JaxAudioSegment)):
        rec = RecordingPipeline(segment_cls)

        def load(checkpoint=util.DEFAULT_CHECKPOINT, no_traced_unet=False, device="cuda",
                 _rec=rec):
            _rec.calls.append(("load", {"checkpoint": checkpoint, "device": device}))
            return _rec

        def to_audio(image, params, device="cuda", _rec=rec):
            _rec.calls.append(("to_audio", {"image": _describe(image), "params": _describe(params),
                                            "device": device}))
            return _answer_segment(_rec.segment_cls, image, "audio")

        monkeypatch.setattr(module, "load_riffusion_checkpoint", load)
        monkeypatch.setattr(module, "audio_segment_from_spectrogram_image", to_audio)
        pair.append(rec)
    return pair


@pytest.mark.parametrize("mode", ["img2img", "interpolation", "magic_mix"])
def test_restyle_audio_makes_the_same_calls(recorders, mode):
    """9.8 s of stereo (three clips, the last one padded) restyled in each
    mode: interpolation takes the batched path (one riffuse_audio_batch with
    a seed image per clip), the others restyle clip by clip. The same calls,
    and the stitched audio the same samples."""
    ours, theirs = _pair(9.8, channels=2, seed=7)
    params = a2a.ClipParams(prompt="jazzy saxophone", negative_prompt="drums", seed=5,
                            num_inference_steps=20)
    jax_params = jax_a2a.ClipParams(**dataclasses.asdict(params))
    kw = dict(mode=mode, device="cpu", checkpoint="ckpt", scheduler="DDIMScheduler",
              prompt_b="organ", seed_b=9)
    stitched, images = a2a.restyle_audio(ours, params, **kw)
    jax_stitched, jax_images = jax_a2a.restyle_audio(theirs, jax_params, **kw)
    port_rec, jax_rec = recorders
    _assert_same_calls(port_rec.calls, jax_rec.calls)
    names = [c[0] for c in port_rec.calls]
    if mode == "interpolation":
        assert names.count("riffuse_audio_batch") == 1
        assert len(port_rec.calls[1][1]["init_image"]) == 3  # one seed image per clip
    else:
        assert names.count({"img2img": "img2img", "magic_mix": "img2img_magic_mix"}[mode]) == 3
    assert len(images) == len(jax_images) == 3
    for a, b in zip(images, jax_images):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(stitched.raw_data, jax_stitched.raw_data)


def test_serial_interpolation_restyle_makes_the_same_calls(recorders):
    """One clip: interpolation mode restyles it with riffuse (the batched
    path needs two clips or more)."""
    ours, theirs = _pair(3.0, channels=1, seed=8)
    params = a2a.ClipParams(prompt="lofi", seed=3)
    a2a.restyle_audio(ours, params, mode="interpolation", device="cpu",
                      interpolation_alpha=0.25)
    jax_a2a.restyle_audio(theirs, jax_a2a.ClipParams(**dataclasses.asdict(params)),
                          mode="interpolation", device="cpu", interpolation_alpha=0.25)
    _assert_same_calls(*(r.calls for r in recorders))
    assert [c[0] for c in recorders[0].calls] == ["load", "riffuse", "to_audio"]
    with pytest.raises(ValueError, match="Unknown mode"):
        a2a.restyle_segment(_pair(1.0)[0], params, mode="nope", device="cpu")


def test_interpolation_batch_makes_the_same_calls(recorders):
    seed = Image.open("seed_images/og_beat.png").convert("RGB")
    spec = interp.InterpolationSpec(prompt_start="a", prompt_end="b", seed_start=1, seed_end=2,
                                    num_frames=5, alpha_power=2.0, num_inference_steps=30)
    images, segments = interp.run_interpolation_batch(spec, seed, device="cpu", checkpoint="c")
    jax_images, jax_segments = jax_interp.run_interpolation_batch(
        jax_interp.InterpolationSpec(**dataclasses.asdict(spec)), seed, device="cpu",
        checkpoint="c")
    _assert_same_calls(*(r.calls for r in recorders))
    assert len(images) == len(segments) == 5
    np.testing.assert_array_equal(interp.concat_segments(segments).raw_data,
                                  jax_interp.concat_segments(jax_segments).raw_data)


def test_batch_page_makes_the_same_calls(recorders, tmp_path):
    data = {"params": {"num_inference_steps": 7, "guidance": 3.0, "width": 256,
                       "checkpoint": "ckpt", "scheduler": "EulerAncestralDiscreteScheduler"},
            "entries": [{"prompt": "church bells"},
                        {"prompt": "electronic beats", "negative_prompt": "drums", "seed": 123},
                        {"prompt": "violin", "seed": 7}]}
    ours = batch_page.run_batch(data, device="cpu", output_dir=tmp_path / "ours")
    theirs = jax_batch.run_batch(data, device="cpu", output_dir=tmp_path / "theirs")
    _assert_same_calls(*(r.calls for r in recorders))
    assert [{k: v for k, v in r.items() if not k.startswith("_")} for r in ours] == \
        [{k: v for k, v in r.items() if not k.startswith("_")} for r in theirs]
    assert json.loads((tmp_path / "ours" / "index.json").read_text()) == \
        json.loads((tmp_path / "theirs" / "index.json").read_text())
    for record in ours:
        assert (tmp_path / "ours" / record["image"]).read_bytes() == \
            (tmp_path / "theirs" / record["image"]).read_bytes()
        assert (tmp_path / "ours" / record["audio"]).read_bytes() == \
            (tmp_path / "theirs" / record["audio"]).read_bytes()


def test_text_to_audio_clips_make_the_same_calls(recorders):
    kw = dict(prompt="piano", negative_prompt="", starting_seed=4, num_clips=2,
              num_inference_steps=9, width=256, use_20k=True, device="cpu")
    ours = list(t2a.generate_clips(**kw))
    theirs = list(jax_t2a.generate_clips(**kw))
    _assert_same_calls(*(r.calls for r in recorders))
    assert [s for s, _, _ in ours] == [s for s, _, _ in theirs] == [4, 5]


# ------------------------------------------------------------ end to end


def test_batched_restyle_end_to_end_on_tiny():
    """restyle_audio in interpolation mode on random:tiny: 6 s of stereo is
    two clips, one batched program with a seed image per clip (512 x 480
    each); the stitched audio is the two clips less one 0.2 s crossfade."""
    ours, _ = _pair(6.0, channels=2, seed=9)
    params = a2a.ClipParams(prompt="lofi beat", seed=1, num_inference_steps=4)
    try:
        stitched, images = a2a.restyle_audio(ours, params, mode="interpolation", device="cpu",
                                             checkpoint="random:tiny")
    finally:
        util.load_riffusion_checkpoint.cache_clear()
    assert [im.size for im in images] == [(480, 512)] * 2
    for image in images:
        assert np.asarray(image, np.float64).std() > 0
    # each clip's audio is its 480 columns (479 hops of 10 ms)
    assert stitched.frame_rate == SR and stitched.channels == 1
    assert stitched.frame_count == 2 * 479 * 441 - int(0.2 * SR)
    samples = stitched.raw_data.astype(np.float64)
    assert np.isfinite(samples).all() and samples.std() > 100
