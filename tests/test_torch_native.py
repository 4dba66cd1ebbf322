"""
The port's C++ audio engine (riffusion_tpu_torch/audio/native.py over
native/audio_engine.cpp) against the JAX package's engine as that package
builds and loads it (riffusion_tpu/audio/native.py, not patched): resampling,
crossfaded concatenation and the compressor must give the same int16
samples, bit for bit.

Also the fault the engine repairs: before it, the port resampled with scipy
and crossfaded in numpy while the JAX package ran its engine, so
audio-to-images-batch on a 48 kHz file and stitch_segments gave other
samples than the JAX package's. And the build's contract: a build or load
that fails raises with the compiler's output, nothing falls back to numpy
unless RIFFUSION_TPU_TORCH_NO_NATIVE=1 asks, and processes that build at
once each load a whole library.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import cli as jax_cli
from riffusion_tpu.audio import native as jax_native
from riffusion_tpu.audio.segment import AudioSegment as JaxAudioSegment
from riffusion_tpu.util import audio_util as jax_audio_util
from riffusion_tpu_torch import cli
from riffusion_tpu_torch.audio import native
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.util import audio_util

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX package's engine, loaded as the package loads it. Its first
    use builds it with make; a process that tries to load it while another
    test process is still linking it gets no library and marks the build
    failed, so that case is retried after the other build has finished."""
    if os.environ.get("RIFFUSION_TPU_NO_NATIVE"):
        pytest.fail("RIFFUSION_TPU_NO_NATIVE is set: the JAX package's engine is switched off")
    for _ in range(10):
        lib = jax_native._load_lib()
        if lib is not None:
            return lib
        time.sleep(2.0)
        jax_native._lib_failed = False
    pytest.fail("the JAX package's audio engine did not build or load")


def _pcm(n, channels, seed, level=9000.0):
    """Seeded int16 PCM: two tones and white noise, (n, channels)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None] / 44100.0
    x = (0.6 * np.sin(2 * np.pi * 220.0 * t + np.arange(channels))
         + 0.3 * np.sin(2 * np.pi * 3100.0 * t) + 0.2 * rng.standard_normal((n, channels)))
    return np.clip(np.round(x * level), -32768, 32767).astype(np.int16)


def test_engine_source_is_the_jax_engines():
    """Everything from the first #include on is the JAX package's text."""
    ours = (REPO / "riffusion_tpu_torch/native/audio_engine.cpp").read_text()
    theirs = (REPO / "riffusion_tpu/native/audio_engine.cpp").read_text()
    mark = "#include <cmath>"
    assert ours.count(mark) == theirs.count(mark) == 1
    assert ours[ours.index(mark):] == theirs[theirs.index(mark):]
    assert "-ffp-contract=off" in native.CXX_FLAGS


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("rates", [(44100, 48000), (48000, 44100), (44100, 22050),
                                   (16000, 44100)], ids=lambda r: f"{r[0]}-{r[1]}")
def test_resample_is_bit_equal_to_the_jax_engine(jax_engine, rates, channels):
    rate_in, rate_out = rates
    for n in (4001, 12347):  # odd lengths
        data = _pcm(n, channels, seed=n)
        ours = native.resample_poly_int16(data, rate_in, rate_out)
        theirs = jax_native.resample_poly_int16(data, rate_in, rate_out)
        assert ours.shape == theirs.shape == (-(-n * rate_out // rate_in), channels)
        np.testing.assert_array_equal(ours, theirs)
    assert native.resample_poly_int16(data, 44100, 44100) is data


@pytest.mark.parametrize("xf", [0, 1, 441, 8820, 10 ** 6],
                         ids=["none", "one", "short", "long", "longer than either"])
def test_crossfade_is_bit_equal_to_the_jax_engine(jax_engine, xf):
    a, b = _pcm(9001, 2, seed=1), _pcm(7777, 2, seed=2)
    ours = native.crossfade_concat_int16(a, b, xf)
    np.testing.assert_array_equal(ours, jax_native.crossfade_concat_int16(a, b, xf))
    assert ours.shape == (9001 + 7777 - min(xf, 7777), 2)
    np.testing.assert_array_equal(ours[: 9001 - min(xf, 7777)], a[: 9001 - min(xf, 7777)])
    with pytest.raises(ValueError, match="crossfade of -1 samples"):
        native.crossfade_concat_int16(a, b, -1)


@pytest.mark.parametrize("kw", [{}, {"threshold_db": -30.0, "ratio": 8.0, "attack_ms": 1.0,
                                     "release_ms": 200.0}], ids=["defaults", "hard"])
def test_compressor_is_bit_equal_to_the_jax_engine(jax_engine, kw):
    data = _pcm(22050, 2, seed=3, level=30000.0)
    data[:500] = 0  # silence: the envelope's floor
    ours = native.compress_dynamic_range_int16(data, 44100, **kw)
    np.testing.assert_array_equal(ours, jax_native.compress_dynamic_range_int16(data, 44100, **kw))
    assert np.abs(ours.astype(int)).mean() < np.abs(data.astype(int)).mean()  # it compressed


def test_segments_and_filters_match_the_jax_engine(jax_engine):
    """AudioSegment.set_frame_rate, append(crossfade=...) and
    apply_filters(compression=True) in both packages, neither patched."""
    data = _pcm(20001, 2, seed=4)
    ours, theirs = AudioSegment(data, 48000), JaxAudioSegment(data, 48000)
    pairs = {
        "resample": (ours.set_frame_rate(44100), theirs.set_frame_rate(44100)),
        "crossfade": (ours.append(ours[:200], crossfade=50),
                      theirs.append(theirs[:200], crossfade=50)),
        "compressed": (audio_util.apply_filters(ours, compression=True),
                       jax_audio_util.apply_filters(theirs, compression=True)),
    }
    for name, (a, b) in pairs.items():
        assert a.frame_rate == b.frame_rate, name
        np.testing.assert_array_equal(a.raw_data, b.raw_data, err_msg=name)


# ------------------------------------------------------ the repaired fault


def test_audio_to_images_batch_resamples_as_jax_does(jax_engine, tmp_path, monkeypatch):
    """audio-to-images-batch on a 48 kHz stereo wav: the command resamples
    it to 44.1 kHz before the spectrogram. The samples that reach each
    package's converter are the same, bit for bit, and so the images agree
    as the CLI tests hold them (within one level on >= 99% of pixels)."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    AudioSegment(_pcm(48000 // 2 + 1, 2, seed=5), 48000).export(str(audio_dir / "a.wav"))
    seen = {}

    def spy(module, key):
        original = module.SpectrogramImageConverter.spectrogram_image_from_audio

        def wrapped(self, segment):
            seen[key] = segment
            return original(self, segment)

        monkeypatch.setattr(module.SpectrogramImageConverter, "spectrogram_image_from_audio",
                            wrapped)

    spy(cli, "ours")
    spy(jax_cli, "theirs")
    cli.main(["audio-to-images-batch", "--audio-dir", str(audio_dir), "--output-dir",
              str(tmp_path / "ours"), "--image-extension", "png", "--num-frequencies", "64",
              "--device", "cpu"])
    jax_cli.audio_to_images_batch(audio_dir=str(audio_dir), output_dir=str(tmp_path / "theirs"),
                                  image_extension="png", num_frequencies=64, device="cpu")
    assert seen["ours"].frame_rate == seen["theirs"].frame_rate == 44100
    np.testing.assert_array_equal(seen["ours"].raw_data, seen["theirs"].raw_data)
    a = np.asarray(Image.open(tmp_path / "ours" / "a.png"), np.int16)
    b = np.asarray(Image.open(tmp_path / "theirs" / "a.png"), np.int16)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99


def test_stitch_segments_matches_jax(jax_engine):
    """Seven 5 s stereo clips stitched with the restyle's 0.2 s crossfades
    (and the stream command's, which are the same call): the same samples
    as the JAX package's."""
    ours = [AudioSegment(_pcm(5 * 44100, 2, seed=10 + i), 44100) for i in range(7)]
    theirs = [JaxAudioSegment(s.raw_data, 44100) for s in ours]
    a = audio_util.stitch_segments(ours, crossfade_s=0.2)
    b = jax_audio_util.stitch_segments(theirs, crossfade_s=0.2)
    assert a.frame_count == 7 * 5 * 44100 - 6 * 8820
    np.testing.assert_array_equal(a.raw_data, b.raw_data)


# ------------------------------------------------------- the build contract


def test_numpy_versions_only_on_request(monkeypatch):
    """RIFFUSION_TPU_TORCH_NO_NATIVE=1 runs the numpy versions; 0 or unset
    runs the engine; any other value is refused."""
    data = _pcm(3001, 2, seed=6)
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    np.testing.assert_array_equal(native.resample_poly_int16(data, 44100, 48000),
                                  native.resample_poly_int16_numpy(data, 44100, 48000))
    np.testing.assert_array_equal(native.crossfade_concat_int16(data, data, 300),
                                  native.crossfade_concat_int16_numpy(data, data, 300))
    monkeypatch.setenv(native.NO_NATIVE_ENV, "0")
    assert native.engine_enabled()
    engine = native.resample_poly_int16(data, 44100, 48000)
    assert not np.array_equal(engine, native.resample_poly_int16_numpy(data, 44100, 48000))
    monkeypatch.setenv(native.NO_NATIVE_ENV, "yes")
    with pytest.raises(ValueError, match="must be 0 or 1"):
        native.resample_poly_int16(data, 44100, 48000)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "audio_engine.cpp"
    broken.write_text("int rf_resample_poly_int16( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the audio engine") as info:
        native.resample_poly_int16(_pcm(100, 1, seed=7), 44100, 48000)
    assert "error" in str(info.value)
    assert list((tmp_path / "build").iterdir()) == []  # no half-written library left


_BUILD_PROGRAM = r"""
import hashlib, sys
from pathlib import Path
import numpy as np
from riffusion_tpu_torch.audio import native
native.BUILD_DIR = Path(sys.argv[1])
data = (np.arange(30000, dtype=np.int64).reshape(-1, 2) * 7919 % 20001 - 10000).astype(np.int16)
out = native.resample_poly_int16(data, 44100, 48000)
print("DIGEST", hashlib.sha256(out.tobytes()).hexdigest())
"""


def test_six_processes_building_at_once(tmp_path):
    """Six fresh processes build into one empty directory at the same time:
    each loads a whole library and computes the same samples, and one
    library is left, with no temporary file beside it."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROGRAM, str(tmp_path)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err[-2000:] for _, err in outs]
    digests = {line for out, _ in outs for line in out.splitlines() if line.startswith("DIGEST")}
    assert len(digests) == 1
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]


def test_the_smokes_engine_digests_are_the_jax_engines(jax_engine):
    """chip_smoke.py holds the engine on the card to ENGINE_DIGESTS: here,
    where both packages run, each case's inputs and the JAX engine's output
    have those digests, the port's engine gives the same samples, and the
    numpy versions stay inside ENGINE_BOUND."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cases = smoke._engine_cases()
    assert [case for case, _, _ in cases] == list(smoke.ENGINE_DIGESTS)
    for case, fn, args in cases:
        expect_in, expect_out = smoke.ENGINE_DIGESTS[case]
        assert smoke._digest([a for a in args if isinstance(a, np.ndarray)]) == expect_in, case
        theirs = getattr(jax_native, fn)(*args)
        assert smoke._digest([theirs]) == expect_out, case
        np.testing.assert_array_equal(getattr(native, fn)(*args), theirs, err_msg=case)
        if fn == "resample_poly_int16" and args[1:] != (44100, 48000):  # scipy's 160/147 is slow
            diff = theirs.astype(np.float64) - getattr(native, fn + "_numpy")(*args)
            assert np.abs(diff).max() <= smoke.ENGINE_BOUND["resample_max_lsb"], case
