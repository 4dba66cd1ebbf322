"""
The port's command line (riffusion_tpu_torch/cli.py) against the JAX
package's (riffusion_tpu/cli.py) on the CPU: the same commands with the same
flags (only --device's default differs), the DSP commands on the same inputs
in both packages (audio-to-image, image-to-audio, print-exif, sample-clips
and the two batch commands), and the generating commands end to end on
random:tiny (text-to-audio; stream with the wav's length as the JAX
package's tests/test_cli.py derives it, its warm-up launches and --fast).
The generating programs themselves are held to the JAX package's in
tests/test_torch_modes.py and tests/test_torch_pipeline.py.
"""

import argparse
import wave

import numpy as np
import pytest
from PIL import Image

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu import cli as jax_cli
from riffusion_tpu.audio.segment import AudioSegment as JaxAudioSegment
from riffusion_tpu_torch import cli
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.serving import FAST_PRESET

SR = 44100


def _tone(seconds, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    wave_f = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1250 * t)
    return np.stack([wave_f + 0.01 * rng.standard_normal(t.size) for _ in range(channels)])


@pytest.fixture()
def wav_path(tmp_path):
    path = tmp_path / "clip.wav"
    AudioSegment.from_float(_tone(1.2) * 32767, SR).export(str(path))
    return path


def _flags(commands, add_command):
    """{command: {flag: (default, required, type, action)}} of a parser
    built the given package's way."""
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers(dest="command")
    for fn in commands:
        add_command(subparsers, fn)
    return {
        name: {a.option_strings[0]: (a.default, a.required, getattr(a.type, "__name__", a.type),
                                     type(a).__name__)
               for a in sub._actions if a.option_strings and a.dest != "help"}
        for name, sub in subparsers.choices.items()
    }


def test_every_jax_command_with_its_flags():
    """Each JAX command exists with the same flags, defaults and actions.
    The differences: --device defaults to cuda, and --num-threads parses
    as an int (the JAX parser leaves it a string, which ThreadPool
    refuses)."""
    ours = _flags(cli.COMMANDS, cli._add_command)
    theirs = _flags(jax_cli._COMMANDS, jax_cli._add_command)
    assert set(ours) == set(theirs) == {
        "text-to-audio", "audio-to-image", "image-to-audio", "sample-clips", "print-exif",
        "audio-to-images-batch", "sample-clips-batch", "stream", "finetune"}
    for name in theirs:
        assert set(ours[name]) == set(theirs[name]), name
        for flag, spec in theirs[name].items():
            if flag == "--device":
                assert spec[0] == "tpu" and ours[name][flag] == ("cuda",) + spec[1:]
            elif flag == "--num-threads":
                assert ours[name][flag] == (None, False, "int", spec[3])
            else:
                assert ours[name][flag] == spec, (name, flag)
    args = cli.build_parser().parse_args(["stream", "--prompt-start", "a", "--audio", "x.wav",
                                          "--fast", "--batch", "8"])
    assert args.fast is True and args.batch == 8 and args.device == "cuda"
    with pytest.raises(SystemExit):
        cli.main(["audio-to-image", "--nope", "x"])


def test_audio_to_image_and_print_exif_match_jax(tmp_path, wav_path, capsys):
    """The same wav through both packages' audio-to-image (at 64 mel bins):
    the spectrogram images within one level on at least 99% of pixels equal;
    print-exif prints the same table (the peak to float32 rounding)."""
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    cli.main(["audio-to-image", "--audio", str(wav_path), "--image", str(ours),
              "--num-frequencies", "64", "--device", "cpu"])
    jax_cli.audio_to_image(audio=str(wav_path), image=str(theirs), num_frequencies=64,
                           device="cpu")
    a, b = np.asarray(Image.open(ours), np.int16), np.asarray(Image.open(theirs), np.int16)
    assert a.shape == b.shape == (64, 121, 3) and a.std() > 0
    assert np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99
    capsys.readouterr()
    cli.main(["print-exif", "--image", str(ours)])
    printed = capsys.readouterr().out
    jax_cli.print_exif(image=str(theirs))
    ours_rows = [line.split("=") for line in printed.splitlines()]
    theirs_rows = [line.split("=") for line in capsys.readouterr().out.splitlines()]
    assert [r[0] for r in ours_rows] == [r[0] for r in theirs_rows]
    for (name, x), (_, y) in zip(ours_rows, theirs_rows):
        if name.strip() == "MAX_VALUE":  # the spectrogram's peak: float32 rounding apart
            assert float(x) == pytest.approx(float(y), rel=1e-5)
        else:
            assert x == y, name
    assert "NUM_FREQUENCIES" in printed and "44100" in printed


def test_image_to_audio_round_trip(tmp_path, wav_path, capsys):
    """A spectrogram image back to audio in both packages: the same length,
    rate and channels from the image's EXIF, non-silent; without EXIF the
    defaults, with the JAX package's warning."""
    image = tmp_path / "spec.png"
    cli.main(["audio-to-image", "--audio", str(wav_path), "--image", str(image),
              "--num-frequencies", "64", "--device", "cpu"])
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    cli.main(["image-to-audio", "--image", str(image), "--audio", str(ours), "--device", "cpu"])
    jax_cli.image_to_audio(image=str(image), audio=str(theirs), device="cpu")
    a, b = AudioSegment.from_file(str(ours)), JaxAudioSegment.from_file(str(theirs))
    assert (a.frame_rate, a.channels, a.frame_count) == (b.frame_rate, b.channels, b.frame_count)
    assert abs(a.duration_ms - AudioSegment.from_file(str(wav_path)).duration_ms) < 15
    assert np.abs(a.raw_data.astype(int)).max() > 1000
    plain = tmp_path / "plain.png"
    Image.new("RGB", (32, 512), (128, 128, 128)).save(plain)
    capsys.readouterr()
    cli.main(["image-to-audio", "--image", str(plain), "--audio", str(tmp_path / "p.wav"),
              "--device", "cpu"])
    assert "Using defaults" in capsys.readouterr().out


def test_sample_clips_match_jax(tmp_path, wav_path):
    """The same seed gives the same clips, byte for byte, in both packages."""
    kw = dict(audio=str(wav_path), num_clips=3, duration_ms=300, seed=7)
    cli.sample_clips(output_dir=str(tmp_path / "ours"), **kw)
    jax_cli.sample_clips(output_dir=str(tmp_path / "theirs"), **kw)
    ours = sorted((tmp_path / "ours").glob("*.wav"))
    theirs = sorted((tmp_path / "theirs").glob("*.wav"))
    assert [p.name for p in ours] == [p.name for p in theirs] and len(ours) == 3
    for a, b in zip(ours, theirs):
        assert a.read_bytes() == b.read_bytes()


def test_batch_commands_match_jax(tmp_path, wav_path):
    """audio-to-images-batch over a mono and a stereo file (two threads,
    `--num-threads` through the parser) and sample-clips-batch, against the
    JAX package's on the same directory."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    (audio_dir / "a0.wav").write_bytes(wav_path.read_bytes())
    AudioSegment.from_float(_tone(0.9, channels=2, seed=1) * 32767, SR).export(
        str(audio_dir / "a1.wav"))
    cli.main(["audio-to-images-batch", "--audio-dir", str(audio_dir), "--output-dir",
              str(tmp_path / "ours"), "--image-extension", "png", "--num-frequencies", "64",
              "--mono", "--num-threads", "2", "--device", "cpu"])
    jax_cli.audio_to_images_batch(audio_dir=str(audio_dir), output_dir=str(tmp_path / "theirs"),
                                  image_extension="png", num_frequencies=64, mono=True,
                                  num_threads=2, device="cpu")
    ours = sorted((tmp_path / "ours").glob("*.png"))
    assert [p.name for p in ours] == ["a0.png", "a1.png"]
    for path in ours:
        a = np.asarray(Image.open(path), np.int16)
        b = np.asarray(Image.open(tmp_path / "theirs" / path.name), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1 and (a == b).mean() >= 0.99

    # one thread: the clips' starts come from numpy's global generator in
    # file order
    kw = dict(audio_dir=str(audio_dir), num_clips_per_file=2, duration_ms=250,
              extension="wav", seed=3, num_threads=1)
    cli.sample_clips_batch(output_dir=str(tmp_path / "clips"), **kw)
    jax_cli.sample_clips_batch(output_dir=str(tmp_path / "jax_clips"), **kw)
    ours = sorted((tmp_path / "clips").glob("*.wav"))
    theirs = sorted((tmp_path / "jax_clips").glob("*.wav"))
    assert len(ours) == 4 and [p.name for p in ours] == [p.name for p in theirs]


def _read_wav(path):
    with wave.open(str(path)) as w:
        rate, n = w.getframerate(), w.getnframes()
        return rate, n, np.frombuffer(w.readframes(n), np.int16)


def test_text_to_audio_command(tmp_path, capsys):
    """One prompt through txt2img_audio_batch: a wav of the image's width
    (64 columns: 63 hops) that is not silent, and the PNG."""
    audio, image = tmp_path / "out.wav", tmp_path / "out.png"
    cli.main(["text-to-audio", "--prompt", "trance arps", "--audio", str(audio),
              "--image", str(image), "--num-inference-steps", "2", "--width", "64",
              "--guidance", "1.5", "--checkpoint", "random:tiny", "--device", "cpu"])
    rate, n, data = _read_wav(audio)
    assert rate == SR and n == 63 * 441
    assert np.abs(data).max() > 1000
    assert Image.open(image).size == (64, 512)
    assert "Wrote" in capsys.readouterr().out


@pytest.fixture()
def seed_png(tmp_path):
    path = tmp_path / "seed.png"
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(path)
    return path


@pytest.fixture()
def launches(monkeypatch):
    """Every riffuse_audio_batch call: (batch size, steps, scheduler,
    async_dispatch)."""
    calls = []
    original = RiffusionPipeline.riffuse_audio_batch

    def counted(self, inputs_list, *args, **kwargs):
        calls.append((len(inputs_list), inputs_list[0].num_inference_steps,
                      kwargs.get("scheduler"), kwargs.get("async_dispatch", False)))
        return original(self, inputs_list, *args, **kwargs)

    monkeypatch.setattr(RiffusionPipeline, "riffuse_audio_batch", counted)
    return calls


def test_stream_command(tmp_path, seed_png, launches, capsys):
    """Five clips in batches of two (sizes 2, 2, 1): one warm-up launch per
    size, then three queued launches; the track is five clips less four
    crossfades, as the JAX package's stream test computes it."""
    audio = tmp_path / "stream.wav"
    cli.main(["stream", "--prompt-start", "lofi beat", "--prompt-end", "synthwave",
              "--audio", str(audio), "--num-clips", "5", "--batch", "2",
              "--num-inference-steps", "2", "--guidance", "1.5", "--seed-image", str(seed_png),
              "--num-frequencies", "64", "--crossfade-ms", "50",
              "--checkpoint", "random:tiny", "--device", "cpu"])
    assert launches == [(2, 2, None, False), (1, 2, None, False)] + [(2, 2, None, True)] * 2 \
        + [(1, 2, None, True)]
    rate, n, data = _read_wav(audio)
    clip_s = 63 * 441 / SR
    expect_s = 5 * clip_s - 4 * 0.050
    assert rate == SR and abs(n / rate - expect_s) < 0.01, (n / rate, expect_s)
    assert np.abs(data).max() > 1000
    assert "x realtime" in capsys.readouterr().out


def test_stream_fast_preset(tmp_path, seed_png, launches):
    """--fast serves every clip at serving.FAST_PRESET."""
    cli.main(["stream", "--prompt-start", "a", "--audio", str(tmp_path / "s.wav"),
              "--num-clips", "2", "--batch", "2", "--fast", "--guidance", "1.5",
              "--seed-image", str(seed_png), "--num-frequencies", "64",
              "--checkpoint", "random:tiny", "--device", "cpu"])
    fast = (2, FAST_PRESET["steps"], FAST_PRESET["scheduler"])
    assert launches == [fast + (False,), fast + (True,)]
    with pytest.raises(SystemExit, match="must be >= 1"):
        cli.main(["stream", "--prompt-start", "a", "--audio", "x.wav", "--batch", "0"])
