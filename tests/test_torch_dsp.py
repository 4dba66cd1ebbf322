"""
The port's DSP (riffusion_tpu_torch ops/mel, ops/stft, ops/griffin_lim,
ops/codec, spectrogram_converter) against the JAX package on the CPU, where
the JAX package runs its `fft` STFT backend: the same numpy inputs go
through both, and Griffin-Lim gets the JAX program's uniform phase draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import torch_one_thread  # noqa: F401  (autouse)
from riffusion_tpu.audio.segment import AudioSegment as JaxAudioSegment
from riffusion_tpu.ops import codec as jax_codec
from riffusion_tpu.ops import mel as jax_mel
from riffusion_tpu.ops.griffin_lim import griffin_lim as jax_griffin_lim
from riffusion_tpu.ops.stft import get_stft_kernel as jax_stft_kernel
from riffusion_tpu.spectrogram_converter import SpectrogramConverter as JaxConverter
from riffusion_tpu.spectrogram_params import SpectrogramParams as JaxParams
from riffusion_tpu_torch.audio.segment import AudioSegment
from riffusion_tpu_torch.ops import codec, mel
from riffusion_tpu_torch.ops.griffin_lim import griffin_lim
from riffusion_tpu_torch.ops.stft import get_stft_kernel
from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

SR = 44100
PARAMS = SpectrogramParams(num_frequencies=64)
JAX_PARAMS = JaxParams(num_frequencies=64)


def _wave(seconds: float, channels: int = 1, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1234 * t)
    return (tone[None] + 0.05 * rng.standard_normal((channels, t.size))).astype(np.float32)


def _geometry(n_bins=None):
    args = (PARAMS.n_fft, PARAMS.win_length, PARAMS.hop_length, n_bins)
    return jax_stft_kernel(*args, backend="fft"), get_stft_kernel(*args)


def _gl_draws(key, shape):
    """The uniform phase tensors the JAX griffin_lim draws from `key`."""
    kr, ki = jax.random.split(key)
    return (np.array(jax.random.uniform(kr, shape, jnp.float32)),
            np.array(jax.random.uniform(ki, shape, jnp.float32)))


def _rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_mel_copy_is_identical():
    """ops/mel.py is a numpy copy: the same arrays, bit for bit."""
    n_freqs = PARAMS.n_fft // 2 + 1
    kw = dict(n_freqs=n_freqs, f_min=0.0, f_max=10000.0, n_mels=64, sample_rate=SR,
              norm=None, mel_scale="htk")
    fb_j, fb_t = jax_mel.mel_filterbank(**kw), mel.mel_filterbank(**kw)
    np.testing.assert_array_equal(fb_t, fb_j)
    n_active = mel.active_bin_count(fb_t)
    assert n_active == jax_mel.active_bin_count(fb_j) and n_active % 128 == 0
    np.testing.assert_array_equal(
        mel.inverse_mel_operator(**kw, n_active=n_active),
        jax_mel.inverse_mel_operator(**kw, n_active=n_active),
    )


# Both sides run a float32 real FFT of n_fft = 17640 (pocketfft in both
# frameworks on the CPU) over the same frames; 1e-5 of the peak covers the
# float32 rounding of a 17640-point transform.
@pytest.mark.parametrize("n_bins", [None, 1024], ids=["full", "band"])
def test_stft_matches_jax(n_bins):
    jk, tk = _geometry(n_bins)
    wave = _wave(0.3, channels=2)
    rj, ij = jk.stft(jnp.asarray(wave))
    rt, it = tk.stft(torch.from_numpy(wave))
    assert rt.shape == rj.shape
    assert _rel_err(rt.numpy(), rj) < 1e-5
    assert _rel_err(it.numpy(), ij) < 1e-5


@pytest.mark.parametrize("n_bins", [None, 1024], ids=["full", "band"])
def test_istft_matches_jax(n_bins):
    jk, tk = _geometry(n_bins)
    rng = np.random.default_rng(1)
    shape = (2, jk.n_bins, 31)
    real = rng.standard_normal(shape).astype(np.float32)
    imag = rng.standard_normal(shape).astype(np.float32)
    yj = jk.istft(jnp.asarray(real), jnp.asarray(imag))
    yt = tk.istft(torch.from_numpy(real), torch.from_numpy(imag))
    assert yt.shape == yj.shape == (2, 30 * PARAMS.hop_length)
    assert _rel_err(yt.numpy(), yj) < 1e-5


def test_mel_forward_matches_jax():
    wave = _wave(0.5)
    mj = JaxConverter(JAX_PARAMS, device="cpu").spectrogram_from_audio(
        JaxAudioSegment.from_float(wave * 32767, SR)
    )
    mt = SpectrogramConverter(PARAMS, device="cpu").spectrogram_from_audio(
        AudioSegment.from_float(wave * 32767, SR)
    )
    assert mt.shape == mj.shape == (1, 64, 51)
    assert _rel_err(mt, mj) < 1e-5


# Griffin-Lim iterates a projection 32 times with momentum 0.99/(1+0.99);
# each step is a contraction in phase, so FFT roundoff does not grow
# without bound, but it is carried through 64 transforms. Measured at
# ~1e-5 of the peak for these inputs; 1e-3 is the stated tolerance.
def test_griffin_lim_matches_jax_with_its_draws():
    jk, tk = _geometry(1024)
    rng = np.random.default_rng(2)
    mag = np.abs(rng.standard_normal((1, 1024, 24))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    wj = jax_griffin_lim(jnp.asarray(mag), jk, key, n_iters=32)
    init_real, init_imag = _gl_draws(key, mag.shape)
    wt = griffin_lim(torch.from_numpy(mag), tk, n_iters=32,
                     init_real=torch.from_numpy(init_real), init_imag=torch.from_numpy(init_imag))
    assert wt.shape == wj.shape
    assert _rel_err(wt.numpy(), wj) < 1e-3


def test_griffin_lim_init_arguments():
    _, tk = _geometry(1024)
    mag = torch.ones(1, 1024, 24)
    with pytest.raises(ValueError, match="both"):
        griffin_lim(mag, tk, init_real=torch.rand(1, 1024, 24))
    with pytest.raises(ValueError, match="shape"):
        griffin_lim(mag, tk, init_real=torch.rand(1, 1024, 3), init_imag=torch.rand(1, 1024, 3))
    gen = torch.Generator().manual_seed(0)
    a = griffin_lim(mag, tk, n_iters=2, generator=gen)
    b = griffin_lim(mag, tk, n_iters=2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_waveform_from_mel_matches_jax():
    """The inverse converter (inverse-mel matmul, clamp, Griffin-Lim) with the
    JAX program's phase draws; the same 1e-3 Griffin-Lim tolerance."""
    rng = np.random.default_rng(3)
    mel_amps = (30e6 * rng.random((1, 64, 40)) ** 4).astype(np.float32)
    jconv = JaxConverter(JAX_PARAMS, device="cpu")
    tconv = SpectrogramConverter(PARAMS, device="cpu")
    key = jax.random.PRNGKey(9)
    wj = jconv.waveform_from_mel_amplitudes(jnp.asarray(mel_amps), key=key)
    init_real, init_imag = _gl_draws(key, (1, tconv.n_active, 40))
    wt = tconv.waveform_from_mel_amplitudes(
        torch.from_numpy(mel_amps), torch.from_numpy(init_real), torch.from_numpy(init_imag)
    )
    assert wt.shape == wj.shape
    assert _rel_err(wt.numpy(), wj) < 1e-3


def test_codec_matches_jax():
    """Integer codes are exact; the float inverse agrees to float32 rounding."""
    rng = np.random.default_rng(4)
    spec = (rng.random((2, 16, 24)) ** 3 * 1e6).astype(np.float32)
    np.testing.assert_array_equal(
        codec.quantize_image(torch.from_numpy(spec), 0.25).numpy(),
        np.asarray(jax_codec.quantize_image(jnp.asarray(spec), 0.25)),
    )
    codes = rng.integers(0, 256, (2, 16, 24), dtype=np.uint8)
    np.testing.assert_allclose(
        codec.spectrogram_from_codes(torch.from_numpy(codes), 0.25, 30e6).numpy(),
        np.asarray(jax_codec.spectrogram_from_codes(jnp.asarray(codes), 0.25, 30e6)),
        rtol=1e-6,
    )
    for c in (1, 2):
        rgb_t = codec.rgb_image_from_codes(torch.from_numpy(codes[:c]))
        rgb_j = jax_codec.rgb_image_from_codes(jnp.asarray(codes[:c]))
        np.testing.assert_array_equal(rgb_t.numpy(), np.asarray(rgb_j))
        np.testing.assert_array_equal(
            codec.codes_from_rgb_image(rgb_t, stereo=c == 2).numpy(), codes[:c]
        )
    decoded = rng.uniform(-1.2, 1.2, (1, 16, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        codec.codes_from_vae_output(torch.from_numpy(decoded).permute(0, 3, 1, 2), False).numpy(),
        np.asarray(jax_codec.codes_from_vae_output(jnp.asarray(decoded), False)),
    )


def test_tone_gate_short_clip():
    """bench.py's DSP gate on the port: audio -> mel -> Griffin-Lim audio
    keeps a 220 Hz tone far above the noise floor (1.5 s clip here, 512 mel
    bins as served)."""
    t = np.arange(int(1.5 * SR)) / SR
    tone = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)).astype(
        np.float32
    )
    conv = SpectrogramConverter(SpectrogramParams(), device="cpu")
    mel_amps = conv.spectrogram_from_audio(AudioSegment.from_float(tone[None] * 32767, SR))
    audio = conv.audio_from_spectrogram(mel_amps, apply_filters=False)
    x = audio.raw_data[:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(x))
    freqs = np.fft.rfftfreq(x.size, 1 / SR)
    ratio = spec[(freqs > 212) & (freqs < 228)].max() / np.median(spec)
    assert ratio > 1000, ratio
