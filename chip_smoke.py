#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch + CUDA port (riffusion_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card: the card's name and power limit (nvidia-smi); no CUDA device fails.
2. build: nvcc builds csrc/attention.cu from this checkout; prints seconds.
3. kernel: the attention kernel against its plain PyTorch version on the
   card, at the serving path's two shapes, ragged lengths, other head dims
   and large logits, held to ops.attention.TOLERANCE: max abs error (bf16
   2e-2, fp32 with TF32 off 1e-4) and error RMS over output RMS (bf16 6e-3,
   fp32 1e-5). Times both (CUDA events, median of 20) at the two serving
   shapes.
4. dsp: audio -> mel -> Griffin-Lim audio on the card keeps a 220 Hz tone
   far above the noise floor (bench.py's gate).
5. tiny: the tiny model end to end on the card (fp32) against the same model
   on the CPU, with the same injected noise, at a 256 px seed (kernel sites
   reached); images agree within one uint8 level on >= 99% of pixels.
6. slice: random:full (SD v1 width) in bf16 behind the port's HTTP server;
   three POST /run_inference/ requests (og_beat seed, 50 steps, default
   strength) each return 200, a 512x512 image and 5.11 s of non-silent
   audio, and go through the kernel exactly 380 times (38 UNet evaluations
   x 10 self-attention sites) with no plain-version call.

The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import wave
from pathlib import Path

REPO = Path(__file__).resolve().parent
SLICE_SHAPES = ((2, 4096, 8, 40), (2, 1024, 8, 80))  # (batch, seq, heads, head_dim)
LAUNCHES_PER_REQUEST = 38 * 10


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this check runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; devices {torch.cuda.device_count()}")
    log(smi)
    return smi


def phase_build(attn) -> None:
    built = attn.build_kernel(rebuild=True)
    log(f"[build] nvcc built {built.path.name} in {built.build_seconds:.1f} s")
    for line in built.compiler_log.splitlines():
        if "registers" in line:
            log(f"[build]   {line.strip()}")


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Median of `reps` single-call times on the card (CUDA events)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel(torch, attn) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # name, b, s_q, s_kv, h, d, dtype, logit scale on q and k
        ("slice d40", 2, 4096, 4096, 8, 40, bf16, 1.0),
        ("slice d80", 2, 1024, 1024, 8, 80, bf16, 1.0),
        ("ragged d16", 1, 1000, 1000, 2, 16, bf16, 1.0),
        ("ragged d32", 1, 1000, 1000, 2, 32, bf16, 1.0),
        ("ragged d128 s_kv 777", 1, 1000, 777, 2, 128, bf16, 1.0),
        ("large logits d40", 1, 1024, 1024, 2, 40, bf16, 8.0),
        ("fp32 slice d40", 2, 4096, 4096, 8, 40, f32, 1.0),
        ("fp32 ragged d128 s_kv 777", 1, 1000, 777, 2, 128, f32, 1.0),
    ]
    slice_err = 0.0
    for name, b, s_q, s_kv, h, d, dtype, mult in cases:
        q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
        k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
        v = (2 * torch.rand(b, s_kv, h * d, generator=gen, device=dev) - 1).to(dtype)
        out = attn.attention(q, k, v, num_heads=h, scale=d**-0.5)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
        err, rel_rms, ok = attn.compare_to_plain(out, ref)
        log(f"[kernel] {name}: (b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d}, {dtype}) "
            f"max_abs_err {err:.3e}, rel_rms_err {rel_rms:.3e} (tol {attn.TOLERANCE[dtype]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version: {name}")
        if name.startswith("slice"):
            slice_err = max(slice_err, err)

    times = {}
    for b, s, h, d in SLICE_SHAPES:
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(bf16) for _ in range(3))
        kernel_ms = _time_ms(torch, lambda: attn.attention(q, k, v, num_heads=h, scale=d**-0.5))
        plain_ms = _time_ms(
            torch, lambda: attn.attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
        )
        flop = 4 * b * h * s * s * d
        log(f"[kernel] time (b={b}, s={s}, h={h}, d={d}, bf16): kernel {kernel_ms:.4f} ms "
            f"({flop / kernel_ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        times[(s, d)] = (kernel_ms, plain_ms)
    return {"max_abs_err": slice_err, "times": times}


def phase_dsp(torch) -> None:
    import numpy as np

    from riffusion_tpu.audio.segment import AudioSegment
    from riffusion_tpu.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.spectrogram_converter import SpectrogramConverter

    sr = 44100
    t = np.arange(int(5.11 * sr)) / sr
    tone = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)).astype(
        np.float32
    )
    conv = SpectrogramConverter(SpectrogramParams(), device="cuda")
    start = time.perf_counter()
    mel = conv.spectrogram_from_audio(AudioSegment.from_float(tone[None] * 32767, sr))
    audio = conv.audio_from_spectrogram(mel, apply_filters=False)
    seconds = time.perf_counter() - start
    x = audio.raw_data[:, 0].astype(np.float64)
    spec = np.abs(np.fft.rfft(x))
    freqs = np.fft.rfftfreq(x.size, 1 / sr)
    ratio = spec[(freqs > 212) & (freqs < 228)].max() / np.median(spec)
    log(f"[dsp] 220 Hz tone at {ratio:.0f}x the noise floor after mel + 32 Griffin-Lim "
        f"iterations on the card ({seconds:.2f} s incl. first-call setup)")
    if not ratio > 1000:
        raise AssertionError(f"DSP reconstruction on the card is broken (tone/noise {ratio:.1f})")


def phase_tiny(torch, attn) -> None:
    import numpy as np
    from PIL import Image

    from riffusion_tpu.datatypes import InferenceInput, PromptInput
    from riffusion_tpu.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline

    size = 256
    rng = np.random.default_rng(0)
    image = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), mode="RGB")
    params = SpectrogramParams(num_frequencies=size)
    cpu_bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    gpu_pipe = RiffusionPipeline(copy.deepcopy(cpu_bundle), device="cuda")
    cpu_pipe = RiffusionPipeline(cpu_bundle, device="cpu")
    n_active = cpu_pipe.converter(params).n_active
    latent = (1, 4, size // 8, size // 8)
    noise = FixedNoise({
        "vae_eps": rng.standard_normal(latent),
        "noise_a": rng.standard_normal(latent),
        "noise_b": rng.standard_normal(latent),
        "gl_real": rng.random((1, n_active, size)),
        "gl_imag": rng.random((1, n_active, size)),
    })
    inputs = InferenceInput(start=PromptInput(prompt="church bells", seed=1),
                            end=PromptInput(prompt="techno", seed=2), alpha=0.5,
                            num_inference_steps=10)
    attn.COUNTS.reset()
    img_g, audio_g = gpu_pipe.riffuse_audio(inputs, image, params=params, noise=noise)
    torch.cuda.synchronize()
    launches, plain = attn.COUNTS.launches, attn.COUNTS.plain_calls
    img_c, audio_c = cpu_pipe.riffuse_audio(inputs, image, params=params, noise=noise)
    a, b = np.asarray(img_g, np.int16), np.asarray(img_c, np.int16)
    equal, max_diff = float((a == b).mean()), int(np.abs(a - b).max())
    wg, wc = audio_g.raw_data.astype(np.float64), audio_c.raw_data.astype(np.float64)
    wave_err = float(np.linalg.norm(wg - wc) / np.linalg.norm(wc))
    log(f"[tiny] {size}px, cuda fp32 vs cpu fp32: pixels equal {equal:.4%}, max diff "
        f"{max_diff}; waveform rel L2 {wave_err:.3e}; kernel launches {launches}, "
        f"plain calls {plain}")
    if launches == 0 or plain != 0:
        raise AssertionError("the tiny run on the card did not go through the kernel")
    if max_diff > 1 or equal < 0.99 or not wave_err < 0.35:
        raise AssertionError("the card's tiny run disagrees with the CPU run")


def _check_response(body: bytes) -> None:
    import numpy as np
    from PIL import Image

    out = json.loads(body)
    image = Image.open(io.BytesIO(base64.b64decode(out["image"].split(",", 1)[1])))
    pixels = np.asarray(image.convert("RGB"), np.float64)
    if image.size != (512, 512) or not pixels.std() > 0:
        raise AssertionError(f"bad image: {image.size}, std {pixels.std()}")
    if abs(out["duration_s"] - 5.11) > 0.02:
        raise AssertionError(f"audio is {out['duration_s']} s, expected 5.11 s")
    if out["audio"].startswith("data:audio/wav;base64,"):
        with wave.open(io.BytesIO(base64.b64decode(out["audio"].split(",", 1)[1]))) as w:
            samples = np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.float64)
        if not (samples.size > 0 and samples.std() > 100):
            raise AssertionError(f"silent audio: std {samples.std()}")


def phase_slice(torch, attn) -> int:
    from riffusion_tpu_torch import server as server_mod
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    start = time.perf_counter()
    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] random:full (UNet/CLIP bf16, VAE fp32) built on the card in "
        f"{time.perf_counter() - start:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    server_mod.PIPELINE = pipe
    srv = server_mod.RiffusionServer(("127.0.0.1", 0), seed_images_dir=REPO / "seed_images")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/run_inference/"
    try:
        attn.COUNTS.reset()
        for i in range(3):
            payload = json.dumps({
                "start": {"prompt": "funky synth solo", "seed": 42 + i},
                "end": {"prompt": "jazzy saxophone", "seed": 123 + i},
                "alpha": 0.5,
                "num_inference_steps": 50,
                "seed_image_id": "og_beat",
            }).encode()
            before = attn.COUNTS.launches
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=payload,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, body = resp.status, resp.read()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            launched = attn.COUNTS.launches - before
            log(f"[slice] request {i}: HTTP {status}, {wall:.3f} s wall, peak device memory "
                f"{peak:.2f} GiB, kernel launches {launched}, plain calls "
                f"{attn.COUNTS.plain_calls}")
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            _check_response(body)
            if launched != LAUNCHES_PER_REQUEST or attn.COUNTS.plain_calls != 0:
                raise AssertionError(
                    f"request {i}: {launched} kernel launches (expected "
                    f"{LAUNCHES_PER_REQUEST}), {attn.COUNTS.plain_calls} plain calls"
                )
        launches = attn.COUNTS.launches
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return launches


def main() -> int:
    import torch

    smi = phase_card(torch)
    sys.path.insert(0, str(REPO))
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.util import torch_util

    torch_util.configure_numerics()
    phase_build(attn)
    kernel = phase_kernel(torch, attn)
    phase_dsp(torch)
    phase_tiny(torch, attn)
    launches = phase_slice(torch, attn)

    kernel_ms, plain_ms = kernel["times"][(4096, 40)]
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "attention",
        "route": "cuda",
        "source": "riffusion_tpu_torch/csrc/attention.cu",
        "replaces": "riffusion_tpu/models/layers.py:251",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
