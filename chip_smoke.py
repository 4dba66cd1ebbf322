#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch + CUDA port (riffusion_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card: the card's name and power limit (nvidia-smi); no CUDA device fails.
2. build: nvcc builds csrc/attention.cu (K1) and csrc/row_attention.cu (K2)
   from this checkout, both at once; prints each build's seconds and ptxas
   register lines.
3. kernel: each kernel against its plain PyTorch version on the card, held
   to ops.attention.TOLERANCE: max abs error (bf16 2e-2, fp32 with TF32 off
   1e-4) and error RMS over output RMS (bf16 6e-3, fp32 1e-5). K1 at the
   single path's two shapes, the batched path's (32, 1024, 8*80),
   (16, 1024, 8*80) and (8, 4096, 8*40), ragged lengths, other head dims and
   large logits; K2 at the batched path's (32, 4096, 8*40), (9, 2048, 8*40), a
   ragged (10, 1000, 2*16), large logits and fp32 (10, 2048, 2*16). Times
   (CUDA events, median of 20) K1 and plain at the two single-path shapes,
   and K2, K1 and plain at (32, 4096, 8*40) bf16, before any model is
   loaded (the plain version there needs about 45 GB).
4. dsp: audio -> mel -> Griffin-Lim audio on the card keeps a 220 Hz tone
   far above the noise floor (bench.py's gate).
5. tiny: the tiny model end to end on the card (fp32) against the same model
   on the CPU, with the same injected noise, at a 256 px seed (K1 sites
   reached, K2 not); images agree within one uint8 level on >= 99% of pixels.
6. tiny batch: 5 requests through riffuse_audio_batch, the tiny model in fp32
   at a 512 px seed (UNet batch 10, the 64x64 level is lq 4096 at d=16, so K2
   is reached), on the card against the CPU with the same noise per request;
   the same image bound, K2 launched, no plain-version call.
7. slice: random:full (SD v1 width) in bf16 behind the port's HTTP server;
   three POST /run_inference/ requests (og_beat seed, 50 steps, default
   strength) each return 200, a 512x512 image and 5.11 s of non-silent
   audio, and go through K1 exactly 380 times (38 UNet evaluations x 10
   self-attention sites) and K2 never, with no plain-version call.
8. batch: the same model behind the threading server with a DynamicBatcher
   (max_batch 16, the strength-gated FAST preset). 16 concurrent
   /run_inference/ requests coalesce into one launch of 16 (unipc_k:rho=2,
   12 UNet evaluations at UNet batch 32): K2 5*E and K1 5*E times. One
   request at strength 0.65 runs dpmpp-24 alone (K1 10*E), timed with the
   batching window closed so that it does not wait 3 s for company. One
   /run_inference_batch/ of 16 at 50-step PNDM: K2 and K1 190 times each.
   E comes from the port's plans. Every response passes the checks of 7.

The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import re
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
BATCH_SHAPE = (32, 4096, 8, 40)  # K2's site at serving batch 16
LAUNCHES_PER_REQUEST = 38 * 10

# Each kernel's cases against its plain version: name, b, s_q, s_kv, h, d,
# dtype, logit scale on q and k. "path" cases are the main path's shapes;
# their worst errors go to the kernels line.
K1_CASES = (
    ("path d40", 2, 4096, 4096, 8, 40, "bf16", 1.0),
    ("path d80", 2, 1024, 1024, 8, 80, "bf16", 1.0),
    # the batched path's K1 sites: UNet batch 32 (buckets 8/16) at seq 1024,
    # batch 16 (bucket 8's d80 sites) and 8 (bucket 4) at seq 4096
    ("path batch-16 d80", 32, 1024, 1024, 8, 80, "bf16", 1.0),
    ("path batch-8 d80", 16, 1024, 1024, 8, 80, "bf16", 1.0),
    ("path batch-4 d40", 8, 4096, 4096, 8, 40, "bf16", 1.0),
    ("ragged d16", 1, 1000, 1000, 2, 16, "bf16", 1.0),
    ("ragged d32", 1, 1000, 1000, 2, 32, "bf16", 1.0),
    ("ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "bf16", 1.0),
    ("large logits d40", 1, 1024, 1024, 2, 40, "bf16", 8.0),
    ("fp32 slice d40", 2, 4096, 4096, 8, 40, "fp32", 1.0),
    ("fp32 ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "fp32", 1.0),
)
K2_CASES = (
    ("path batch-16 site", 32, 4096, 4096, 8, 40, "bf16", 1.0),
    ("b9 s2048 d40", 9, 2048, 2048, 8, 40, "bf16", 1.0),
    ("ragged d16", 10, 1000, 1000, 2, 16, "bf16", 1.0),
    ("large logits d40", 9, 1024, 1024, 2, 40, "bf16", 8.0),
    ("fp32 d16", 10, 2048, 2048, 2, 16, "fp32", 1.0),
)

# --mutants: faults planted in a copy of csrc/attention_common.cuh, the
# kernel body both kernels share: (what the fault does, text, replacement).
# The kernel phase's bf16 cases must reject each one in both kernels.
MUTANTS = (
    ("Q read from the next head's columns",
     "static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;",
     "static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb +\n"
     "      ((blockIdx.y + 1) % gridDim.y) * p.head_dim;"),
    ("ragged K/V tail unmasked (the zero-padded keys get logit 0)",
     "if (col >= p.s_kv) s[nt][e] = -INFINITY;", "(void)col;"),
    ("the fourth K/V tile skipped",
     "  for (int n0 = 0; n0 < p.s_kv; n0 += kTileN) {\n",
     "  for (int n0 = 0; n0 < p.s_kv; n0 += kTileN) {\n    if (n0 == 3 * kTileN) continue;\n"),
)


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
    start = time.perf_counter()
    built = attn.build_kernels(rebuild=True)
    log(f"[build] both sources in {time.perf_counter() - start:.1f} s (one nvcc each, in parallel)")
    for name, kernel in built.items():
        log(f"[build] nvcc built {kernel.path.name} in {kernel.build_seconds:.1f} s")
        instance = "?"
        for line in kernel.compiler_log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+?_kernel)I((?:Li\d+E)+)E", line)
            if entry:  # the name after the mangling's last length prefix, and its arguments
                name_part = re.split(r"\d+(?=[a-z])", entry.group(1))[-1]
                instance = f"{name_part}<{', '.join(re.findall(r'Li(\d+)E', entry.group(2)))}>"
            elif "registers" in line:
                log(f"[build]   {instance}: {line.split(':', 1)[-1].strip()}")


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


def _check_cases(torch, attn, fn, cases, gen) -> dict:
    """Run `fn` (a kernel wrapper) against the plain version on each case;
    returns the worst (max abs, rel RMS) over the bf16 cases at the path's
    shapes (names starting with "path")."""
    dev = torch.device("cuda")
    worst = [0.0, 0.0]
    for name, b, s_q, s_kv, h, d, dtype_name, mult in cases:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
        q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
        k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
        v = (2 * torch.rand(b, s_kv, h * d, generator=gen, device=dev) - 1).to(dtype)
        out = fn(q, k, v, num_heads=h, scale=d**-0.5)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q, k, v, num_heads=h, scale=d**-0.5)
        err, rel_rms, ok = attn.compare_to_plain(out, ref)
        log(f"[kernel] {fn.__name__} {name}: (b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d}, "
            f"{dtype}) max_abs_err {err:.3e}, rel_rms_err {rel_rms:.3e} "
            f"(tol {attn.TOLERANCE[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{fn.__name__} disagrees with its plain version: {name}")
        if name.startswith("path"):
            worst = [max(worst[0], err), max(worst[1], rel_rms)]
        del q, k, v, out, ref
    return {"max_abs_err": worst[0], "rel_rms_err": worst[1]}


def phase_kernel(torch, attn) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"attention": _check_cases(torch, attn, attn.attention, K1_CASES, gen),
              "row_attention": _check_cases(torch, attn, attn.row_attention, K2_CASES, gen)}

    times = {}
    for b, s, h, d in SLICE_SHAPES + (BATCH_SHAPE,):
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        fns = {"attention": attn.attention, "plain": attn.attention_reference}
        if (b, s, h, d) == BATCH_SHAPE:
            fns["row_attention"] = attn.row_attention
        flop = 4 * b * h * s * s * d
        for name, fn in fns.items():
            ms = _time_ms(torch, lambda: fn(q, k, v, num_heads=h, scale=d**-0.5))
            times[(name, b, s, d)] = ms
            log(f"[kernel] time (b={b}, s={s}, h={h}, d={d}, bf16): {name} {ms:.4f} ms "
                f"({flop / ms / 1e9:.1f} TFLOP/s)")
        del q, k, v
        torch.cuda.empty_cache()
    result["times"] = times
    return result


def phase_mutants(torch, attn) -> None:
    """Build each MUTANTS copy of the kernel sources (in csrc/build/, which
    git ignores) and show that the kernel phase's bf16 cases reject it in
    both kernels; the real sources are loaded again at the end."""
    import shutil

    original = dict(attn.KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    passed = []
    try:
        for i, (what, old, new) in enumerate(MUTANTS):
            src = attn.BUILD_DIR / "mutants" / str(i)
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(attn._CSRC, src, ignore=shutil.ignore_patterns("build"))
            header = src / "attention_common.cuh"
            text = header.read_text()
            if text.count(old) != 1:
                raise AssertionError(f"mutant {what!r}: its text is not in the kernel body once")
            header.write_text(text.replace(old, new))
            attn.KERNELS.update({n: (src / path.name, entry) for n, (path, entry) in original.items()})
            attn._built.clear()
            attn.build_kernels()
            for name, fn, cases in (("attention", attn.attention, K1_CASES),
                                    ("row_attention", attn.row_attention, K2_CASES)):
                try:
                    _check_cases(torch, attn, fn, [c for c in cases if c[6] == "bf16"], gen)
                    passed.append(f"{what} ({name})")
                    log(f"[mutants] {what}: {name} PASSED the check")
                except AssertionError as e:
                    log(f"[mutants] {what}: {name} rejected ({e})")
    finally:
        attn.KERNELS.update(original)
        attn._built.clear()
    attn.build_kernels()
    if passed:
        raise AssertionError(f"the kernel check let mutants through: {passed}")


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
    launches, rows, plain = attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls
    img_c, audio_c = cpu_pipe.riffuse_audio(inputs, image, params=params, noise=noise)
    equal, max_diff = _image_agreement(img_g, img_c)
    wg, wc = audio_g.raw_data.astype(np.float64), audio_c.raw_data.astype(np.float64)
    wave_err = float(np.linalg.norm(wg - wc) / np.linalg.norm(wc))
    log(f"[tiny] {size}px, cuda fp32 vs cpu fp32: pixels equal {equal:.4%}, max diff "
        f"{max_diff}; waveform rel L2 {wave_err:.3e}; K1 launches {launches}, K2 launches "
        f"{rows}, plain calls {plain}")
    if launches == 0 or rows != 0 or plain != 0:
        raise AssertionError("the tiny run on the card did not go through K1 alone")
    if max_diff > 1 or equal < 0.99 or not wave_err < 0.35:
        raise AssertionError("the card's tiny run disagrees with the CPU run")


def _image_agreement(a_img, b_img):
    """(share of equal pixels, max difference in uint8 levels)."""
    import numpy as np

    a, b = np.asarray(a_img, np.int16), np.asarray(b_img, np.int16)
    return float((a == b).mean()), int(np.abs(a - b).max())


def phase_tiny_batch(torch, attn) -> None:
    """5 requests in one batch on the card and on the CPU. Guidance 1.5-1.9:
    the random tiny UNet amplifies float32 rounding from step to step, and
    guidance multiplies it by up to 1 + 2g (tests/test_torch_pipeline.py)."""
    import numpy as np
    from PIL import Image

    from riffusion_tpu.datatypes import InferenceInput, PromptInput
    from riffusion_tpu.spectrogram_params import SpectrogramParams
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.riffusion_pipeline import FixedNoise, RiffusionPipeline

    size, n = 512, 5
    rng = np.random.default_rng(1)
    image = Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), mode="RGB")
    params = SpectrogramParams(num_frequencies=size)
    cpu_bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    gpu_pipe = RiffusionPipeline(copy.deepcopy(cpu_bundle), device="cuda")
    cpu_pipe = RiffusionPipeline(cpu_bundle, device="cpu")
    n_active = cpu_pipe.converter(params).n_active
    latent = (1, 4, size // 8, size // 8)
    noises = [FixedNoise({
        "vae_eps": rng.standard_normal(latent),
        "noise_a": rng.standard_normal(latent),
        "noise_b": rng.standard_normal(latent),
        "gl_real": rng.random((1, n_active, size)),
        "gl_imag": rng.random((1, n_active, size)),
    }) for _ in range(n)]
    inputs_list = [
        InferenceInput(start=PromptInput(prompt=f"church bells {i}", seed=i, guidance=1.5 + 0.1 * i),
                       end=PromptInput(prompt="techno", seed=10 + i, guidance=1.5),
                       alpha=0.2 * i, num_inference_steps=10)
        for i in range(n)
    ]
    scheduler = "unipc_k:rho=2"
    attn.COUNTS.reset()
    out_g = gpu_pipe.riffuse_audio_batch(inputs_list, image, params=params, noises=noises,
                                         scheduler=scheduler)
    torch.cuda.synchronize()
    launches, rows, plain = attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls
    out_c = cpu_pipe.riffuse_audio_batch(inputs_list, image, params=params, noises=noises,
                                         scheduler=scheduler)
    agreement = [_image_agreement(g[0], c[0]) for g, c in zip(out_g, out_c)]
    log(f"[tiny batch] {n} requests at {size}px ({scheduler}, UNet batch {2 * n}), cuda fp32 vs "
        f"cpu fp32, (pixels equal, max diff) per request: "
        f"{[(f'{e:.4%}', m) for e, m in agreement]}; K1 launches {launches}, K2 launches {rows}, "
        f"plain calls {plain}")
    if rows == 0 or launches == 0 or plain != 0:
        raise AssertionError("the tiny batch on the card did not go through both kernels")
    if any(m > 1 or e < 0.99 for e, m in agreement):
        raise AssertionError("the card's tiny batch disagrees with the CPU's")


def _check_response(out: dict) -> None:
    """One InferenceOutput: a non-flat 512x512 image and 5.11 s of audio that
    is not silent (a readback before the copy finished gives zeros)."""
    import numpy as np
    from PIL import Image

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


def _post(url: str, payload) -> tuple:
    """(HTTP status, parsed JSON body, wall seconds) of one POST."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as resp:
        status, body = resp.status, resp.read()
    return status, json.loads(body), time.perf_counter() - t0


def _request(i: int, steps: int = 50, denoising: float = 0.75) -> dict:
    return {
        "start": {"prompt": "funky synth solo", "seed": 42 + i, "denoising": denoising},
        "end": {"prompt": "jazzy saxophone", "seed": 123 + i, "denoising": denoising},
        "alpha": 0.5,
        "num_inference_steps": steps,
        "seed_image_id": "og_beat",
    }


def _expect_counts(attn, what: str, launches: int, rows: int) -> None:
    got = (attn.COUNTS.launches, attn.COUNTS.row_launches, attn.COUNTS.plain_calls)
    if got != (launches, rows, 0):
        raise AssertionError(f"{what}: (K1, K2, plain) launches {got}, expected "
                             f"{(launches, rows, 0)}")


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    if server.batcher is not None:
        server.batcher.shutdown()


def phase_slice(torch, attn, pipe) -> dict:
    from riffusion_tpu_torch import server as server_mod

    server_mod.PIPELINE = pipe
    srv = server_mod.RiffusionServer(("127.0.0.1", 0), seed_images_dir=REPO / "seed_images")
    thread, url = _serve(srv)
    counts = {"attention": 0, "row_attention": 0}
    try:
        for i in range(3):
            attn.COUNTS.reset()
            torch.cuda.reset_peak_memory_stats()
            status, out, wall = _post(url + "/run_inference/", _request(i))
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"[slice] request {i}: HTTP {status}, {wall:.3f} s wall, peak device memory "
                f"{peak:.2f} GiB, K1 launches {attn.COUNTS.launches}, K2 launches "
                f"{attn.COUNTS.row_launches}, plain calls {attn.COUNTS.plain_calls}")
            if status != 200:
                raise AssertionError(f"request {i}: HTTP {status}")
            _check_response(out)
            _expect_counts(attn, f"request {i}", LAUNCHES_PER_REQUEST, 0)
            counts["attention"] += attn.COUNTS.launches
    finally:
        _stop(srv, thread)
    return counts


def phase_batch(torch, attn, pipe) -> dict:
    """The batched path behind the threading server and the DynamicBatcher."""
    from riffusion_tpu_torch import server as server_mod
    from riffusion_tpu_torch.serving import FAST_PRESET, FAST_PRESET_OFFGATE, DynamicBatcher

    def evals(scheduler: str, steps: int, strength: float) -> int:
        return pipe._plan(scheduler, steps, strength)[0].num_steps

    e_fast = evals(FAST_PRESET["scheduler"], FAST_PRESET["steps"], 0.75)
    e_off = evals(FAST_PRESET_OFFGATE["scheduler"], FAST_PRESET_OFFGATE["steps"], 0.65)
    e_pndm = evals("pndm", 50, 0.75)
    log(f"[batch] UNet evaluations: FAST preset {e_fast}, off-gate {e_off}, PNDM-50 {e_pndm}")

    server_mod.PIPELINE = pipe
    srv = server_mod.RiffusionThreadingServer(("127.0.0.1", 0),
                                              seed_images_dir=REPO / "seed_images")
    srv.batcher = DynamicBatcher(pipe, max_batch=16, window_ms=3000,
                                 scheduler=FAST_PRESET["scheduler"],
                                 steps_override=FAST_PRESET["steps"], strength_gated=True)
    thread, url = _serve(srv)
    counts = {"attention": 0, "row_attention": 0}
    results = {}

    def run(what: str, k1: int, k2: int, fn):
        attn.COUNTS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        clips = fn()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[batch] {what}: {clips} clips in {wall:.3f} s wall ({clips / wall:.4f} clips/s), "
            f"peak device memory {peak:.2f} GiB, K1 launches {attn.COUNTS.launches}, K2 launches "
            f"{attn.COUNTS.row_launches}, plain calls {attn.COUNTS.plain_calls}")
        _expect_counts(attn, what, k1, k2)
        counts["attention"] += attn.COUNTS.launches
        counts["row_attention"] += attn.COUNTS.row_launches
        results[what] = {"clips": clips, "seconds": wall, "peak_gib": peak}

    def burst() -> int:
        before = dict(srv.batcher.stats)
        statuses = [None] * 16

        def post(i):
            try:
                status, out, _ = _post(url + "/run_inference/", _request(i))
                _check_response(out)
                statuses[i] = status
            except Exception as e:  # reported through `statuses`
                statuses[i] = repr(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        after = srv.batcher.stats
        launches = after["launches"] - before["launches"]
        batched = after["batched_requests"] - before["batched_requests"]
        log(f"[batch] statuses {statuses}; batcher launches {launches}, batched requests {batched}")
        if statuses != [200] * 16 or (launches, batched) != (1, 16):
            raise AssertionError("the burst did not come back as one batch of 16")
        return 16

    def lone_offgate() -> int:
        # a lone request waits the whole batching window before it runs:
        # close the window so that the wall time is the request's work
        srv.batcher.window_s, window_s = 0.0, srv.batcher.window_s
        try:
            status, out, _ = _post(url + "/run_inference/", _request(16, denoising=0.65))
        finally:
            srv.batcher.window_s = window_s
        if status != 200:
            raise AssertionError(f"off-gate request: HTTP {status}")
        _check_response(out)
        return 1

    def batch_route() -> int:
        status, out, _ = _post(url + "/run_inference_batch/",
                               {"requests": [_request(i) for i in range(16)]})
        if status != 200 or len(out["outputs"]) != 16:
            raise AssertionError(f"/run_inference_batch/: HTTP {status}")
        for item in out["outputs"]:
            _check_response(item)
        return 16

    try:
        run("burst of 16, FAST preset (first)", 5 * e_fast, 5 * e_fast, burst)
        run("burst of 16, FAST preset (second)", 5 * e_fast, 5 * e_fast, burst)
        run("one request at strength 0.65 (dpmpp-24, batching window 0 ms)", 10 * e_off, 0,
            lone_offgate)
        run("/run_inference_batch/ of 16, PNDM-50", 5 * e_pndm, 5 * e_pndm, batch_route)
    finally:
        _stop(srv, thread)
    return {"counts": counts, "results": results}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke test of the PyTorch port.")
    parser.add_argument("--mutants", action="store_true",
                        help="instead of the smoke: build each planted fault of the kernel "
                             "body (MUTANTS) and show that the kernel check rejects it")
    args = parser.parse_args(argv)

    import torch

    smi = phase_card(torch)
    sys.path.insert(0, str(REPO))
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.util import torch_util

    torch_util.configure_numerics()
    phase_build(attn)
    if args.mutants:
        phase_mutants(torch, attn)
        log(f"[mutants] every one of {len(MUTANTS)} mutants was rejected by both kernels' checks")
        return 0
    kernel = phase_kernel(torch, attn)
    phase_dsp(torch)
    phase_tiny(torch, attn)
    phase_tiny_batch(torch, attn)

    start = time.perf_counter()
    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] random:full (UNet/CLIP bf16, VAE fp32) built on the card in "
        f"{time.perf_counter() - start:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    single = phase_slice(torch, attn, pipe)
    batch = phase_batch(torch, attn, pipe)

    times = kernel["times"]
    b, s, _, d = BATCH_SHAPE
    entries = [
        ("attention", "attention.cu", "riffusion_tpu/models/layers.py:251",
         times[("attention", 2, 4096, 40)], times[("plain", 2, 4096, 40)]),
        ("row_attention", "row_attention.cu", "riffusion_tpu/ops/attention.py:188",
         times[("row_attention", b, s, d)], times[("plain", b, s, d)]),
    ]
    log(smi)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"riffusion_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": single[name] + batch["counts"][name],
        "max_abs_err": kernel[name]["max_abs_err"],
        "rel_rms_err": kernel[name]["rel_rms_err"],
        "ms": ms,
        "plain_ms": plain_ms,
    } for name, source, replaces, ms, plain_ms in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
