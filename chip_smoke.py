#!/usr/bin/env python3
"""
On-card smoke test of the PyTorch + CUDA port (riffusion_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card: the card's name and power limit (nvidia-smi); no CUDA device fails.
2. build: nvcc builds csrc/attention.cu (K1), csrc/row_attention.cu (K2),
   csrc/attention_dkv.cu and csrc/attention_dq.cu (K1's backward) from this
   checkout, all at once; prints each build's seconds and ptxas register
   lines.
3. kernel: each forward kernel against its plain PyTorch version on the
   card, held to ops.attention.TOLERANCE: max abs error (bf16 2e-2, fp32
   with TF32 off 1e-4) and error RMS over output RMS (bf16 6e-3, fp32
   1e-5). K1 at the single path's two shapes, the batched path's
   (32, 1024, 8*80), (16, 1024, 8*80) and (8, 4096, 8*40), ragged lengths,
   other head dims and large logits; K2 at the batched path's
   (32, 4096, 8*40), (9, 2048, 8*40), a ragged (10, 1000, 2*16), large
   logits and fp32 (10, 2048, 2*16). Times (CUDA events, median of 20) K1,
   plain and torch's scaled_dot_product_attention (the library yardstick,
   never called by the port) at the two single-path shapes, and K2, K1,
   plain and the library at (32, 4096, 8*40) bf16, before any model is
   loaded (the plain version there needs about 45 GB).
4. kernel-grad: K1's backward kernels (dK/dV, dQ) through `attention`'s
   autograd against the plain backward (ops.attention.
   attention_backward_reference), each of dQ, dK and dV held to
   GRAD_TOLERANCE (bf16 max abs 1.25e-1 and rel RMS 1e-2; fp32 1e-3 and
   2e-5), at the fine-tuning path's (4, 4096, 8*40) and (4, 1024, 8*80)
   bf16, ragged lengths, large logits and the fp32 instances; the forward's
   log-sum-exp against torch.logsumexp; times of the forward with LSE, each
   backward kernel, the plain backward and the library's backward at the
   path's shapes; `row_attention`'s backward (the plain recompute) at
   (9, 2048, 8*40).
5. dsp: audio -> mel -> Griffin-Lim audio on the card keeps a 220 Hz tone
   far above the noise floor (bench.py's gate).
6. tiny: the tiny model end to end on the card (fp32) against the same model
   on the CPU, with the same injected noise, at a 256 px seed (K1 sites
   reached, K2 not); images agree within one uint8 level on >= 99% of pixels.
7. tiny batch: 5 requests through riffuse_audio_batch, the tiny model in fp32
   at a 512 px seed (UNet batch 10, the 64x64 level is lq 4096 at d=16, so K2
   is reached), on the card against the CPU with the same noise per request;
   the same image bound, K2 launched, no plain-version call.
8. tiny train: three trainer steps of the tiny UNet in fp32 (32x32
   latents, so K1 and its backward are reached) on the card against the
   same steps on the CPU with the same t and noise: the losses, and the
   parameters' movement.
9. slice: random:full (SD v1 width) in bf16 behind the port's HTTP server;
   three POST /run_inference/ requests (og_beat seed, 50 steps, default
   strength) each return 200, a 512x512 image and 5.11 s of non-silent
   audio, and go through K1 exactly 380 times (38 UNet evaluations x 10
   self-attention sites) and K2 never, with no plain-version call.
10. batch: the same model behind the threading server with a DynamicBatcher
   (max_batch 16, the strength-gated FAST preset). 16 concurrent
   /run_inference/ requests coalesce into one launch of 16 (unipc_k:rho=2,
   12 UNet evaluations at UNet batch 32): K2 5*E and K1 5*E times. One
   request at strength 0.65 runs dpmpp-24 alone (K1 10*E), timed with the
   batching window closed so that it does not wait 3 s for company. One
   /run_inference_batch/ of 16 at 50-step PNDM: K2 and K1 190 times each.
   E comes from the port's plans. Every response passes the checks of 9.
11. train: fine-tuning at full width. 8 synthesized clips of 5.12 s go
   through build_latent_dataset with the random:full pipeline, then
   run_finetune(steps=4, batch_size=4) (fp32 masters, bf16 compute, AdamW,
   EMA, the final checkpoint and the export) in a directory under .chipwork/
   that is deleted at the end. Every step takes exactly 10 K1 forwards,
   10 dK/dV and 10 dQ launches and no plain call, with a finite loss.
   Prints the step time (median of steps 2-4), the peak device memory, the
   checkpoint's bytes and seconds and the free disk before the run. One
   full-width step's gradients with the kernels against the same step with
   the plain attention (the smoke swaps models.layers._ATTENTION_OPS in
   its own process) within TRAIN_GRAD_BOUND; the export reloaded with
   RiffusionPipeline.load_checkpoint and one request riffused.

`--mutants` instead builds each planted fault of MUTANTS into a copy of
the kernel sources and shows that every kernel's check rejects it.

The last two lines are the kernel table and
{"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from pathlib import Path

REPO = Path(__file__).resolve().parent
SLICE_SHAPES = ((2, 4096, 8, 40), (2, 1024, 8, 80))  # (batch, seq, heads, head_dim)
BATCH_SHAPE = (32, 4096, 8, 40)  # K2's site at serving batch 16
TRAIN_SHAPES = ((4, 4096, 8, 40), (4, 1024, 8, 80))  # K1's sites at fine-tuning batch 4
LAUNCHES_PER_REQUEST = 38 * 10
LAUNCHES_PER_STEP = 10  # self-attention sites on K1 at UNet batch 4

# The card's published peaks (H100 SXM, dense) for the bound of each kernel:
# the larger of its FLOPs over the bf16 tensor-core rate and its bytes (each
# input read once, each output written once) over the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# One full-width step's gradients with the kernels against the plain
# attention's (PERF.md "Fine-tuning", written before the first run): the
# relative L2 of the difference over all parameters, and of the loss.
TRAIN_GRAD_BOUND = {"grad_rel_l2": 5e-2, "loss_rel": 1e-2}

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

K1_GRAD_CASES = (
    ("path d40", 4, 4096, 4096, 8, 40, "bf16", 1.0),
    ("path d80", 4, 1024, 1024, 8, 80, "bf16", 1.0),
    ("ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "bf16", 1.0),
    ("ragged d16 s_q 333", 2, 333, 1000, 2, 16, "bf16", 1.0),
    ("large logits d40", 1, 1024, 1024, 2, 40, "bf16", 4.0),
    ("fp32 d32", 2, 300, 300, 3, 32, "fp32", 1.0),
    ("fp32 ragged d128 s_kv 777", 1, 1000, 777, 2, 128, "fp32", 1.0),
)

# --mutants: faults planted in a copy of the kernel sources: (what, file,
# text, replacement). The forward faults (in attention_common.cuh, the body
# K1 and K2 share) must be rejected by both forward kernels' bf16 cases; the
# backward faults (attention_bwd.cuh, the body both backward kernels share)
# by both backward kernels' bf16 gradient cases.
MUTANTS = (
    ("Q read from the next head's columns", "attention_common.cuh",
     "static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb + col0;",
     "static_cast<const __nv_bfloat16*>(p.q) + batch * p.q_sb +\n"
     "      ((blockIdx.y + 1) % gridDim.y) * p.head_dim;"),
    ("ragged K/V tail unmasked (the zero-padded keys get logit 0)", "attention_common.cuh",
     "if (col >= p.s_kv) s[nt][e] = -INFINITY;", "(void)col;"),
    ("the fourth K/V tile skipped", "attention_common.cuh",
     "  for (int n0 = 0; n0 < p.s_kv; n0 += kTileN) {\n",
     "  for (int n0 = 0; n0 < p.s_kv; n0 += kTileN) {\n    if (n0 == 3 * kTileN) continue;\n"),
    ("dS without its -delta term", "attention_bwd.cuh",
     "  return prob * (dp - delta);", "  return prob * dp;"),
    ("the LSE of the next head", "attention_bwd.cuh",
     "  return p.lse + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * p.s_q;",
     "  return p.lse + ((long long)blockIdx.z * gridDim.y + (blockIdx.y + 1) % gridDim.y) *\n"
     "                     p.s_q;"),
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
    log(f"[build] {len(built)} sources in {time.perf_counter() - start:.1f} s (one nvcc each, "
        "in parallel)")
    for name, kernel in built.items():
        log(f"[build] nvcc built {kernel.path.name} in {kernel.build_seconds:.1f} s")
        instance = "?"
        for line in kernel.compiler_log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+?_kernel)I((?:L[ib]\d+E)+)E", line)
            if entry:  # the name after the mangling's last length prefix, and its arguments
                name_part = re.split(r"\d+(?=[a-z])", entry.group(1))[-1]
                args = re.findall(r"L[ib](\d+)E", entry.group(2))
                instance = f"{name_part}<{', '.join(args)}>"
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


def _bound(flop: float, nbytes: float) -> tuple:
    """(least time in ms the card could take, what bounds it)."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _heads_first(torch, x, h):
    """(b, s, h*d) -> a contiguous (b, h, s, d) copy, the library's layout."""
    b, s, inner = x.shape
    return x.view(b, s, h, inner // h).transpose(1, 2).contiguous()


def phase_kernel(torch, attn) -> dict:
    import torch.nn.functional as F

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
        qh, kh, vh = (_heads_first(torch, x, h) for x in (q, k, v))
        ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=d**-0.5))
        times[("library", b, s, d)] = ms
        times[("bound", b, s, d)] = _bound(flop, 4 * b * s * h * d * 2)
        log(f"[kernel] time (b={b}, s={s}, h={h}, d={d}, bf16): library "
            f"scaled_dot_product_attention {ms:.4f} ms; bound {times[('bound', b, s, d)][0]:.4f} "
            f"ms ({times[('bound', b, s, d)][1]})")
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    result["times"] = times
    return result


def _grad_case(torch, dev, gen, b, s_q, s_kv, h, d, dtype, mult):
    """q, k ~ N(0, 1) (times `mult`), v ~ N(1, 1) (a mean away from 0, so that
    delta is not small next to dP), dO ~ N(0, 1)."""
    q = (mult * torch.randn(b, s_q, h * d, generator=gen, device=dev)).to(dtype)
    k = (mult * torch.randn(b, s_kv, h * d, generator=gen, device=dev)).to(dtype)
    v = (torch.randn(b, s_kv, h * d, generator=gen, device=dev) + 1).to(dtype)
    dout = torch.randn(b, s_q, h * d, generator=gen, device=dev).to(dtype)
    return q, k, v, dout


def _check_grad_cases(torch, attn, cases, gen) -> dict:
    """`attention`'s gradient (K1 with LSE, then the dK/dV and dQ kernels)
    against the plain backward on each case. Returns, per backward kernel,
    the worst (max abs, rel RMS) over the bf16 path cases and the cases its
    outputs (dK and dV, or dQ) failed."""
    dev = torch.device("cuda")
    result = {name: {"max_abs_err": 0.0, "rel_rms_err": 0.0, "failed": []}
              for name in ("attention_dkv", "attention_dq")}
    owner = {"dk": "attention_dkv", "dv": "attention_dkv", "dq": "attention_dq"}
    for name, b, s_q, s_kv, h, d, dtype_name, mult in cases:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype_name]
        q, k, v, dout = _grad_case(torch, dev, gen, b, s_q, s_kv, h, d, dtype, mult)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        attn.COUNTS.reset()
        out = attn.attention(*leaves, num_heads=h, scale=d**-0.5)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches,
                  attn.COUNTS.bwd_dq_launches, attn.COUNTS.plain_calls)
        if counts != (1, 1, 1, 0):
            raise AssertionError(f"{name}: (K1, dK/dV, dQ, plain) launches {counts}")
        refs = attn.attention_backward_reference(q, k, v, out.detach(), dout, num_heads=h,
                                                 scale=d**-0.5)
        checks = attn.compare_grads_to_plain([x.grad for x in leaves], refs)
        log(f"[kernel-grad] {name}: (b={b}, s_q={s_q}, s_kv={s_kv}, h={h}, d={d}, {dtype}) "
            + ", ".join(f"{g} max_abs_err {e:.3e} rel_rms_err {r:.3e} {'ok' if ok else 'FAIL'}"
                        for g, (e, r, ok) in checks.items())
            + f" (tol {attn.GRAD_TOLERANCE[dtype]})")
        for g, (err, rel, ok) in checks.items():
            entry = result[owner[g]]
            if not ok and name not in entry["failed"]:
                entry["failed"].append(name)
            if name.startswith("path"):
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                entry["rel_rms_err"] = max(entry["rel_rms_err"], rel)
        del q, k, v, dout, leaves, out, refs
    return result


def phase_kernel_grad(torch, attn) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    result = _check_grad_cases(torch, attn, K1_GRAD_CASES, gen)
    failed = {k: v["failed"] for k, v in result.items() if v["failed"]}
    if failed:
        raise AssertionError(f"the backward kernels disagree with the plain backward: {failed}")

    times = {}
    for b, s, h, d in TRAIN_SHAPES:
        scale = d**-0.5
        q, k, v, dout = _grad_case(torch, dev, gen, b, s, s, h, d, torch.bfloat16, 1.0)
        lse = torch.empty(b, h, s, device=dev)
        out = attn._launch("attention", q, k, v, h, scale, lse=lse)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float().view(b, s, h, d),
                              k.float().view(b, s, h, d)) * scale
        lse_err = float((lse - torch.logsumexp(logits, dim=-1)).abs().max())
        del logits
        log(f"[kernel-grad] forward LSE (b={b}, s={s}, h={h}, d={d}): max abs error "
            f"{lse_err:.3e} against logsumexp of the fp32 logits (tol 1e-3)")
        if not lse_err <= 1e-3:
            raise AssertionError("the forward's log-sum-exp is wrong")
        delta = attn.backward_delta(out, dout, h)
        one = b * s * h * d * 2  # bytes of one (b, s, h*d) bf16 operand
        stats = b * h * s * 4  # bytes of one (b, h, s) fp32 row statistic
        qh, kh, vh, doh = (_heads_first(torch, x, h).requires_grad_() for x in (q, k, v, dout))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        fns = {
            "forward with LSE": (lambda: attn._launch("attention", q, k, v, h, scale, lse=lse),
                                 4 * b * h * s * s * d, 4 * one + stats),
            "attention_dkv": (lambda: attn._launch_backward("attention_dkv", q, k, v, dout, lse,
                                                            delta, h, scale),
                              8 * b * h * s * s * d, 6 * one + 2 * stats),
            "attention_dq": (lambda: attn._launch_backward("attention_dq", q, k, v, dout, lse,
                                                           delta, h, scale),
                             6 * b * h * s * s * d, 5 * one + 2 * stats),
            "plain backward": (lambda: attn.attention_backward_reference(
                q, k, v, out, dout, num_heads=h, scale=scale), 10 * b * h * s * s * d, 8 * one),
            "library backward": (lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                             retain_graph=True),
                                 10 * b * h * s * s * d, 8 * one),
        }
        for name, (fn, flop, nbytes) in fns.items():
            ms = _time_ms(torch, fn)
            bound = _bound(flop, nbytes)
            times[(name, b, s, d)] = ms
            times[("bound " + name, b, s, d)] = bound
            log(f"[kernel-grad] time (b={b}, s={s}, h={h}, d={d}, bf16): {name} {ms:.4f} ms "
                f"({flop / ms / 1e9:.1f} TFLOP/s); bound {bound[0]:.4f} ms ({bound[1]})")
        del fns, q, k, v, dout, lse, out, delta, qh, kh, vh, doh, lib_out
        torch.cuda.empty_cache()
    result["times"] = times

    # K2's backward is the plain recompute: against autograd of the plain version
    b, s, h, d = 9, 2048, 8, 40
    q, k, v, dout = _grad_case(torch, dev, gen, b, s, s, h, d, torch.bfloat16, 1.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.COUNTS.reset()
    attn.row_attention(*leaves, num_heads=h, scale=d**-0.5).backward(dout)
    rows = (attn.COUNTS.row_launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.plain_calls)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    attn.attention_reference(*plain, num_heads=h, scale=d**-0.5).backward(dout)
    checks = attn.compare_grads_to_plain([x.grad for x in leaves], [x.grad for x in plain])
    log(f"[kernel-grad] row_attention backward (b={b}, s={s}, h={h}, d={d}, bf16) against "
        "autograd of the plain version: "
        + ", ".join(f"{g} max_abs_err {e:.3e}" for g, (e, _, _) in checks.items())
        + f"; (K2, dK/dV, plain) launches {rows}")
    if rows != (1, 0, 0) or not all(ok for _, _, ok in checks.values()):
        raise AssertionError("row_attention's backward is not the plain recompute")
    return result


def phase_mutants(torch, attn) -> None:
    """Build each MUTANTS copy of the kernel sources (in csrc/build/, which
    git ignores) and show that every kernel its fault touches rejects it:
    both forward kernels' bf16 cases for a forward fault, both backward
    kernels' bf16 gradient cases for a backward fault. The real sources are
    loaded again at the end."""
    original = dict(attn.KERNELS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    passed = []
    try:
        for i, (what, file, old, new) in enumerate(MUTANTS):
            src = attn.BUILD_DIR / "mutants" / str(i)
            shutil.rmtree(src, ignore_errors=True)
            shutil.copytree(attn._CSRC, src, ignore=shutil.ignore_patterns("build"))
            header = src / file
            text = header.read_text()
            if text.count(old) != 1:
                raise AssertionError(f"mutant {what!r}: its text is not in {file} once")
            header.write_text(text.replace(old, new))
            attn.KERNELS.update({n: (src / path.name, entry) for n, (path, entry) in original.items()})
            attn._built.clear()
            attn.build_kernels()
            if file == "attention_common.cuh":
                for name, fn, cases in (("attention", attn.attention, K1_CASES),
                                        ("row_attention", attn.row_attention, K2_CASES)):
                    try:
                        _check_cases(torch, attn, fn, [c for c in cases if c[6] == "bf16"], gen)
                        passed.append(f"{what} ({name})")
                        log(f"[mutants] {what}: {name} PASSED the check")
                    except AssertionError as e:
                        log(f"[mutants] {what}: {name} rejected ({e})")
            else:
                result = _check_grad_cases(
                    torch, attn, [c for c in K1_GRAD_CASES if c[6] == "bf16"], gen)
                for name, entry in result.items():
                    if entry["failed"]:
                        log(f"[mutants] {what}: {name} rejected (cases {entry['failed']})")
                    else:
                        passed.append(f"{what} ({name})")
                        log(f"[mutants] {what}: {name} PASSED the check")
    finally:
        attn.KERNELS.update(original)
        attn._built.clear()
    attn.build_kernels()
    if passed:
        raise AssertionError(f"the kernel checks let mutants through: {passed}")


def phase_dsp(torch) -> None:
    import numpy as np

    from riffusion_tpu_torch.audio.segment import AudioSegment
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
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

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
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

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
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


def _movement_agreement(torch, ours: dict, ref: dict, start: dict) -> tuple:
    """(relative L2, max abs) of the difference between two runs' parameter
    movement from the same start."""
    a = torch.cat([(ours[k].cpu() - start[k].cpu()).flatten() for k in ref])
    b = torch.cat([(ref[k].cpu() - start[k].cpu()).flatten() for k in ref])
    return float((a - b).norm() / b.norm()), float((a - b).abs().max())


def phase_tiny_train(torch, attn) -> None:
    """Three fp32 trainer steps of the tiny UNet on the card and on the CPU,
    with the same weights, batch, t and noise: losses within 1e-4 relative,
    the parameters' movement within 1e-2 relative L2 (another sum order,
    which Adam amplifies on single elements whose gradient is near 0: their
    update is the gradient over its own magnitude, so the largest elementwise
    difference, printed, can reach a step's size and is not held)."""
    import numpy as np

    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    unet = random_bundle("tiny", seed=0, device="cpu").unet
    start = {k: v.clone() for k, v in unet.state_dict().items()}
    rng = np.random.default_rng(3)
    b, hw = 2, 32  # 32x32 latents: the 1024- and 256-query levels take K1
    latents = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    context = rng.standard_normal((b, 77, unet.cfg.cross_attention_dim)).astype(np.float32)
    draws = [(rng.integers(0, 1000, b), rng.standard_normal((b, hw, hw, 4)).astype(np.float32))
             for _ in range(3)]
    runs = {}
    for device in ("cuda", "cpu"):
        trainer = DiffusionTrainer(device=device, learning_rate=1e-3, dtype=torch.float32)
        trainer.init_from(unet)
        attn.COUNTS.reset()
        losses = [float(trainer.step(latents, context, t=t, noise=n)) for t, n in draws]
        counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches,
                  attn.COUNTS.bwd_dq_launches, attn.COUNTS.plain_calls)
        runs[device] = (losses, {k: v.cpu() for k, v in trainer.master.state_dict().items()},
                        counts)
    (loss_g, params_g, counts), (loss_c, params_c, _) = runs["cuda"], runs["cpu"]
    rel, worst = _movement_agreement(torch, params_g, params_c, start)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    log(f"[tiny train] 3 fp32 steps, cuda vs cpu: losses {[f'{x:.6f}' for x in loss_g]} vs "
        f"{[f'{x:.6f}' for x in loss_c]} (rel {loss_err:.2e}); movement rel L2 {rel:.3e}, "
        f"max abs {worst:.3e}; (K1, dK/dV, dQ, plain) launches on the card {counts}")
    if not (counts[0] > 0 and counts[0] == counts[1] == counts[2] and counts[3] == 0):
        raise AssertionError("the tiny train on the card did not go through K1 and its backward")
    if not (loss_err < 1e-4 and rel < 1e-2):
        raise AssertionError("the card's tiny train disagrees with the CPU's")


def _synth_clips(root: Path, files: int, clips_per_file: int, sr: int = 44100) -> None:
    """Deterministic music-like wav files (decaying partials, a beat, light
    noise), long enough for `clips_per_file` clips of 5.12 s each."""
    import numpy as np

    from riffusion_tpu_torch.audio.segment import AudioSegment

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    t = np.arange(int((clips_per_file * 5.12 + 0.05) * sr)) / sr
    for i in range(files):
        sig = sum(0.5 ** j * np.sin(2 * np.pi * f * (1 + 0.01 * i) * t + rng.uniform(0, 6.3))
                  for j, f in enumerate((110.0, 220.0, 330.0, 554.37, 880.0)))
        sig *= 0.55 + 0.45 * np.square(np.sin(2 * np.pi * (2.0 + i) * t))
        sig += 0.01 * rng.standard_normal(t.size)
        AudioSegment((sig / np.abs(sig).max() * 0.8 * 32767).astype(np.int16), sr).export(
            str(root / f"clip_{i}.wav"))


def _full_width_gradients(torch, attn, layers, ds_dir: Path) -> dict:
    """One step's loss and gradients at full width with the kernels, then
    the same step (weights, batch, t, noise) with the plain attention at
    the kernel sites (layers._ATTENTION_OPS swapped in this process only)."""
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.training import LatentDataset

    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.float32).unet
    trainer = DiffusionTrainer(device=dev, learning_rate=0.0, dtype=torch.bfloat16)
    trainer.init_from(unet)
    del unet
    latents, context = next(LatentDataset(ds_dir).batches(4, seed=0))
    gen = torch.Generator(device=dev).manual_seed(5)
    t = torch.randint(0, 1000, (4,), generator=gen, device=dev)
    noise = torch.randn(latents.shape, generator=gen, device=dev)

    attn.COUNTS.reset()
    loss_k = float(trainer.loss_and_grads(latents, context, t=t, noise=noise))
    counts = (attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.bwd_dq_launches,
              attn.COUNTS.plain_calls)
    grads_k = [p.grad.clone() for p in trainer.master.parameters()]
    kernel_op = layers._ATTENTION_OPS["flash"]
    layers._ATTENTION_OPS["flash"] = attn.attention_reference
    try:
        loss_p = float(trainer.loss_and_grads(latents, context, t=t, noise=noise))
    finally:
        layers._ATTENTION_OPS["flash"] = kernel_op
    grads_p = [p.grad for p in trainer.master.parameters()]
    diff = torch.sqrt(sum(torch.sum(torch.square(a - b)) for a, b in zip(grads_k, grads_p)))
    norm = torch.sqrt(sum(torch.sum(torch.square(b)) for b in grads_p))
    result = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
              "grad_rel_l2": float(diff / norm), "counts": counts}
    del trainer, grads_k, grads_p
    torch.cuda.empty_cache()
    return result


def phase_train(torch, attn, pipe) -> dict:
    """Fine-tuning at full width: the latent dataset from the random:full
    pipeline, run_finetune of 4 steps at batch 4, the kernels' gradients
    against the plain attention's, and the export reloaded and served."""
    import numpy as np

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.models import layers
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.serving import load_seed_image
    from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune

    work = REPO / ".chipwork"
    work.mkdir(exist_ok=True)
    free_gb = shutil.disk_usage(work).free / 1e9
    tmp = Path(tempfile.mkdtemp(prefix="train-", dir=work))
    log(f"[train] free disk before the run: {free_gb:.1f} GB ({work})")
    try:
        _synth_clips(tmp / "audio", files=2, clips_per_file=4)
        start = time.perf_counter()
        meta = build_latent_dataset(pipe, tmp / "audio", tmp / "dataset")
        log(f"[train] dataset: {meta.num_clips} clips, latents {meta.latent_shape}, contexts "
            f"{meta.context_shape}, in {time.perf_counter() - start:.1f} s")
        if meta.num_clips != 8 or tuple(meta.latent_shape) != (64, 64, 4):
            raise AssertionError(f"unexpected dataset: {meta}")

        marks = []

        def on_log(msg: str) -> None:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), (
                attn.COUNTS.launches, attn.COUNTS.bwd_dkv_launches, attn.COUNTS.bwd_dq_launches,
                attn.COUNTS.plain_calls), msg))
            log(f"[train] {msg}")

        torch.cuda.reset_peak_memory_stats()
        attn.COUNTS.reset()
        start = time.perf_counter()
        stats = run_finetune(FinetuneConfig(
            checkpoint="random:full", dataset_dir=str(tmp / "dataset"),
            output_dir=str(tmp / "run"), steps=4, batch_size=4, log_every=1, device="cuda",
        ), log=on_log)
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated() / 2**30
        step_marks = [m for m in marks if m[2].startswith("step ")]
        per_step = [tuple(b - a for a, b in zip(prev[1], cur[1]))
                    for prev, cur in zip([(0, (0, 0, 0, 0), "")] + step_marks, step_marks)]
        step_s = [b[0] - a[0] for a, b in zip(step_marks, step_marks[1:])]
        ckpt = stats["checkpoint"]
        log(f"[train] run_finetune: 4 steps at batch 4 in {wall:.2f} s wall (dataset load, "
            f"weights, steps, checkpoint, export); step time {statistics.median(step_s):.4f} s "
            f"(median of steps 2-4: {[f'{x:.4f}' for x in step_s]}); final loss "
            f"{stats['final_loss']:.5f}; peak device memory {peak:.2f} GiB; checkpoint "
            f"{ckpt['bytes'] / 1e9:.3f} GB in {ckpt['seconds']:.2f} s; (K1, dK/dV, dQ, plain) "
            f"launches per step {per_step}")
        if per_step != [(LAUNCHES_PER_STEP,) * 3 + (0,)] * 4:
            raise AssertionError(f"the training steps' launches {per_step} are not "
                                 f"{LAUNCHES_PER_STEP} K1, dK/dV and dQ each and no plain call")
        if not np.isfinite(stats["final_loss"]):
            raise AssertionError("non-finite training loss")
        launches = {"attention": sum(c[0] for c in per_step),
                    "attention_dkv": sum(c[1] for c in per_step),
                    "attention_dq": sum(c[2] for c in per_step)}

        grads = _full_width_gradients(torch, attn, layers, tmp / "dataset")
        log(f"[train] one full-width step, kernels against the plain attention: loss "
            f"{grads['loss_kernel']:.6f} vs {grads['loss_plain']:.6f} (rel {grads['loss_rel']:.3e}), "
            f"gradient rel L2 {grads['grad_rel_l2']:.3e} (bound {TRAIN_GRAD_BOUND}); "
            f"(K1, dK/dV, dQ, plain) launches with the kernels {grads['counts']}")
        if grads["counts"] != (LAUNCHES_PER_STEP,) * 3 + (0,):
            raise AssertionError("the gradient comparison's kernel step missed a kernel")
        if not (grads["grad_rel_l2"] <= TRAIN_GRAD_BOUND["grad_rel_l2"]
                and grads["loss_rel"] <= TRAIN_GRAD_BOUND["loss_rel"]):
            raise AssertionError("the kernels' gradients disagree with the plain attention's")

        start = time.perf_counter()
        tuned = RiffusionPipeline.load_checkpoint(stats["export_dir"], device="cuda")
        attn.COUNTS.reset()
        image, segment = tuned.riffuse_audio(
            InferenceInput(start=PromptInput(prompt="funky synth solo", seed=42),
                           end=PromptInput(prompt="jazzy saxophone", seed=123), alpha=0.5),
            load_seed_image(REPO / "seed_images", "og_beat"))
        torch.cuda.synchronize()
        samples = segment.raw_data.astype(np.float64)
        log(f"[train] export reloaded and one 50-step request riffused in "
            f"{time.perf_counter() - start:.2f} s: image {image.size}, pixel std "
            f"{np.asarray(image, np.float64).std():.2f}, audio {segment.duration_seconds:.2f} s "
            f"(std {samples.std():.0f}); K1 launches {attn.COUNTS.launches}")
        if image.size != (512, 512) or not np.asarray(image).std() > 0 \
                or not samples.std() > 100 or attn.COUNTS.launches != LAUNCHES_PER_REQUEST:
            raise AssertionError("the reloaded export did not serve a request")
        del tuned
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"launches": launches, "step_s": statistics.median(step_s), "peak_gib": peak,
            "grads": grads}


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
        log(f"[mutants] every one of {len(MUTANTS)} mutants was rejected by the checks of every "
            "kernel it touches")
        return 0
    kernel = phase_kernel(torch, attn)
    grad = phase_kernel_grad(torch, attn)
    phase_dsp(torch)
    phase_tiny(torch, attn)
    phase_tiny_batch(torch, attn)
    phase_tiny_train(torch, attn)

    start = time.perf_counter()
    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] random:full (UNet/CLIP bf16, VAE fp32) built on the card in "
        f"{time.perf_counter() - start:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    single = phase_slice(torch, attn, pipe)
    batch = phase_batch(torch, attn, pipe)
    train = phase_train(torch, attn, pipe)

    times, grad_times = kernel["times"], grad["times"]
    b, s, _, d = BATCH_SHAPE
    tb, ts, _, td = TRAIN_SHAPES[0]
    flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    entries = [  # name, source, replaces, ms, plain_ms, (bound ms, by), library_ms, launches
        ("attention", "attention.cu",
         f"{flash}:589 _flash_attention_impl (called from riffusion_tpu/models/layers.py:251)",
         times[("attention", 2, 4096, 40)], times[("plain", 2, 4096, 40)],
         times[("bound", 2, 4096, 40)], times[("library", 2, 4096, 40)],
         single["attention"] + batch["counts"]["attention"] + train["launches"]["attention"]),
        ("row_attention", "row_attention.cu",
         "riffusion_tpu/ops/attention.py:114 _forward (full_row_attention)",
         times[("row_attention", b, s, d)], times[("plain", b, s, d)],
         times[("bound", b, s, d)], times[("library", b, s, d)],
         single["row_attention"] + batch["counts"]["row_attention"]),
    ] + [
        # the plain and library times are of the whole backward (dQ, dK, dV)
        (name, f"{name}.cu", f"{flash}:{line} {fn}", grad_times[(name, tb, ts, td)],
         grad_times[("plain backward", tb, ts, td)], grad_times[("bound " + name, tb, ts, td)],
         grad_times[("library backward", tb, ts, td)], train["launches"][name])
        for name, line, fn in (("attention_dkv", 941, "_flash_attention_bwd_dkv"),
                               ("attention_dq", 1287, "_flash_attention_bwd_dq"))
    ]
    errors = {**kernel, **grad}
    log(smi)
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"riffusion_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": errors[name]["max_abs_err"],
        "rel_rms_err": errors[name]["rel_rms_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": library_ms,
    } for name, source, replaces, ms, plain_ms, bound, library_ms, launches in entries]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
