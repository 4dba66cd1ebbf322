#!/usr/bin/env python3
"""
Time the port's attention kernels at the paths' shapes on a CUDA card, for
one checkout of the repository:

    python3 scripts/time_attention_kernels.py [--repo DIR] [--label NAME]

The forward: K1 (`ops.attention.attention`) at (2, 4096, 8*40) and
(2, 1024, 8*80) bf16, the single-clip path's sites, and at
(32, 1024, 8*80), the batched path's seq-1024 sites; K2 (`row_attention`)
and K1 at (32, 4096, 8*40), the batched path's seq-4096 sites (K2's); the
library's forward (torch's scaled_dot_product_attention on heads-first
copies, a yardstick the port never calls) at each of these shapes. At the
fine-tuning path's (4, 4096, 8*40) and (4, 1024, 8*80), and at the
sharded step's sites (tp 2: (4, 4096, 4*40) and (4, 1024, 4*80); seq 2:
queries (4, 2048 | 512, 8*d) against keys (4, 4096 | 1024, 8*d)): K1 writing the
log-sum-exp, the plain PyTorch forward (ops.attention.attention_reference)
and the library's forward on operands that need gradients (so
that it too keeps its log-sum-exp); the dK/dV and dQ kernels alone,
the port's whole `attention_backward`
(delta, then both kernels: the row to hold against the library), and the
library's backward (torch's scaled_dot_product_attention through autograd,
a yardstick the port never calls). Each is the median of 20 single calls
(CUDA events, after 3 warm-up calls), the kernels built from DIR's sources.
`--repo` names the checkout whose riffusion_tpu_torch is imported (default:
this one), so that two versions are compared in one process each on the
same card: unpack the other into a directory .gitignore lists and run
parent, change, change, parent. Prints one JSON line with the card's name
and power limit, each time in ms, and TFLOP/s: each forward's
(4 * b*h*s_q*s_kv*d FLOP) and each backward's (8, 6, 14 and 10 *
b*h*s_q*s_kv*d: the kernels' products, and the library's five).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = (  # (kernel, batch, seq, heads, head_dim)
    ("attention", 2, 4096, 8, 40),
    ("attention", 2, 1024, 8, 80),
    ("attention", 32, 1024, 8, 80),
    ("attention", 32, 4096, 8, 40),
    ("row_attention", 32, 4096, 8, 40),
    ("library forward", 2, 4096, 8, 40),
    ("library forward", 2, 1024, 8, 80),
    ("library forward", 32, 1024, 8, 80),
    ("library forward", 32, 4096, 8, 40),
)
TRAIN_SHAPES = (  # (batch, queries, keys, heads, head_dim)
    (4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80),  # one device
    (4, 4096, 4096, 4, 40), (4, 1024, 1024, 4, 80),  # tp 2
    (4, 2048, 4096, 8, 40), (4, 512, 1024, 8, 80),  # seq 2
)
FLOP = {"attention with LSE": 4, "library forward": 4, "plain forward": 4,
        "attention_dkv": 8, "attention_dq": 6,
        "attention_backward": 14, "library backward": 10}  # times b*h*s_q*s_kv*d


def _median_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    samples = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def _forward(torch, attn, name, q, k, v, h):
    """One call of a forward kernel's wrapper, or of the library's forward
    on heads-first copies of q, k, v."""
    b, s, inner = q.shape
    d = inner // h
    if name != "library forward":
        kernel = getattr(attn, name)
        return lambda: kernel(q, k, v, num_heads=h, scale=d**-0.5)
    qh, kh, vh = (x.view(b, s, h, d).transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=d**-0.5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--label", default="")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_attention_kernels: no CUDA device")
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from riffusion_tpu_torch.ops import attention as attn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times, tflops = {}, {}
    for name, b, s, h, d in SHAPES:
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        key = f"{name} ({b}, {s}, {h}*{d})"
        times[key] = _median_ms(torch, _forward(torch, attn, name, q, k, v, h))
        tflops[key] = 4 * b * h * s * s * d / times[key] / 1e9
        del q, k, v
        torch.cuda.empty_cache()
    for b, s_q, s_kv, h, d in TRAIN_SHAPES:
        scale = d**-0.5
        q, k, v, dout = (torch.randn(b, n, h * d, generator=gen, device=dev).to(torch.bfloat16)
                         for n in (s_q, s_kv, s_kv, s_q))
        lse = torch.empty(b, h, s_q, device=dev)
        out = attn._launch("attention", q, k, v, h, scale, lse=lse)
        delta = attn.backward_delta(out, dout, h)
        qh, kh, vh, doh = (x.view(b, x.shape[1], h, d).transpose(1, 2).contiguous()
                           .requires_grad_() for x in (q, k, v, dout))
        lib_out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        fns = {
            "attention with LSE": lambda: attn._launch("attention", q, k, v, h, scale, lse=lse),
            "library forward": lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, scale=scale),
            "plain forward": lambda: attn.attention_reference(q, k, v, num_heads=h, scale=scale),
            "attention_dkv": lambda: attn._launch_backward("attention_dkv", q, k, v, dout, lse,
                                                           delta, h, scale),
            "attention_dq": lambda: attn._launch_backward("attention_dq", q, k, v, dout, lse,
                                                          delta, h, scale),
            "attention_backward": lambda: attn.attention_backward(q, k, v, out, dout, lse,
                                                                  num_heads=h, scale=scale),
            "library backward": lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                            retain_graph=True),
        }
        seq = f"{s_q}" if s_q == s_kv else f"{s_q}|{s_kv}"
        for name, fn in fns.items():
            key = f"{name} ({b}, {seq}, {h}*{d})"
            times[key] = _median_ms(torch, fn)
            tflops[key] = FLOP[name] * b * h * s_q * s_kv * d / times[key] / 1e9
        del q, k, v, dout, lse, out, delta, qh, kh, vh, doh, lib_out, fns
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "repo": args.repo, "card": card, "ms": times,
                      "tflops": tflops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
