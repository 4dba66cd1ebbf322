#!/usr/bin/env python3
"""
Time the port's forward attention kernels at the serving paths' shapes on a
CUDA card, for one checkout of the repository:

    python3 scripts/time_attention_kernels.py [--repo DIR] [--label NAME]

K1 (`ops.attention.attention`) at (2, 4096, 8*40) and (2, 1024, 8*80) bf16,
the single-clip path's sites, and K2 (`row_attention`) and K1 at
(32, 4096, 8*40), the batched path's: the median of 20 single calls each
(CUDA events, after 3 warm-up calls), the kernels built from DIR's sources.
`--repo` names the checkout whose riffusion_tpu_torch is imported (default:
this one), so that two versions are compared in one process each on the
same card: unpack the other into a directory .gitignore lists and run
parent, change, change, parent. Prints one JSON line with the card's name
and power limit.
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
    ("attention", 32, 4096, 8, 40),
    ("row_attention", 32, 4096, 8, 40),
)


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
    attn.build_kernels(("attention", "row_attention"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}
    for name, b, s, h, d in SHAPES:
        q, k, v = (torch.randn(b, s, h * d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        fn = getattr(attn, name)
        for _ in range(3):
            fn(q, k, v, num_heads=h, scale=d**-0.5)
        samples = []
        for _ in range(20):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(q, k, v, num_heads=h, scale=d**-0.5)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        times[f"{name} ({b}, {s}, {h}*{d})"] = statistics.median(samples)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"label": args.label, "repo": args.repo, "card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
