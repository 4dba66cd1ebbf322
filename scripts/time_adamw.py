#!/usr/bin/env python3
"""
Time one AdamW step over SD v1's UNet (random:full: 686 leaves, 859.5 M
parameters) as the fine-tuning step on one card takes it, fp32 masters and
the bf16 working copy of parallel/train.py `compute_copy`, three ways:

    python3 scripts/time_adamw.py [--blocks-per-sm N ...]

- "one_pass": ops.adamw.OnePassAdamW reading the working copy's gradients
  (csrc/adamw.cu), once for each --blocks-per-sm (ops.adamw.BLOCKS_PER_SM;
  default: the module's own);
- "foreach": the trainer's hand-off before this kernel (`master.grad =
  work.grad.to(float32)`: a cast a bf16 leaf, the fp32 leaves passed as
  they are), then torch.optim.AdamW(capturable=True), which runs foreach;
- "fused": the same hand-off, then torch.optim.AdamW(fused=True,
  capturable=True), the library's one-kernel AdamW, timed here as the
  comparison (the port never calls it).
Each method's step is captured in a CUDA graph after a warm-up step (which
makes the optimizer's state) and its device time is the median of 20
replays (CUDA events), so the host's launches are not in it. For each: the
ms, the least bytes it moves (the one pass: the gradient in its dtype read,
master, m and v read and written, 26 bytes a bf16 parameter; the others add
the cast's bf16 read and fp32 write and read the fp32 gradient, 34), and
the share of 3.35 TB/s over its own bytes and over the one pass's. One JSON
line on standard output, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PEAK_BYTES = 3.35e12  # H100 SXM's HBM3, bytes/s
REPLAYS = 20


def _graph_ms(torch, fn) -> float:
    """Median device ms of fn() captured once and replayed REPLAYS times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the warm-up: the optimizer's state
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(REPLAYS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks-per-sm", type=int, nargs="*", default=[],
                        help="the one pass's grid, blocks per SM (default: the module's)")
    args = parser.parse_args(argv)

    import torch

    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.ops import adamw
    from riffusion_tpu_torch.parallel.train import compute_copy
    from riffusion_tpu_torch.util import torch_util

    if not torch.cuda.is_available():
        raise SystemExit("time_adamw: no CUDA card")
    torch_util.configure_numerics()
    dev = torch.device("cuda")
    master = random_bundle("full", seed=0, device=dev).unet.train()
    work = compute_copy(master, torch.bfloat16)
    masters, working = list(master.parameters()), list(work.parameters())
    gen = torch.Generator(device=dev).manual_seed(0)
    for w in working:
        w.grad = (torch.randn(w.shape, generator=gen, device=dev) * 1e-3).to(w.dtype)
    lr = torch.tensor(1e-5, device=dev)
    hyper = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2, capturable=True)

    n_bf16 = sum(w.numel() for w in working if w.dtype == torch.bfloat16)
    n_f32 = sum(w.numel() for w in working if w.dtype == torch.float32)
    one_pass_bytes = 26 * n_bf16 + 28 * n_f32
    handed_bytes = 34 * n_bf16 + 28 * n_f32
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(),
        "leaves": len(masters), "parameters": n_bf16 + n_f32, "bf16_parameters": n_bf16,
        "one_pass_launches": adamw.launches([p.numel() for p in masters]),
        "bound_ms": one_pass_bytes / PEAK_BYTES * 1e3, "methods": {}}

    def record(name: str, ms: float, own_bytes: int) -> None:
        out["methods"][name] = {
            "ms": ms, "bytes": own_bytes,
            "share_of_peak_own_bytes": own_bytes / (ms / 1e3) / PEAK_BYTES,
            "share_of_peak_one_pass_bytes": one_pass_bytes / (ms / 1e3) / PEAK_BYTES}
        print(f"{name}: {ms:.3f} ms, {own_bytes / 1e9:.2f} GB", file=sys.stderr, flush=True)

    default = adamw.BLOCKS_PER_SM
    for per_sm in args.blocks_per_sm or [default]:
        adamw.BLOCKS_PER_SM = per_sm
        opt = adamw.OnePassAdamW(masters, working=working, **hyper)
        record(f"one_pass:{per_sm}", _graph_ms(torch, opt.step), one_pass_bytes)
        del opt
    adamw.BLOCKS_PER_SM = default

    def hand_off() -> None:
        for w, m in zip(working, masters):
            m.grad = w.grad.to(torch.float32)

    for name, extra in (("foreach", {}), ("fused", {"fused": True})):
        opt = torch.optim.AdamW(masters, **hyper, **extra)

        def step(opt=opt) -> None:
            hand_off()
            opt.step()

        record(name, _graph_ms(torch, step), handed_bytes)
        for m in masters:
            m.grad = None
        del opt
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
