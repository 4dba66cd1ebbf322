#!/usr/bin/env python3
"""
Time the NHWC GroupNorm kernel (riffusion_tpu_torch/ops/group_norm.py) on a
CUDA card at each GroupNorm site of the SD v1 UNet, and one evaluation of
random:full's UNet at the single clip's batch 2, for one or more launch
geometries:

    python3 scripts/time_group_norm.py [--tiling THREADS:BLOCKS_PER_SM ...] [--nchw]

The sites are read from the UNet itself (a hook on each GroupNorm of one
evaluation at a 64x64 latent, bf16): (channels, H, W, SiLU) and how often
each occurs. For each `--tiling` (ops.group_norm's TARGET_THREADS and
BLOCKS_PER_SM; default: the module's own) it prints the kernel's device
time per call at each site, their sum over one evaluation's 61 calls, and
the evaluation's time. `--nchw` also times the evaluation with the UNet in
NCHW (torch's GroupNorm and cuDNN's layout transposes, the layout before
the serving UNet went NHWC). Every time is device time out of a CUDA graph
(20 calls a graph for a kernel, one evaluation a graph; the median of 20
replays, CUDA events), so the host's launches are not in it. One JSON line
on standard output, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CALLS = 20


def _graph_ms(torch, fn, calls: int, reps: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / calls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tiling", nargs="*", default=[],
                        help="THREADS:BLOCKS_PER_SM pairs to time (default: the module's)")
    parser.add_argument("--nchw", action="store_true", help="also time the UNet in NCHW")
    args = parser.parse_args(argv)

    import torch

    from riffusion_tpu_torch.models import layers
    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.ops import group_norm as gn
    from riffusion_tpu_torch.util import torch_util

    if not torch.cuda.is_available():
        raise SystemExit("time_group_norm: no CUDA card")
    torch_util.configure_numerics()
    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.bfloat16).unet.eval()
    nhwc = unet.to(memory_format=torch.channels_last)
    gen = torch.Generator(device=dev).manual_seed(0)
    latents = torch.randn(2, 4, 64, 64, generator=gen, device=dev)
    t = torch.tensor([801, 801], device=dev)
    ctx = torch.randn(2, 77, 768, generator=gen, device=dev, dtype=torch.bfloat16)

    sites = collections.Counter()

    def hook(module, inputs, kwargs):
        x = inputs[0]
        sites[(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
               bool(kwargs.get("silu", inputs[1] if len(inputs) > 1 else False)))] += 1

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in nhwc.modules() if isinstance(m, layers.GroupNorm)]
    with torch.inference_mode():
        nhwc(latents, t, ctx)
    for h in handles:
        h.remove()

    default = (gn.TARGET_THREADS, gn.BLOCKS_PER_SM)
    tilings = [tuple(int(v) for v in s.split(":")) for s in args.tiling] or [default]
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "sites": {}, "tilings": {}}
    inputs = {}
    for (b, c, h, w, silu), n in sorted(sites.items()):
        x, weight, bias = gn.check_inputs(b, c, h, w, torch.bfloat16, dev, seed=c + h)
        inputs[(b, c, h, w, silu)] = (x, weight, bias)
        out["sites"][f"{b}x{c}x{h}x{w}{' silu' if silu else ''}"] = {
            "count": n, "bound_ms": 4 * x.numel() / 3.35e12 * 1e3}
    with torch.inference_mode():
        for threads, per_sm in tilings:
            gn.TARGET_THREADS, gn.BLOCKS_PER_SM = threads, per_sm
            per_site, total = {}, 0.0
            for key, (x, weight, bias) in inputs.items():
                b, c, h, w, silu = key
                ms = _graph_ms(torch, lambda: gn.group_norm(x, weight, bias, 32, 1e-5, silu=silu),
                               CALLS)
                per_site[f"{b}x{c}x{h}x{w}{' silu' if silu else ''}"] = ms
                total += ms * sites[key]
            unet_ms = _graph_ms(torch, lambda: nhwc(latents, t, ctx), 1)
            out["tilings"][f"{threads}:{per_sm}"] = {"per_site_ms": per_site,
                                                     "per_evaluation_ms": total,
                                                     "unet_ms": unet_ms}
            print(f"tiling {threads}:{per_sm}: GroupNorm {total:.3f} ms an evaluation, "
                  f"UNet {unet_ms:.3f} ms", file=sys.stderr, flush=True)
        gn.TARGET_THREADS, gn.BLOCKS_PER_SM = default
        if args.nchw:
            nchw = unet.to(memory_format=torch.contiguous_format)
            out["unet_nchw_ms"] = _graph_ms(torch, lambda: nchw(latents, t, ctx), 1)
            nhwc = nchw.to(memory_format=torch.channels_last)
            out["unet_nhwc_ms"] = _graph_ms(torch, lambda: nhwc(latents, t, ctx), 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
