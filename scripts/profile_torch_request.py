"""
Where one /run_inference/ request's time goes on the card, for the PyTorch
port (riffusion_tpu_torch): the single-clip path at full SD v1 width
(random weights), og_beat seed, 50 PNDM steps, default strength, run as the
server runs it (its program captured into a CUDA graph and replayed,
riffusion_tpu_torch/aot.py) and eagerly (RIFFUSION_TPU_NO_AOT=1).

    python scripts/profile_torch_request.py [--out result.json]

Prints, and writes as JSON with --out, the card's name and power limit and,
for each of "graph" and "eager":
- the wall time of the first request (with graphs: the warm-up and the
  capture) and of 5 requests after it (host clock, ending in
  torch.cuda.synchronize);
- for one further request under torch.profiler: the device's busy time
  (the sum of kernel and copy times; one stream, so they do not overlap)
  against the request's wall time, the device operations, the 15 kernels
  with the most device time, and the attention kernel's share. The
  profiler slows the host, so an eager request's idle share is larger
  under it than without it.
- eager only: each pipeline stage's span on the host and on the device
  (the riffusion.* record_function spans). A replayed graph is one launch
  to the profiler, so the stages are read from the eager run, which runs
  the same kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# K1's kernels as the profiler names them (csrc/attention_fwd.cuh's bf16
# body, which K2 also runs but the single-clip path never reaches, and
# csrc/attention_common.cuh's fp32 instance)
ATTENTION_KERNELS = ("attention_fwd_bf16_kernel", "attention_f32_kernel")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    args = parser.parse_args(argv)

    import torch
    from PIL import Image
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.spectrogram_params import SpectrogramParams

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_request: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    pipe = RiffusionPipeline.load_checkpoint("random:full", device="cuda")
    seed_path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "seed_images", "og_beat.png")
    image = Image.open(seed_path).convert("RGB")
    params = SpectrogramParams(min_frequency=0, max_frequency=10000, num_frequencies=512)

    def request(i: int) -> float:
        inputs = InferenceInput(
            start=PromptInput(prompt="funky synth solo", seed=42 + i),
            end=PromptInput(prompt="jazzy saxophone", seed=123 + i),
            alpha=0.5, num_inference_steps=50,
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.riffuse_audio(inputs, image, params=params)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    result = {"card": card, "checkpoint": "random:full"}
    for mode in ("graph", "eager"):
        if mode == "eager":
            os.environ["RIFFUSION_TPU_NO_AOT"] = "1"
        first_s = request(0)
        walls = [request(1 + i) for i in range(5)]
        print(f"{mode}: first request {first_s:.3f} s; requests {[round(w, 4) for w in walls]} "
              f"s, median {statistics.median(walls):.4f} s", flush=True)
        attn.COUNTS.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = request(99)
        result[mode] = _trace(prof, profiled_s, DeviceType.CUDA)
        result[mode].update(first_request_s=first_s, request_s=walls,
                            request_s_median=statistics.median(walls),
                            attention_kernel_launches=attn.COUNTS.launches)
        r = result[mode]
        print(f"{mode}: profiled request {profiled_s:.4f} s: device busy "
              f"{r['device_busy_ms']:.1f} ms (idle share {r['device_idle_share']}), "
              f"{r['kernel_launches']} device ops, attention kernel "
              f"{r['attention_kernel_ms']:.1f} ms over {attn.COUNTS.launches} launches")
        for name, spans in r["stages"].items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
        for k in r["top_kernels"]:
            print(f"  {k['ms']:9.2f} ms {k['count']:6d}x {k['name'][:100]}")
    os.environ.pop("RIFFUSION_TPU_NO_AOT", None)
    result["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({mode: {k: v for k, v in result[mode].items()
                             if k not in ("top_kernels", "stages")} for mode in ("graph", "eager")}))
    return 0


def _trace(prof, wall_s: float, cuda) -> dict:
    """A profiled request's device side: busy time (kernels and copies),
    idle share of `wall_s` (None where the trace shows no device work),
    operations, the riffusion.* stage spans, the top kernels and the
    attention kernel's time."""
    events = prof.events()
    stages: dict = {}
    for e in events:
        if not e.name.startswith("riffusion."):
            continue
        entry = stages.setdefault(e.name, {})
        side = "device_span_ms" if e.device_type == cuda else "host_span_ms"
        entry[side] = entry.get(side, 0.0) + e.time_range.elapsed_us() / 1e3
    kernels = [e for e in events if e.device_type == cuda and not e.name.startswith("riffusion.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "profiled_request_s": wall_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3) if kernels else None,
        "kernel_launches": len(kernels),
        "attention_kernel_ms": sum(t for name, (t, _) in by_name.items()
                                   if any(key in name for key in ATTENTION_KERNELS)),
        "stages": stages,
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
    }


if __name__ == "__main__":
    sys.exit(main())
