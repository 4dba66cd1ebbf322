"""
Where one /run_inference/ request's time goes on the card, for the PyTorch
port (riffusion_tpu_torch): the single-clip path at full SD v1 width
(random weights), og_beat seed, 50 PNDM steps, default strength.

    python scripts/profile_torch_request.py [--out result.json]

Prints, and writes as JSON with --out:
- the card's name and power limit;
- the wall time of each of 5 requests after one warm-up request
  (host clock, ending in torch.cuda.synchronize);
- for one further request under torch.profiler: each pipeline stage's span
  on the host and on the device (the riffusion.* record_function spans), the
  device's busy time (the sum of kernel and copy times; one stream, so they
  do not overlap) against the same request's wall time, the 15 kernels with
  the most device time, and the attention kernel's share. The profiler slows
  the host, so that request's idle share is larger than an unprofiled one's;
  the unprofiled requests' device time is not measured.
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

    warmup_s = request(0)
    walls = [request(1 + i) for i in range(5)]
    print(f"warm-up request {warmup_s:.3f} s; requests {[round(w, 4) for w in walls]} s, "
          f"median {statistics.median(walls):.4f} s", flush=True)

    attn.COUNTS.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_s = request(99)

    events = prof.events()
    device_events = [e for e in events if e.device_type == DeviceType.CUDA]
    stages: dict = {}
    for e in events:
        if not e.name.startswith("riffusion."):
            continue
        entry = stages.setdefault(e.name, {})
        side = "device_span_ms" if e.device_type == DeviceType.CUDA else "host_span_ms"
        entry[side] = entry.get(side, 0.0) + e.time_range.elapsed_us() / 1e3
    kernels = [e for e in device_events if not e.name.startswith("riffusion.")]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    attn_ms = sum(t for name, (t, _) in by_name.items()
                  if "attention_bf16_kernel" in name or "attention_f32_kernel" in name)

    result = {
        "card": card,
        "checkpoint": "random:full",
        "warmup_request_s": warmup_s,
        "request_s": walls,
        "request_s_median": statistics.median(walls),
        "profiled_request_s": profiled_s,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (profiled_s * 1e3),
        "kernel_launches": len(kernels),
        "attention_kernel_ms": attn_ms,
        "attention_kernel_launches": attn.COUNTS.launches,
        "stages": stages,
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"profiled request {profiled_s:.4f} s: device busy {busy_ms:.1f} ms "
          f"(idle share {result['device_idle_share']:.3f}), {len(kernels)} device ops, "
          f"attention kernel {attn_ms:.1f} ms over {attn.COUNTS.launches} launches")
    for name, spans in stages.items():
        print(f"  {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
    for name, (t, c) in top:
        print(f"  {t:9.2f} ms {c:6d}x {name[:100]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k not in ("top_kernels", "stages")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
