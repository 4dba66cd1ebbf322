"""
Where a fine-tuning step's time goes on the card: `DiffusionTrainer` at
full SD v1 width (random:full, fp32 masters, bf16 compute), UNet batch 4 on
64x64x4 latents with (4, 77, 768) contexts, AdamW and an EMA update as
`run_finetune` runs them.

    python -m riffusion_tpu_torch.profile_train [--out result.json]

Prints, and writes as JSON with --out:
- the card's name and power limit;
- the step time (host clock, each step ending in torch.cuda.synchronize)
  of 5 steps after 3 warm-up steps, and the peak device memory;
- for 2 further steps under torch.profiler: each part's kernel time (the
  kernels that start in the device range of the riffusion.train.copy,
  .forward, .grads or .ema span or of AdamW's own annotation, and the
  backward's, which start in none of them), the device's busy time
  (the sum of kernel and copy times; one stream) against the steps' wall
  time, the attention kernels' time (K1 forward, dK/dV, dQ), and the 15
  kernels with the most device time;
- the SM clock, power and clock-event reasons over each window
  (profile_batch.ClockSampler).
The batch is random (a seeded torch.Generator on the card): a step's work
does not depend on the values.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the result as JSON here")
    args = parser.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from riffusion_tpu_torch.models.weights import random_bundle
    from riffusion_tpu_torch.ops import attention as attn
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.profile_batch import ClockSampler
    from riffusion_tpu_torch.training.finetune import ema_update

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    clocks = ClockSampler()

    dev = torch.device("cuda")
    unet = random_bundle("full", seed=0, device=dev, dtype=torch.float32).unet
    trainer = DiffusionTrainer(device=dev, learning_rate=1e-5, dtype=torch.bfloat16)
    trainer.init_from(unet)
    del unet
    params = dict(trainer.master.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    latents = torch.randn(4, 64, 64, 4, generator=gen, device=dev)
    context = torch.randn(4, 77, 768, generator=gen, device=dev)

    def step() -> float:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer.step(latents, context, generator=gen)
        with record_function("riffusion.train.ema"):
            ema_update(ema, params, 0.999)
        torch.cuda.synchronize()
        return time.monotonic() - t0

    for _ in range(3):
        step()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    times = [step() for _ in range(5)]
    result: dict = {
        "card": card, "batch": 4, "latents": [64, 64, 4],
        "step_s": times, "step_s_median": statistics.median(times),
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "clocks": clocks.summary(t0, time.monotonic()),
    }
    print(f"steps {[f'{x:.4f}' for x in times]} s (median {result['step_s_median']:.4f}), "
          f"peak {result['max_memory_allocated_gib']:.2f} GiB, clocks {result['clocks']}",
          flush=True)

    attn.COUNTS.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        wall = sum(step() for _ in range(2))
        t1 = time.monotonic()
    clocks.stop()

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # The device-side ranges of the riffusion.train.* spans and of AdamW's own
    # annotation; each kernel's time goes to the range it starts in. The
    # backward runs on autograd's thread, whose launches no range of this
    # thread covers: its kernels are those outside every range.
    annotations = [e for e in events if getattr(e, "is_user_annotation", False)
                   or e.name.startswith("riffusion.")]
    kernels = [e for e in events if e not in annotations]
    ranges = [(a.time_range.start, a.time_range.end, a.name) for a in annotations
              if a.name != "riffusion.train.optimizer"]  # AdamW's annotation is inside
    spans: dict = {}
    for k in kernels:
        part = next((name for start, end, name in ranges if start <= k.time_range.start < end),
                    "backward (outside every range)")
        spans[part] = spans.get(part, 0.0) + k.time_range.elapsed_us() / 1e3
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    attention_ms = {
        label: sum(t for n, (t, _) in by_name.items() if key in n)
        for label, key in (("k1_forward", "attention_bf16_kernel"),
                           ("dkv", "attention_dkv_bf16_kernel"),
                           ("dq", "attention_dq_bf16_kernel"))
    }
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    result["profiled"] = {
        "steps": 2,
        "wall_s": wall,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        # the unprofiled steps' share, from the profiled busy time: an estimate
        "device_idle_share_unprofiled_estimate":
            1.0 - busy_ms / 2 / (result["step_s_median"] * 1e3),
        "device_ops": len(kernels),
        "launches": {"k1": attn.COUNTS.launches, "dkv": attn.COUNTS.bwd_dkv_launches,
                     "dq": attn.COUNTS.bwd_dq_launches, "plain": attn.COUNTS.plain_calls},
        "kernel_ms_by_part": spans,
        "attention_ms": attention_ms,
        "clocks": clocks.summary(t0, t1),
        "top_kernels": [{"name": n[:120], "ms": t, "count": c} for n, (t, c) in top],
    }
    p = result["profiled"]
    print(f"2 profiled steps {wall:.4f} s: device busy {busy_ms:.1f} ms (idle share "
          f"{p['device_idle_share']:.4f} under the profiler; unprofiled estimate "
          f"{p['device_idle_share_unprofiled_estimate']:.4f}), {len(kernels)} device ops, "
          f"launches {p['launches']}, attention "
          f"{', '.join(f'{k} {v:.2f} ms' for k, v in attention_ms.items())}")
    for name, ms in spans.items():
        print(f"  {name}: {ms:.2f} ms of kernel time")
    for name, (t, c) in top:
        print(f"  {t:9.2f} ms {c:6d}x {name[:100]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
