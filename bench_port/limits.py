#!/usr/bin/env python3
"""
The readings a cell's limits are set from, on the card at the cell's own
size (the benchmark's runs never run this):

    python3 bench_port/limits.py --workload <cell> --seeds <n>... \\
        --control-seeds <n>... [--seconds 4] [--out limits.json]

- the program: for each of `--seeds`, a run of the cell's driver with a
  short window at the cell's own load, and the numbers its check compares;
- the control: for each of `--control-seeds`, the plain reference put in
  the program's place at the precision below the configuration's (float8
  products where it states bfloat16, TF32 where it states float32 with
  TF32 off, the EMA's update in bfloat16 where it states float32 masters),
  judged by the same check;
- for a training cell, the faults that the program could have, planted in
  the reference put in its place: half of each batch left out (the mean
  over the rest). A step or an EMA update that leaves the state unchanged
  reads a change gap or an EMA gap of 1 by definition and needs no run.

PERF.md sets each limit between the largest reading of the program and the
smallest of the control and the faults.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import typing as T
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from bench_port import check_serve, check_train, harness, sut  # noqa: E402
from bench_port.reference import riffuse, sd, train  # noqa: E402


def program_readings(cell, cfg, seed: int, seconds: float, device: str) -> T.Dict[str, float]:
    record = harness.Record(cell=cell, config=cfg, seed=seed, seconds=seconds, trace=False,
                            started=time.monotonic(), device=device)
    harness.traffic(cell["kind"]).run(record)
    out = dict(record.notes.get("readings") or {c.name: c.value for c in record.checks})
    out["failed"] = record.failed
    out.update({k: record.notes[k] for k in ("worst_leaf",) if k in record.notes})
    if "loss_gaps" in record.notes:
        out["loss_gaps"] = record.notes["loss_gaps"]
    return out


def serve_control(cell, cfg, seed: int, device: str) -> T.Dict[str, float]:
    """The reference at float8 (UNet, CLIP) and TF32 (VAE, DSP) in the
    program's place, on as many requests as a run checks."""
    import numpy as np
    from PIL import Image

    serve = harness.traffic("serve")
    params = cell["params"]
    states = sut.weights(cfg, seed, device)
    weights = check_serve.reference_weights(cfg, states)
    stream = serve.request_stream(params, seed, 0)
    bodies = [next(stream) for _ in range(cell["check"]["sample"])]
    seed_image = np.asarray(Image.open(sut.INPUTS / f"{params['seed_image_id']}.png")
                            .convert("RGB"))
    served = {}
    for body in bodies:
        image = riffuse.image(weights, body, seed_image, params["num_inference_steps"],
                              unet_nx=sd.Fp8Numerics(), vae_tf32=True)
        served[serve.request_key(body)] = (image, riffuse.audio(image, body, device,
                                                                dsp_tf32=True))
    keyed = {serve.request_key(b): b for b in bodies}
    return check_serve.readings(weights, keyed, served, list(keyed),
                                params["num_inference_steps"])


def train_readings(cell, cfg, seed: int, device: str, nx=sd.FP32, half: bool = False
                   ) -> T.Dict[str, float]:
    """The reference with `nx` products (and, where they are not float32,
    the EMA's update in bfloat16), or fed half of each batch, in the
    program's place, judged against the float32 reference."""
    import torch

    finetune = harness.traffic("finetune")
    states = sut.weights(cfg, seed, device, models=("unet",))
    arrays = finetune.dataset_arrays(cfg, seed)
    data = finetune.data_seed(seed)
    batch = cell["params"]["batch_size"]
    state = sd.widened(states["unet"])
    ref = check_train.reference_readings(cfg, state, arrays, data, batch,
                                         finetune.CHECKED_STEPS)
    planted = check_train.reference_readings(cfg, state, arrays, data, batch,
                                             finetune.CHECKED_STEPS, nx,
                                             keep_rows=batch // 2 if half else None)
    out = check_train.readings(planted, ref)
    dtype = torch.float32 if nx is sd.FP32 else torch.bfloat16
    decay = cfg["finetune"]["ema_decay"]
    out["ema_gap"], _ = check_train.ema_gap(
        states["unet"], seed, decay,
        lambda key, ema, params: train.ema_update(ema, params, decay, dtype))
    out["loss_gaps"] = [(p - r) / r for p, r in zip(planted["losses"], ref["losses"])]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    harness.cache_dirs(REPO)

    import torch

    if not torch.cuda.is_available():
        print("limits: torch sees no CUDA card", file=sys.stderr)
        return 1
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    out: T.Dict[str, T.Any] = {"card": harness.card(), "program": {}, "control": {}}
    for seed in args.seeds:
        out["program"][seed] = program_readings(cell, cfg, seed, args.seconds, "cuda")
        print("program", seed, out["program"][seed], flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        if cell["kind"] == "serve":
            out["control"][seed] = serve_control(cell, cfg, seed, "cuda")
        else:
            out["control"][seed] = train_readings(cell, cfg, seed, "cuda",
                                                  nx=train.Fp8TrainNumerics())
            gc.collect()
            torch.cuda.empty_cache()
            out.setdefault("half_batch", {})[seed] = train_readings(cell, cfg, seed, "cuda",
                                                                   half=True)
            print("half batch", seed, out["half_batch"][seed], flush=True)
        print("control", seed, out["control"][seed], flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
