#!/usr/bin/env python3
"""
The control the limits of the SDXL serving cell are set against, on the
card at the cell's own size (the benchmark's runs never run this):

    python3 bench_port/limits_xl.py --workload <cell> --control-seeds <n>... [--out limits.json]

the plain SDXL reference in the program's place at the precision below
the configuration's (float8 products in the UNet and both towers, TF32 in
the VAE and the DSP), on as many requests as a run checks, judged by
check_serve_xl.py.

The program's own readings are the `compared` numbers of the cell's runs
(bench_port/run.py). PERF.md sets each limit between the largest reading of
the program and the smallest of the control, as limits.py does for the
first two cells.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import typing as T
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from bench_port import check_serve_xl, harness, sut_xl  # noqa: E402
from bench_port.reference import riffuse, sd, sdxl  # noqa: E402


def serve_control(cell, cfg, seed: int, device: str) -> T.Dict[str, float]:
    """The SDXL reference at float8 (UNet, towers) and TF32 (VAE, DSP) in the
    program's place."""
    serve = harness.traffic("serve")
    params = cell["params"]
    weights = check_serve_xl.reference_weights(cfg, sut_xl.weights(cfg, seed, device))
    stream = serve.request_stream(params, seed, 0)
    bodies = [next(stream) for _ in range(cell["check"]["sample"])]
    seed_image = sut_xl.seed_image(params)
    served = {}
    for body in bodies:
        image = sdxl.image(weights, body, seed_image, params["num_inference_steps"],
                           unet_nx=sd.Fp8Numerics(), vae_tf32=True)
        served[serve.request_key(body)] = (image, riffuse.audio(image, body, device,
                                                                dsp_tf32=True))
    keyed = {serve.request_key(b): b for b in bodies}
    return check_serve_xl.readings(weights, params, keyed, served, list(keyed))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="+", required=True)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    harness.cache_dirs(REPO)

    import torch

    if not torch.cuda.is_available():
        print("limits_xl: torch sees no CUDA card", file=sys.stderr)
        return 1
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    out: T.Dict[str, T.Any] = {"card": harness.card(), "control": {}}
    for seed in args.control_seeds:
        out["control"][seed] = serve_control(cell, cfg, seed, "cuda")
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
