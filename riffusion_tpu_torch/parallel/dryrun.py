"""
The multi-process serving dryrun: the port's counterpart of the serving
half of the JAX package's `__graft_entry__.dryrun_multichip`. On every
rank of a world of n it runs `dryrun_serving_batch` (a data-parallel
riffuse_audio_batch over a (data, model) mesh) and `dryrun_tp_serving` (one
tensor-parallel request) on the tiny model. The JAX package's
`dryrun_train_step` (the sharded fine-tuning step) is not ported yet, so
this runs no train step.

    python -m riffusion_tpu_torch.parallel.dryrun --n 2
        spawns n ranks on this host: on its cards (nccl with a card per
        rank, gloo where ranks share cards), or on the CPU over gloo where
        it has none or with --device cpu, as the JAX package's dryrun runs
        on virtual CPU devices;
    torchrun --nproc-per-node N -m riffusion_tpu_torch.parallel.dryrun
        runs in place on each rank torchrun starts, one card each over nccl
        (gloo on the CPU where there is no card, or with --device cpu).
"""

from __future__ import annotations

import argparse
import os
import sys
import typing as T

import torch.distributed as dist


def serving_checks(rank: int, world_size: int, device: str) -> T.Tuple[int, float]:
    """Both serving dryruns on this rank of an initialized world: (requests
    served by the data-parallel batch, seconds of the tensor-parallel clip)."""
    from riffusion_tpu_torch.parallel.sweep import dryrun_serving_batch
    from riffusion_tpu_torch.parallel.tp_serving import dryrun_tp_serving

    served = dryrun_serving_batch(world_size, device=device)
    seconds = dryrun_tp_serving(world_size, device=device)
    return served, seconds


def main(argv: T.Optional[T.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    parser.add_argument("--n", type=int, default=2, help="ranks to spawn (without torchrun)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the ranks run (default: cuda where this host has a card, "
                             "else cpu)")
    args = parser.parse_args(argv)
    import torch

    from riffusion_tpu_torch.parallel.mesh import init_distributed, spawn_world

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    under_torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    ranks_here = (int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
                  if under_torchrun else args.n)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    # nccl takes one rank per card; ranks that share a card, or the CPU, take gloo
    backend = "nccl" if ranks_here <= cards else "gloo"
    if under_torchrun:
        init_distributed(backend)
        try:
            rank, world = dist.get_rank(), dist.get_world_size()
            served, seconds = serving_checks(rank, world, device)
        finally:
            dist.destroy_process_group()
        if rank:
            return 0  # rank 0 reports for the world
    else:
        world = args.n
        served, seconds = spawn_world(serving_checks, world, (device,), backend=backend)[0]
    print(f"dryrun({world}, {device}): sharded serving batch OK, {served} requests")
    print(f"dryrun({world}, {device}): tensor-parallel serving OK, {seconds:.2f} s clip")
    print(f"dryrun({world}, {device}): the sharded train step is not ported yet")
    return 0


if __name__ == "__main__":
    sys.exit(main())
