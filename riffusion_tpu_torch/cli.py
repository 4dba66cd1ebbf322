"""
Command line tools of the port. So far the `finetune` command alone, with
the JAX package's flags (riffusion_tpu/cli.py `finetune`), on one device:

    python -m riffusion_tpu_torch.cli finetune --checkpoint random:tiny \\
        --audio-dir clips/ --output-dir run/ --steps 100 --device cuda

It builds the latent dataset (into <output-dir>/dataset unless
--dataset-dir names one) when there is none yet, trains with EMA and resume,
and exports a checkpoint that loads with --checkpoint <output-dir>/export.
The CPU is used only when asked for (--device cpu).
"""

from __future__ import annotations

import argparse
import typing as T
from pathlib import Path

from riffusion_tpu_torch.spectrogram_params import SpectrogramParams


def finetune(
    *,
    checkpoint: str,
    output_dir: str,
    audio_dir: str = "",
    dataset_dir: str = "",
    prompt: str = "",
    prompts_json: str = "",
    steps: int = 1000,
    batch_size: int = 4,
    learning_rate: float = 1e-5,
    ema_decay: float = 0.999,
    checkpoint_every: int = 500,
    clip_duration_ms: int = 5120,
    num_frequencies: int = 512,
    seed: int = 0,
    device: str = "cuda",
) -> None:
    """Fine-tune the UNet on a directory of audio, then export it."""
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
    from riffusion_tpu_torch.training import FinetuneConfig, build_latent_dataset, run_finetune

    if not audio_dir and not dataset_dir:
        raise SystemExit("finetune: pass --audio-dir and/or --dataset-dir")
    dataset_path = Path(dataset_dir) if dataset_dir else Path(output_dir) / "dataset"
    if not (dataset_path / "meta.json").exists():
        if not audio_dir:
            raise SystemExit(f"no dataset at {dataset_path} and no --audio-dir given")
        print(f"Building latent dataset from {audio_dir} into {dataset_path} ...")
        pipeline = RiffusionPipeline.load_checkpoint(checkpoint, device=device)
        meta = build_latent_dataset(
            pipeline,
            audio_dir,
            dataset_path,
            params=SpectrogramParams(num_frequencies=num_frequencies),
            prompts_json=prompts_json or None,
            default_prompt=prompt or None,
            clip_duration_ms=clip_duration_ms,
        )
        print(f"Dataset: {meta.num_clips} clips, {len(meta.prompts)} unique prompts")
        del pipeline  # release device memory before training starts

    stats = run_finetune(
        FinetuneConfig(
            checkpoint=checkpoint,
            dataset_dir=str(dataset_path),
            output_dir=output_dir,
            steps=steps,
            batch_size=batch_size,
            learning_rate=learning_rate,
            ema_decay=ema_decay,
            checkpoint_every=checkpoint_every,
            seed=seed,
            device=device,
        )
    )
    print(
        f"Fine-tune done: {stats['steps']} steps, loss "
        f"{stats['first_loss']:.5f} -> {stats['final_loss']:.5f}; "
        f"export at {stats['export_dir']}"
    )


def main(argv: T.Optional[T.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="riffusion_tpu_torch.cli",
                                     description="riffusion_tpu_torch command line tools")
    subparsers = parser.add_subparsers(dest="command", required=True)
    sub = subparsers.add_parser("finetune", help=finetune.__doc__)
    sub.add_argument("--checkpoint", required=True)
    sub.add_argument("--output-dir", required=True)
    for name in ("audio_dir", "dataset_dir", "prompt", "prompts_json"):
        sub.add_argument("--" + name.replace("_", "-"), default="")
    for name, default in (("steps", 1000), ("batch_size", 4), ("checkpoint_every", 500),
                          ("clip_duration_ms", 5120), ("num_frequencies", 512), ("seed", 0)):
        sub.add_argument("--" + name.replace("_", "-"), type=int, default=default)
    sub.add_argument("--learning-rate", type=float, default=1e-5)
    sub.add_argument("--ema-decay", type=float, default=0.999)
    sub.add_argument("--device", default="cuda")
    args = vars(parser.parse_args(argv))
    args.pop("command")
    finetune(**args)


if __name__ == "__main__":
    main()
