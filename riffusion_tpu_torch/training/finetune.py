"""
Fine-tuning driver: checkpoint + latent dataset -> trained native checkpoint.

The counterpart of riffusion_tpu/training/finetune.py: the trainer
(parallel/train.py) over a latent dataset (training/dataset.py),
eps-prediction MSE, AdamW with the warmup-cosine schedule, an EMA of the
UNet's parameters, periodic checkpoints with resume, `loss_log.json`, and
an export in the port's native layout that
`RiffusionPipeline.load_checkpoint(output_dir / "export")` loads.

The UNet computes in bf16 over fp32 masters on CUDA and in fp32 on the CPU
(as the JAX driver picks bf16 on a TPU only).

On the card the step and the EMA update run as captured CUDA graphs, the
counterparts of the JAX fine-tune's jitted train step and jitted ema_update:
the trainer's "train_step" program and an "ema_update" program over this
run's EMA and masters (parallel/train.py `DiffusionTrainer.program`; the
decay is a constant of the program, as JAX's closure holds it). The first
step runs both eagerly and captures them; later steps replay.
RIFFUSION_TPU_NO_AOT=1, the CPU and a mesh run them eagerly.

Under an initialized process group (torchrun, or parallel.mesh.spawn_world)
every rank calls `run_finetune` with the same config and the step is
sharded over a ("data", "model", "seq") mesh, by JAX's rule: `mesh_shape`
when given, else as much data parallelism as the batch divides into,
gcd(batch, world), and the rest of the ranks on "model". Each rank reads
the whole batch stream (the same seed) and trains its share; the EMA is
kept on each rank's cut and gathered for the export; global rank 0 alone
writes loss_log.json, the checkpoints (unsharded) and the export. Without a
process group it runs on one device, and a `mesh_shape` other than all
ones raises.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import shutil
import time
import typing as T
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.models.unet import UNet2DCondition
from riffusion_tpu_torch.models.weights import load_bundle, save_native
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.training.dataset import LatentDataset
from riffusion_tpu_torch.util import torch_util


@dataclasses.dataclass
class FinetuneConfig:
    checkpoint: str  # spec for models/weights.py:load_bundle
    dataset_dir: str  # shard dir from training/dataset.py:build_latent_dataset
    output_dir: str  # checkpoints/, loss_log.json, export/ land here
    steps: int = 1000
    batch_size: int = 4
    learning_rate: float = 1e-5
    warmup_steps: int = 100
    weight_decay: float = 1e-2
    ema_decay: float = 0.999  # 0 disables EMA (the export then takes the raw params)
    checkpoint_every: int = 500
    log_every: int = 50
    seed: int = 0
    sample_posterior: bool = True
    resume: bool = True
    # the (data, model, seq) mesh under a process group; None: JAX's rule
    # (module docstring)
    mesh_shape: T.Optional[T.Tuple[int, int, int]] = None
    device: str = "cuda"


def lr_schedule(cfg: FinetuneConfig) -> T.Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule as the JAX driver builds it:
    linear warmup from 0 to the peak over min(warmup, steps) steps, then a
    cosine decay to 10% of the peak over the remaining steps (at least one),
    held there after. lr(0) = 0."""
    peak = cfg.learning_rate
    warmup = min(cfg.warmup_steps, cfg.steps)
    decay = max(cfg.steps - cfg.warmup_steps, 1)
    alpha = 0.0 if peak == 0.0 else 0.1

    def schedule(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        count = min(step - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay)) + alpha)

    return schedule


def _latest_checkpoint_step(ckpt_root: Path) -> T.Optional[int]:
    steps = []
    if ckpt_root.is_dir():
        for child in ckpt_root.iterdir():
            if child.name.startswith("state_") and (child / "state.pt").is_file():
                try:
                    steps.append(int(child.name.split("_", 1)[1]))
                except ValueError:
                    pass
    return max(steps) if steps else None


def _copy_tokenizer_files(src_checkpoint: str, export_dir: Path) -> None:
    """Carry vocab.json + merges.txt into the export so the fine-tuned
    checkpoint tokenizes as its parent (models/tokenizer.py looks in the
    root and tokenizer/)."""
    src = Path(src_checkpoint)
    if not src.is_dir():
        return
    for cand in (src, src / "tokenizer"):
        vocab, merges = cand / "vocab.json", cand / "merges.txt"
        if vocab.exists() and merges.exists():
            tok_dir = export_dir / "tokenizer"
            tok_dir.mkdir(exist_ok=True)
            shutil.copy2(vocab, tok_dir / "vocab.json")
            shutil.copy2(merges, tok_dir / "merges.txt")
            return


def finetune_mesh(cfg: FinetuneConfig, device: torch.device):
    """The ("data", "model", "seq") mesh over every rank of the process
    group (module docstring), or None without a group. Raises where the
    batch does not divide over "data" (JAX's ValueError), and for a
    mesh_shape other than all ones without a group."""
    from riffusion_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        if cfg.mesh_shape is not None and any(n != 1 for n in cfg.mesh_shape):
            raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} needs an initialized "
                             "process group (torchrun); without one the fine-tune runs on "
                             "one device")
        return None
    world = dist.get_world_size()
    if cfg.mesh_shape is not None:
        shape = tuple(cfg.mesh_shape)
    else:
        data = math.gcd(cfg.batch_size, world)
        shape = (data, world // data, 1)
    mesh = make_mesh(shape, ("data", "model", "seq"), device_type=device.type)
    if cfg.batch_size % shape[0]:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by data-parallel "
                         f"degree {shape[0]}")
    return mesh


@torch.no_grad()
def ema_update(ema: T.Dict[str, torch.Tensor], params: T.Mapping[str, torch.Tensor],
               decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place (the stage
    `riffusion.train.ema`, tracing.py)."""
    names = list(ema)
    with tracing.stage("riffusion.train.ema"):
        torch._foreach_mul_([ema[n] for n in names], decay)
        torch._foreach_add_([ema[n] for n in names], [params[n] for n in names],
                            alpha=1.0 - decay)


def run_finetune(cfg: FinetuneConfig, log: T.Callable[[str], None] = print) -> dict:
    """Run the fine-tune loop; returns summary stats (first/final logged
    loss, steps, export path, clip count, the final checkpoint's path, bytes
    and seconds, and under "graphs" each captured program's stage reports:
    its warm-up and capture seconds, none where the run was eager).
    Re-invoking with a larger
    cfg.steps resumes from the newest checkpoint in output_dir, with the
    data stream replayed to that step."""
    out_dir = Path(cfg.output_dir).absolute()
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt_root = out_dir / "checkpoints"
    device = torch_util.check_device(cfg.device)
    dataset = LatentDataset(cfg.dataset_dir)
    mesh = finetune_mesh(cfg, device)
    writer = mesh is None or dist.get_rank() == 0  # who writes the files

    # fp32 master weights; the compute dtype follows the device
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    bundle = load_bundle(cfg.checkpoint, torch.float32, device=device)
    trainer = DiffusionTrainer(device=device, learning_rate=lr_schedule(cfg),
                               weight_decay=cfg.weight_decay, dtype=compute_dtype, mesh=mesh)
    trainer.init_from(bundle.unet)
    bundle.unet = None  # the trainer holds the masters; the export puts them back
    params = dict(trainer.master.named_parameters())
    ema = ({n: p.detach().clone() for n, p in params.items()} if cfg.ema_decay > 0 else None)

    start_step = 0
    if cfg.resume:
        latest = _latest_checkpoint_step(ckpt_root)
        if latest is not None:
            start_step, saved_ema = trainer.restore_checkpoint(ckpt_root, latest)
            if ema is not None and saved_ema is not None:
                ema = saved_ema
            log(f"resumed from checkpoint step {start_step}")

    losses: T.List[T.Tuple[int, float]] = []
    loss_log_path = out_dir / "loss_log.json"
    if loss_log_path.exists():
        losses = [tuple(x) for x in json.loads(loss_log_path.read_text()) if x[0] <= start_step]

    batches = dataset.batches(cfg.batch_size, seed=cfg.seed,
                              sample_posterior=cfg.sample_posterior)
    # replay the stream to where the resumed step left off, so the data
    # order is an uninterrupted run's
    for _ in range(start_step):
        next(batches)

    ema_step = (None if ema is None else trainer.program(
        "ema_update", functools.partial(ema_update, ema, params, cfg.ema_decay)))
    # one generator for t and noise, reseeded per step from (seed, step), so
    # a resumed run draws what the uninterrupted one drew
    generator = torch.Generator(device=device)
    first_loss: T.Optional[float] = None
    loss_val = float("nan")
    t0 = time.monotonic()
    for step in range(start_step, cfg.steps):
        latents, context = next(batches)
        generator.manual_seed(int(np.random.SeedSequence([cfg.seed, step]).generate_state(1)[0]))
        loss = trainer.step(latents, context, generator=generator)
        if ema_step is not None:
            ema_step()
        if step == start_step or (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
            loss_val = float(loss)
            if not np.isfinite(loss_val):
                raise FloatingPointError(f"non-finite loss {loss_val} at step {step}")
            if first_loss is None:
                first_loss = loss_val
            losses.append((step + 1, loss_val))
            rate = (step + 1 - start_step) / max(time.monotonic() - t0, 1e-9)
            log(f"step {step + 1}/{cfg.steps} loss {loss_val:.5f} ({rate:.2f} it/s)")
        if (step + 1) % cfg.checkpoint_every == 0 and step + 1 < cfg.steps:
            trainer.save_checkpoint(ckpt_root, step + 1, ema)
            if writer:
                loss_log_path.write_text(json.dumps(losses))

    checkpoint = None  # the final save: its file, size and seconds
    if cfg.steps > start_step:
        start = time.perf_counter()
        path = trainer.save_checkpoint(ckpt_root, cfg.steps, ema)
        checkpoint = {"path": str(path), "bytes": path.stat().st_size,
                      "seconds": time.perf_counter() - start}
    if writer:
        loss_log_path.write_text(json.dumps(losses))

    # ---- export: the EMA (or raw) weights in fp32, VAE and CLIP as loaded
    export_dir = out_dir / "export"
    if ema is not None:
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(ema[name])
    if mesh is None:
        bundle.unet = trainer.master
    else:  # the ranks' cuts made whole (a collective), into a UNet on the CPU
        whole = trainer.unsharded(trainer.master.state_dict())
        if writer:
            with torch.device("meta"):
                bundle.unet = UNet2DCondition(trainer.master.cfg)
            bundle.unet.load_state_dict(whole, assign=True)
    if writer:
        save_native(bundle, export_dir)
        _copy_tokenizer_files(cfg.checkpoint, export_dir)
        log(f"exported fine-tuned checkpoint to {export_dir}")
    if mesh is not None:
        dist.barrier()

    return {
        "steps": cfg.steps,
        "first_loss": first_loss,
        "final_loss": loss_val,
        "export_dir": str(export_dir),
        "num_clips": len(dataset),
        "checkpoint": checkpoint,
        "graphs": {key: program.reports()
                   for key, program in trainer.graph_store.programs.items()},
    }
