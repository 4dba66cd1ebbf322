"""
Fine-tuning traffic: the loop that riffusion_tpu_torch's `run_finetune`
runs (training/finetune.py), over a latent dataset the benchmark writes:
a batch from `LatentDataset.batches`, `DiffusionTrainer.step` (the
replayed "train_step" graph on one card) with t and noise from the driver's
generator reseeded per step, then the "ema_update" program.

The cell's `params` give the batch size. The configuration gives the
trainer's settings (`finetune`: run_finetune's defaults) and the dataset's
shape (`dataset`): fp16 posterior moments of `clips` latents over the
contexts of `prompts` prompts, written as build_latent_dataset writes its
shards, under TMPDIR, and drawn from the seed.

Set-up builds one trainer and drives it through its first three steps
(the first one warms up and captures both graphs, the next two replay
them); the check reads their losses, each step's gradient (from AdamW's
first moment after it and before it) and each parameter's change after
the three. The window then runs the loop's next steps for the run's
seconds and ends on a synchronize. After it the EMA's program runs once
more, on the probe's inputs (check_train.ema_probe) copied into the
trainer's EMA and masters; then the trainer is freed and
bench_port/check_train.py follows the same three steps, and the probe's
update, with the plain reference.
"""

from __future__ import annotations

import functools
import gc
import json
import tempfile
import time
import typing as T
from pathlib import Path

import numpy as np

from bench_port import check_train, harness, sut

CHECKED_STEPS = 3


def dataset_arrays(cfg: T.Mapping[str, T.Any], seed: int) -> T.Dict[str, np.ndarray]:
    """The dataset's raw arrays, drawn from the seed."""
    ds = cfg["dataset"]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 11])
    shape = (ds["clips"],) + tuple(ds["latent_shape"])
    return {
        "mean": rng.standard_normal(shape, dtype=np.float32).astype(np.float16),
        "logvar": rng.uniform(-6.0, -2.0, size=shape).astype(np.float16),
        "ctx": rng.integers(0, ds["prompts"], size=ds["clips"]).astype(np.int32),
        "contexts": rng.standard_normal((ds["prompts"],) + tuple(ds["context_shape"]),
                                        dtype=np.float32).astype(np.float16),
    }


def write_dataset(root: Path, cfg: T.Mapping[str, T.Any], arrays: T.Mapping[str, np.ndarray]
                  ) -> None:
    """The shard directory build_latent_dataset writes: shard_*.npz,
    contexts.npy and meta.json."""
    ds = cfg["dataset"]
    n, size = ds["clips"], ds["shard_size"]
    shards = (n + size - 1) // size
    for s in range(shards):
        lo, hi = s * size, min((s + 1) * size, n)
        np.savez(root / f"shard_{s:05d}.npz", mean=arrays["mean"][lo:hi],
                 logvar=arrays["logvar"][lo:hi], ctx=arrays["ctx"][lo:hi])
    np.save(root / "contexts.npy", arrays["contexts"])
    meta = {"num_clips": n, "latent_shape": list(ds["latent_shape"]),
            "context_shape": list(ds["context_shape"]),
            "scaling_factor": ds["scaling_factor"], "num_shards": shards,
            "prompts": [f"prompt {i}" for i in range(ds["prompts"])], "params": {}}
    (root / "meta.json").write_text(json.dumps(meta))


def data_seed(seed: int) -> int:
    """The fine-tune's own seed (FinetuneConfig.seed) under a run's seed."""
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFF, 5]).generate_state(1)[0])


def gradient_norms(optimizer, params: T.Mapping[str, T.Any], names: T.Mapping[str, str],
                   moments: T.Dict[str, T.Any]) -> T.Dict[str, float]:
    """Each leaf's gradient norm in the step just taken, by diffusers name,
    as AdamW's first moment gives it: (m - b1 * m_before) / (1 - b1), with
    m_before the copy in `moments` (none before the first step), which is
    then brought up to date. A leaf without a moment (its optimizer took no
    step) reads 0."""
    import torch

    b1 = optimizer.param_groups[0]["betas"][0]
    norms = {}
    for n, p in params.items():
        m = optimizer.state[p].get("exp_avg")
        if m is None:
            continue
        if n in moments:
            norms[n] = torch.linalg.vector_norm(m - b1 * moments[n])
            moments[n].copy_(m)
        else:
            norms[n] = torch.linalg.vector_norm(m)
            moments[n] = m.detach().clone()
    values = (torch.stack(list(norms.values())) / (1 - b1)).tolist() if norms else []
    found = dict(zip(norms, values))
    return {names[n]: found.get(n, 0.0) for n in params}


def run(record: harness.Record) -> None:
    import torch

    from riffusion_tpu_torch.models import weights as port_weights
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer
    from riffusion_tpu_torch.training.dataset import LatentDataset
    from riffusion_tpu_torch.training.finetune import FinetuneConfig, ema_update, lr_schedule

    cfg, ft = record.config, record.config["finetune"]
    device = record.device
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    batch = record.cell["params"]["batch_size"]
    seed = data_seed(record.seed)
    states = sut.weights(cfg, record.seed, device, models=("unet",))
    arrays = dataset_arrays(cfg, record.seed)
    with tempfile.TemporaryDirectory(prefix="bench_port_latents_") as tmp:
        write_dataset(Path(tmp), cfg, arrays)
        dataset = LatentDataset(tmp)
    fcfg = FinetuneConfig(checkpoint="", dataset_dir="", output_dir="", steps=ft["steps"],
                          batch_size=batch, learning_rate=ft["learning_rate"],
                          warmup_steps=ft["warmup_steps"], weight_decay=ft["weight_decay"],
                          ema_decay=ft["ema_decay"], seed=seed, device=device)
    compute = sut.DTYPES[cfg["precision"]["compute"]] if device == "cuda" else torch.float32
    trainer = DiffusionTrainer(device=device, learning_rate=lr_schedule(fcfg),
                               weight_decay=fcfg.weight_decay, dtype=compute)
    trainer.init_from(sut.unet_module(cfg, states["unet"], device))
    params = dict(trainer.master.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    ema_step = trainer.program("ema_update", functools.partial(ema_update, ema, params,
                                                               fcfg.ema_decay))
    batches = dataset.batches(fcfg.batch_size, seed=fcfg.seed,
                              sample_posterior=fcfg.sample_posterior)
    generator = torch.Generator(device=device)
    _, names = port_weights.convert_diffusers_state_dict(states["unet"], "unet")
    initial = {n: states["unet"][names[n]] for n in params}

    def one_step(step: int):
        """run_finetune's loop body."""
        t0 = time.monotonic()
        with harness.span(record.spans, "batch"):
            latents, context = next(batches)
        record.data_s.append((t0, time.monotonic() - t0))
        generator.manual_seed(int(np.random.SeedSequence([fcfg.seed, step]).generate_state(1)[0]))
        with harness.span(record.spans, "step"):
            loss = trainer.step(latents, context, generator=generator)
        with harness.span(record.spans, "ema"):
            ema_step()
        return loss

    program = {"losses": [], "grad_norms": [], "change_norms": {}}
    moments: T.Dict = {}
    for step in range(CHECKED_STEPS):
        program["losses"].append(float(one_step(step)))
        program["grad_norms"].append(gradient_norms(trainer.optimizer, params, names, moments))
    del moments
    with torch.no_grad():
        program["change_norms"] = {names[n]: float(torch.linalg.vector_norm(
            p.detach().float() - initial[n].float())) for n, p in params.items()}
    record.data_s.clear()
    harness.sync(device)

    t0 = time.monotonic()
    record.setup_s = t0 - record.started
    trace = harness.WindowTrace(record.trace, t0 + record.seconds)
    trace.poll()
    step = CHECKED_STEPS
    while time.monotonic() < t0 + record.seconds:
        one_step(step)
        step += 1
        record.steps.append(time.monotonic())
        trace.poll()
    with harness.span(record.spans, "sync"):
        harness.sync(device)
    record.window = (t0, time.monotonic())
    record.traced_from = trace.t0
    trace.finish()
    record.device_trace = trace.result
    record.attempted = step
    record.memory_peak_bytes = harness.memory_peak(device)
    record.counters["graphs"] = [rep for prog in trainer.graph_store.programs.values()
                                 for rep in prog.reports()]
    record.notes["steps"] = {"checked": CHECKED_STEPS, "timed": step - CHECKED_STEPS,
                             "checked_losses": program["losses"]}

    by_name = {names[n]: n for n in params}
    with torch.no_grad():
        for key, ema0, params0 in check_train.ema_probe(states["unet"], record.seed):
            ema[by_name[key]].copy_(ema0)
            params[by_name[key]].copy_(params0)
    ema_step()
    harness.sync(device)
    program["ema"] = {names[n]: t for n, t in ema.items()}
    del trainer, params, ema, ema_step, initial, batches
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    check_train.check(record, states, arrays, seed, batch, program)
