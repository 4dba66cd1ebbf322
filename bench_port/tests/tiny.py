"""Tiny configurations and CPU runs of the benchmark's drivers for its tests
(the widths of riffusion_tpu_torch's own tiny test models)."""

from __future__ import annotations

import copy
import time
import typing as T
from pathlib import Path

from bench_port import harness, sut


def tiny(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, T.Any]:
    cfg = copy.deepcopy(dict(cfg))
    cfg["unet"].update(block_out_channels=[32, 64, 64, 64], layers_per_block=1,
                       cross_attention_dim=64, attention_head_dim=2)
    if "vae" in cfg:
        cfg["vae"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1)
        cfg["text_encoder"].update(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                                   num_attention_heads=4, intermediate_size=128)
        cfg["precision"].update(unet="float32", text_encoder="float32")
    if "dataset" in cfg:
        cfg["dataset"].update(clips=16, latent_shape=[8, 8, 4], context_shape=[77, 64],
                              prompts=4)
    return cfg


def tiny_cell(name: str) -> T.Tuple[dict, dict]:
    cell = harness.cell(name)
    if cell["kind"] == "serve":
        cell["params"]["num_inference_steps"] = 10
    return cell, tiny(harness.config(cell["config"]))


def seed_images(tmp: Path, monkeypatch) -> None:
    """64-pixel seed images for the tiny models."""
    from PIL import Image

    for path in sut.INPUTS.glob("*.png"):
        Image.open(path).convert("RGB").resize((64, 64)).save(tmp / path.name)
    monkeypatch.setattr(sut, "INPUTS", tmp)


def run(name: str, seconds: float = 2.0, seed: int = 2 ** 31 + 17) -> harness.Record:
    cell, cfg = tiny_cell(name)
    record = harness.Record(cell=cell, config=cfg, seed=seed, seconds=seconds, trace=False,
                            started=time.monotonic(), device="cpu")
    harness.traffic(cell["kind"]).run(record)
    return record


def correct(record: harness.Record) -> bool:
    return bool(record.checks) and all(c.ok for c in record.checks) and record.failed == 0
