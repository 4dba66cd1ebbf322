"""count.py against torch's own FLOP counter on the plain reference at the
tiny widths, and the roofline and mfu arithmetic."""

from __future__ import annotations

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import count, harness, sut
from bench_port.reference import sd
from bench_port.tests import tiny

SERVE = tiny.tiny(harness.config("riffusion-v1"))


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.fixture(scope="module")
def weights():
    return {m: sd.widened(s) for m, s in sut.weights(SERVE, 3, "cpu").items()}


@pytest.mark.parametrize("batch,hw", [(2, 8), (1, 16)])
def test_unet_forward(weights, batch, hw):
    x = torch.randn(batch, 4, hw, hw)
    ctx = torch.randn(batch, 77, SERVE["unet"]["cross_attention_dim"])
    got = _counted(lambda: sd.unet(weights["unet"], SERVE["unet"], x, torch.tensor([5] * batch),
                                   ctx))
    assert got == count.forward_flops(count.unet_products(SERVE["unet"], batch, hw, hw))


def test_unet_training_step(weights):
    params = {k: v.clone().requires_grad_(True) for k, v in weights["unet"].items()}
    x, ctx = torch.randn(2, 4, 8, 8), torch.randn(2, 77, SERVE["unet"]["cross_attention_dim"])

    def step():
        out = sd.unet(params, SERVE["unet"], x, torch.tensor([3, 900]), ctx)
        torch.autograd.grad(out.square().mean(), list(params.values()))

    assert _counted(step) == count.training_flops(count.unet_products(SERVE["unet"], 2, 8, 8))


def test_vae_and_clip(weights):
    image = torch.randn(1, 3, 32, 32)
    assert _counted(lambda: sd.vae_encode_moments(weights["vae"], SERVE["vae"], image)) == \
        count.forward_flops(count.vae_encode_products(SERVE["vae"], 1, 32, 32))
    lat = torch.randn(2, 4, 4, 4)
    assert _counted(lambda: sd.vae_decode(weights["vae"], SERVE["vae"], lat)) == \
        count.forward_flops(count.vae_decode_products(SERVE["vae"], 2, 4, 4))
    ids = torch.zeros(1, 77, dtype=torch.long)
    assert _counted(lambda: sd.clip_text(weights["text_encoder"], SERVE["text_encoder"], ids)) \
        == count.forward_flops(count.clip_products(SERVE["text_encoder"], 1))


def test_full_width_model_flops():
    full = harness.config("riffusion-v1")
    per_sample = count.forward_flops(count.unet_products(full["unet"], 1, 64, 64))
    assert 0.79e12 < per_sample < 0.82e12  # 0.803 TFLOP a UNet sample at 64x64
    assert count.serving_evaluations("pndm", 50, 0.75) == 38
    assert count.serving_evaluations("unipc_k:rho=2", 16, 0.75) == 12
    sites = {s.head_dim: s for s in count.self_attention_sites(full["unet"], 64, 64)}
    assert (sites[40].seq, sites[40].per_eval, sites[80].seq, sites[80].per_eval) == \
        (4096, 5, 1024, 5)


def test_attention_bounds():
    # K1 at (2, 4096, 8 x 40): exp2-bound, 0.0642 ms; at (2, 1024, 8 x 80): FLOP-bound
    assert count.least_seconds(*count.attention_cost(2, 4096, 8, 40)) == pytest.approx(
        2 * 8 * 4096 ** 2 / (132 * 16 * 1.98e9))
    assert count.least_seconds(*count.attention_cost(2, 1024, 8, 80)) == pytest.approx(
        4 * 2 * 8 * 1024 ** 2 * 80 / 989e12)
    fwd, bwd = count.attention_cost(4, 4096, 8, 40), count.attention_cost(4, 4096, 8, 40, True)
    assert bwd[0] == 3 * fwd[0] and bwd[2] == 2 * fwd[2]


def _record(kind="serve", ops=(), window=(0.0, 2.0), **notes):
    name = "riffusion-v1.player" if kind == "serve" else "riffusion-v1-finetune.step4"
    cell = harness.cell(name)
    rec = harness.Record(cell=cell, config=harness.config(cell["config"]), seed=0, seconds=2,
                         trace=True, started=time.monotonic())
    rec.window = window
    rec.notes.update(notes)
    if ops:
        rec.device_trace = harness.Trace(ops=list(ops), window_s=1.0,
                                         busy_s=sum(o[2] for o in ops) / 1e6)
    return rec


def test_roofline_share_from_a_trace():
    name = "void attention_fwd_bf16_kernel<48, 40, 2, false>(Params)"
    bound = count.least_seconds(*count.attention_cost(2, 4096, 8, 40))
    rec = _record(ops=[(name, 0.0, 4 * bound * 1e6), ("other_kernel", 1.0, 50.0)])
    assert harness.reader("k1_roofline.player").read(rec, "k1_roofline.player") == \
        pytest.approx(25.0)
    assert harness.reader("idle_share.player").read(rec, "idle_share.player") == \
        pytest.approx(100.0 * (1 - (4 * bound * 1e6 + 50.0) / 1e6))
    assert harness.reader("k1_roofline.player").read(_record(), "k1_roofline.player") is None


def test_mfu_of_the_work_completed():
    rec = _record(evaluations=38)
    rec.requests = [harness.Request(key=(i,), sent=0.1, done=0.5 + i / 10, ok=True)
                    for i in range(3)]
    per_clip = count.clip_flops(rec.config, 38)
    assert harness.reader("mfu.player").read(rec, "mfu.player") == pytest.approx(
        100 * 3 * per_clip / (2.0 * 989e12))
    train = _record("finetune")
    train.steps = [1.0] * 10
    assert harness.reader("mfu.train").read(train, "mfu.train") == pytest.approx(
        100 * 10 * count.train_step_flops(train.config, 4) / (2.0 * 989e12))
    assert math.isclose(harness.reader("train_step_ms").read(train, "x"), 200.0)
