"""The SDXL serving cell on the CPU at tiny widths: reference/sdxl.py
against the repository's test oracle (tests/torch_sdxl_reference.py) on
one tiny state dict, count_xl.py's parameters and sites at the published
widths, the cell's per-layer metrics read by their readers, and one run of
its driver, correct, with the control not."""

from __future__ import annotations

import copy
import sys
import time
import typing as T

import pytest
import torch

from bench_port import count, count_xl, harness, sut_xl
from bench_port.reference import sd, sdxl
from bench_port.tests import tiny

sys.path.insert(0, str(harness.REPO / "tests"))
import torch_sdxl_reference as oracle  # noqa: E402

XL = "sdxl-base-1.0.player"


def tiny_xl(cfg: T.Mapping[str, T.Any]) -> T.Dict[str, T.Any]:
    """SDXL's geometry at tiny widths: three levels, the first without
    attention, depths (1, 1, 2), heads (1, 2, 4), two small towers."""
    cfg = copy.deepcopy(dict(cfg))
    cfg["unet"].update(block_out_channels=[32, 64, 64], layers_per_block=1,
                       attention_head_dim=[1, 2, 4], transformer_layers_per_block=[1, 1, 2],
                       cross_attention_dim=96, addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=48 + 6 * 8)
    cfg["vae"].update(block_out_channels=[32, 32, 32, 32], layers_per_block=1)
    cfg["text_encoder"].update(vocab_size=1024, hidden_size=32, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=64)
    cfg["text_encoder_2"].update(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=128, projection_dim=48)
    cfg["precision"].update(unet="float32", text_encoder="float32", text_encoder_2="float32")
    return cfg


@pytest.fixture
def small_images(tmp_path, monkeypatch):
    tiny.seed_images(tmp_path, monkeypatch)


def test_reference_matches_the_test_oracle():
    cfg = tiny_xl(harness.config("sdxl-base-1.0"))
    weights = {m: sd.widened(state) for m, state in sut_xl.weights(cfg, 7, "cpu").items()}
    states = weights["unet"]
    gen = torch.Generator().manual_seed(1)
    sample = torch.randn(2, 4, 8, 32, generator=gen)
    t = torch.tensor([981.0, 401.0])
    context = torch.randn(2, 77, 96, generator=gen)
    pooled = torch.randn(2, 48, generator=gen)
    time_ids = torch.tensor([[64.0, 256.0, 0.0, 0.0, 64.0, 256.0]] * 2)
    got = sdxl.unet(states, cfg["unet"], sample, t, context, pooled, time_ids)
    want = oracle.unet_forward(states, cfg["unet"], sample, t, context, pooled, time_ids)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    ids = torch.tensor([[0, 5, 9, 1] + [1] * 73])
    for name in ("text_encoder", "text_encoder_2"):
        penultimate, pooled_out = sdxl.tower(weights[name], cfg[name], ids, sdxl.EOS)
        hidden, want_pooled = oracle.clip_hidden_states(weights[name], cfg[name], ids, sdxl.EOS)
        assert torch.allclose(penultimate, hidden[-2], atol=1e-5)
        assert (pooled_out is None) == (want_pooled is None)
        if pooled_out is not None:
            assert torch.allclose(pooled_out, want_pooled, atol=1e-5)


def test_count_at_the_published_widths():
    cfg = harness.config("sdxl-base-1.0")
    assert sd.parameter_count(sdxl.unet_leaves(cfg["unet"])) == 2_567_463_684
    assert sd.parameter_count(sdxl.clip_leaves(cfg["text_encoder_2"])) == 694_659_840
    sites = count_xl.self_attention_sites(cfg["unet"], 64, 256)
    assert [(s.seq, s.heads, s.head_dim, s.per_eval) for s in sites] == [
        (4096, 10, 64, 10), (1024, 20, 64, 60)]
    flops = count.forward_flops(count_xl.unet_products(cfg["unet"], 2, 64, 256))
    assert 13.4e12 < flops < 13.6e12


def test_count_against_torch_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tiny_xl(harness.config("sdxl-base-1.0"))
    state = sd.widened(sut_xl.weights(cfg, 3, "cpu")["unet"])
    with FlopCounterMode(display=False) as counter:
        sdxl.unet(state, cfg["unet"], torch.randn(2, 4, 8, 32), torch.tensor([5.0, 5.0]),
                  torch.randn(2, 77, 96), torch.randn(2, 48), torch.ones(2, 6))
    assert counter.get_total_flops() == count.forward_flops(
        count_xl.unet_products(cfg["unet"], 2, 8, 32))


@pytest.mark.parametrize("entry", [e for e in harness.manifest()["per_layer"]
                                   if XL in e.get("workloads", ())],
                         ids=lambda e: e["name"])
def test_new_metrics_read_nothing_from_an_empty_run(entry):
    cell = harness.cell(entry["workloads"][0])
    record = harness.Record(cell=cell, config=harness.config(cell["config"]), seed=1,
                            seconds=1.0, trace=True, started=0.0, window=(1.0, 2.0))
    record.notes.update(image_size=(512, 2048), evaluations=37)
    reader = harness.reader(entry["name"])
    assert reader.read(record, entry["name"]) is None


def _xl_run(seconds: float = 2.0, seed: int = 2 ** 31 + 29) -> harness.Record:
    cell = harness.cell(XL)
    cell["params"]["num_inference_steps"] = 10
    record = harness.Record(cell=cell, config=tiny_xl(harness.config(cell["config"])), seed=seed,
                            seconds=seconds, trace=False, started=time.monotonic(), device="cpu")
    harness.traffic(cell["kind"]).run(record)
    return record


def test_sdxl_player_run_is_correct(small_images):
    record = _xl_run()
    assert tiny.correct(record), record.checks
    assert record.notes["image_size"] == (64, 256) and record.notes["evaluations"] == 7
    gaps = {c.name: c.value for c in record.checks}
    assert gaps["image_gap"] < 0.05 and gaps["audio_gap"] < 1e-2


def test_sdxl_control_is_not_correct(small_images):
    from bench_port import limits_xl

    cell = harness.cell(XL)
    cell["params"]["num_inference_steps"] = 10
    cfg = tiny_xl(harness.config(cell["config"]))
    gaps = limits_xl.serve_control(cell, cfg, 12, "cpu")
    assert gaps["image_gap"] > 0.5, gaps
