"""The plain reference against riffusion_tpu_torch at the tiny widths on
the CPU, the control that has to come out as not correct, and runs with
the timed path broken underneath that have to come out as not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import harness, sut
from bench_port.reference import riffuse, sd, train
from bench_port.tests import tiny

PLAYER, STEP4 = "riffusion-v1.player", "riffusion-v1-finetune.step4"


@pytest.fixture
def small_images(tmp_path, monkeypatch):
    tiny.seed_images(tmp_path, monkeypatch)


def test_diffusers_state_dicts_fit_the_port():
    cell, cfg = tiny.tiny_cell(PLAYER)
    states = sut.weights(cfg, 5, "cpu")
    pipe = sut.pipeline(cfg, states, "cpu")  # strict loads: every key and shape
    assert sum(p.numel() for p in pipe.unet.parameters()) == sd.parameter_count(
        sd.unet_leaves(cfg["unet"]))
    full = harness.config("riffusion-v1")
    assert sd.parameter_count(sd.unet_leaves(full["unet"])) == 859_520_964
    assert sd.parameter_count(sd.vae_leaves(full["vae"])) == 83_653_863


def test_player_run_is_correct(small_images):
    record = tiny.run(PLAYER)
    assert tiny.correct(record), record.checks
    gaps = {c.name: c.value for c in record.checks}
    assert gaps["image_gap"] < 0.05 and gaps["audio_gap"] < 1e-2


def test_step4_run_is_correct():
    record = tiny.run(STEP4)
    assert tiny.correct(record), record.checks
    assert max(abs(g) for g in record.notes["loss_gaps"]) < 1e-5


def test_serving_control_is_not_correct(small_images):
    from bench_port import check_serve, limits

    cell, cfg = tiny.tiny_cell(PLAYER)
    gaps = limits.serve_control(cell, cfg, 12, "cpu")
    limits_ = cell["check"]["limits"]
    assert any(gaps[k] > limits_[k] for k in limits_), gaps
    assert check_serve.audio_gap(np.ones(4), np.zeros(4)) == float("inf")


def test_training_control_is_not_correct():
    from bench_port import limits

    cell, cfg = tiny.tiny_cell(STEP4)
    gaps = limits.train_readings(cell, cfg, 12, "cpu", nx=train.Fp8TrainNumerics())
    assert any(gaps[k] > v for k, v in cell["check"]["limits"].items()), gaps


def _fault_serve_step_unchanged(monkeypatch):
    from riffusion_tpu_torch.diffusion import schedulers

    real = schedulers.step
    monkeypatch.setattr(schedulers, "step",
                        lambda plan, state, i, out, sample: (sample, real(plan, state, i, out,
                                                                          sample)[1]))


def _fault_serve_answer_altered(monkeypatch):
    from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline

    real = RiffusionPipeline._results

    def altered(images_np, waveforms_np, params, apply_filters):
        images_np = images_np.copy()
        images_np[:, :8] = 255 - images_np[:, :8]
        return real(images_np, waveforms_np, params, apply_filters)

    monkeypatch.setattr(RiffusionPipeline, "_results", staticmethod(altered))


@pytest.mark.parametrize("fault", [_fault_serve_step_unchanged, _fault_serve_answer_altered])
def test_a_broken_serving_path_is_not_correct(small_images, monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.correct(tiny.run(PLAYER))


def _fault_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _fault_train_half_batch(monkeypatch):
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    real = DiffusionTrainer._loss_and_grads

    def half(self, latents, context, t, noise):
        keep = latents.shape[0] // 2
        return real(self, latents[:keep], context[:keep], t[:keep], noise[:keep])

    monkeypatch.setattr(DiffusionTrainer, "_loss_and_grads", half)


def _fault_train_half_batch_replayed(monkeypatch):
    """Half of each batch left out after the first step: in the steps that
    replay the captured graph on the card."""
    from riffusion_tpu_torch.parallel.train import DiffusionTrainer

    real, calls = DiffusionTrainer._loss_and_grads, []

    def half(self, latents, context, t, noise):
        calls.append(None)
        keep = latents.shape[0] // 2 if len(calls) > 1 else latents.shape[0]
        return real(self, latents[:keep], context[:keep], t[:keep], noise[:keep])

    monkeypatch.setattr(DiffusionTrainer, "_loss_and_grads", half)


def _fault_train_ema_unchanged(monkeypatch):
    from riffusion_tpu_torch.training import finetune

    monkeypatch.setattr(finetune, "ema_update", lambda ema, params, decay: None)


def _fault_train_answer_altered(monkeypatch):
    real = torch.Tensor.backward  # the loss, and so every gradient, 5% off where made
    monkeypatch.setattr(torch.Tensor, "backward",
                        lambda self, *args, **kwargs: real(self * 1.05, *args, **kwargs))


@pytest.mark.parametrize("fault", [_fault_train_state_unchanged, _fault_train_half_batch,
                                   _fault_train_half_batch_replayed, _fault_train_ema_unchanged,
                                   _fault_train_answer_altered])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not tiny.correct(tiny.run(STEP4))


def test_reference_tokens_and_seeds():
    assert riffuse.hash_tokens("Lofi  beat", 1024)[:4] == [0, riffuse.hash_tokens("lofi", 1024)[1],
                                                         riffuse.hash_tokens("beat", 1024)[1], 1]
    assert len(riffuse.hash_tokens("a " * 100, 1024)) == 77
    assert riffuse.derived_seed(2 ** 33 + 5, 7) == riffuse.derived_seed(5, 7)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    record = harness.Record(cell=harness.cell(PLAYER), config=harness.config("riffusion-v1"),
                            seed=2 ** 32 + 99, seconds=3, trace=False, started=0.0)
    harness.traffic("serve").run(record)
    assert tiny.correct(record), record.checks
