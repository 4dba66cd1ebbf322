"""
Stage times inside captured CUDA graphs on a card (riffusion_tpu_torch/
tracing.py, aot.py): with RIFFUSION_TPU_TRACE off a captured program has
the node count of the same program without stage spans, and with it on
exactly two nodes more a stage; the stage times read after replays are
positive and sum to no more than the replay's own elapsed time (events
recorded around the replay, outside the graph). For a small program, the
tiny model's request, and the tiny trainer's step and EMA update. And
the train profile's part breakdown of an eager step keeps the backward's
kernels apart, though the step's outer spans enclose them. Every test is
marked `cuda` and skips where torch sees no card. No jax import,
so it runs on a card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_tracing_cuda.py
"""

import copy
import functools

import numpy as np
import pytest
import torch
from PIL import Image

from riffusion_tpu_torch import aot, tracing
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.training.finetune import ema_update
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

SIZE = 256


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and their events have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


class TimedGraphs(aot.CudaGraphs):
    """Counts each graph's nodes, and records a pair of events around each
    replay, on the stream, outside the graph."""

    def __init__(self):
        super().__init__(count_nodes=True)
        self.outer = []

    def replay(self, graph):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        self.outer.append((start, end))


def _switch(monkeypatch, on: bool) -> None:
    if on:
        monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    else:
        monkeypatch.delenv("RIFFUSION_TPU_TRACE", raising=False)
    tracing.reset()


def _nodes(program) -> int:
    (report,) = program.reports()
    return report["nodes"]


def _check_replays(graphs: TimedGraphs, replays, names):
    """Each replay read has every stage, each positive, their sum within the
    replay's elapsed time."""
    torch.cuda.synchronize()
    read = [r for r in replays if r["stages"] is not None]
    assert read and all(set(r["stages"]) == set(names) for r in read)
    # replays of one program are read in order, one launch behind: the k-th
    # read is the k-th timed replay
    for r, (start, end) in zip(read, graphs.outer):
        assert all(ms > 0 for ms in r["stages"].values()), r
        assert sum(r["stages"].values()) <= start.elapsed_time(end), r


def _plain(x):
    y = x @ x
    z = torch.relu(y) * 2.0
    return z.sum(0), None


def _staged(x):
    with tracing.stage("riffusion.a"):
        y = x @ x
    with tracing.stage("riffusion.b"):
        z = torch.relu(y) * 2.0
    with tracing.stage("riffusion.c"):
        out = z.sum(0)
    return out, None


def test_a_program_gains_two_nodes_a_stage_only_with_the_switch(card, monkeypatch):
    x = torch.randn(512, 512, generator=torch.Generator(device=card).manual_seed(0), device=card)
    counts = {}
    for name, fn, on in (("plain", _plain, False), ("off", _staged, False),
                         ("on", _staged, True)):
        _switch(monkeypatch, on)
        graphs = TimedGraphs()
        program = aot.GraphProgram(fn, name, graphs=graphs)
        results = [program(x)[0] for _ in range(4)]  # a capture, three replays
        counts[name] = _nodes(program)
        torch.testing.assert_close(results[-1], fn(x)[0])
        if on:
            out = tracing.export()
            assert out["counters"]["stage_read"] == 2 and out["counters"]["stage_unread"] == 0
            _check_replays(graphs, out["replays"], ["riffusion.a", "riffusion.b", "riffusion.c"])
    tracing.reset()
    assert counts["off"] == counts["plain"]
    assert counts["on"] == counts["plain"] + 2 * 3


def _request(i: int) -> InferenceInput:
    return InferenceInput(start=PromptInput(prompt=f"church bells {i}", seed=1 + i, guidance=1.5),
                          end=PromptInput(prompt=f"techno {i}", seed=20 + i, guidance=1.5),
                          alpha=0.4, num_inference_steps=4)


def test_the_request_graph_times_its_stages(card, monkeypatch):
    """The tiny model's riffuse_audio: 8 nodes more with the switch (VAE
    encode, denoise, VAE decode, audio), the replays' stages read."""
    image = Image.fromarray(np.random.default_rng(2).integers(0, 255, (SIZE, SIZE, 3),
                                                              dtype=np.uint8))
    params = SpectrogramParams(num_frequencies=SIZE)
    bundle = random_bundle("tiny", seed=0, device="cpu", dtype=torch.float32)
    nodes, images = {}, {}
    for on in (False, True):
        _switch(monkeypatch, on)
        pipe = RiffusionPipeline(copy.deepcopy(bundle), device="cuda")
        graphs = TimedGraphs()
        pipe.graph_store = aot.GraphStore(graphs)
        images[on] = [np.asarray(pipe.riffuse_audio(_request(i), image, params=params,
                                                    scheduler="pndm")[0]) for i in range(4)]
        (program,) = pipe.graph_store.programs.values()
        nodes[on] = _nodes(program)
        if on:
            out = tracing.export()
            assert out["counters"]["stage_read"] == 2 and out["counters"]["stage_unread"] == 0
            _check_replays(graphs, out["replays"], ["riffusion.vae_encode", "riffusion.denoise",
                                                    "riffusion.vae_decode", "riffusion.audio"])
    tracing.reset()
    assert nodes[True] == nodes[False] + 2 * 4
    for a, b in zip(images[False], images[True]):  # the events change no result
        np.testing.assert_array_equal(a, b)


def test_the_train_graphs_time_their_stages(card, monkeypatch):
    """The tiny trainer at fp32 (its masters are the working module: no
    copy, no grads stage): the step gains 6 nodes (forward, backward,
    optimizer), the EMA update 2; the replays' stages read."""
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    unet = random_bundle("tiny", seed=0, device="cpu").unet
    nodes, losses = {}, {}
    for on in (False, True):
        _switch(monkeypatch, on)
        trainer = DiffusionTrainer(device=card, learning_rate=1e-3, dtype=torch.float32)
        trainer.init_from(unet)
        graphs = TimedGraphs()
        trainer.graph_store = aot.GraphStore(graphs)
        params = dict(trainer.master.named_parameters())
        ema = {n: p.detach().clone() for n, p in params.items()}
        ema_step = trainer.program("ema_update", functools.partial(ema_update, ema, params, 0.9))
        gen = torch.Generator(device=card)
        losses[on] = []
        for step in range(5):
            gen.manual_seed(step)
            losses[on].append(trainer.step(latents, context, generator=gen))
            ema_step()
        torch.cuda.synchronize()
        losses[on] = [float(x) for x in losses[on]]
        nodes[on] = {k: _nodes(p) for k, p in trainer.graph_store.programs.items()}
        if on:
            out = tracing.export()
            assert out["counters"]["stage_read"] == 2 * 3
            assert out["counters"]["stage_unread"] == 0
            by_key = {k: [r for r in out["replays"] if r["key"] == k] for k in nodes[on]}
            torch.cuda.synchronize()
            for key, names in (("train_step", ["riffusion.train.forward",
                                               "riffusion.train.backward",
                                               "riffusion.train.optimizer"]),
                               ("ema_update", ["riffusion.train.ema"])):
                read = [r for r in by_key[key] if r["stages"] is not None]
                assert len(read) == 3 and all(set(r["stages"]) == set(names) for r in read)
                assert all(ms > 0 for r in read for ms in r["stages"].values())
            # the replays alternate train_step, ema_update: the outer events in that order
            steps, emas = graphs.outer[0::2], graphs.outer[1::2]
            for key, outer in (("train_step", steps), ("ema_update", emas)):
                for r, (start, end) in zip([r for r in by_key[key] if r["stages"]], outer):
                    assert sum(r["stages"].values()) <= start.elapsed_time(end), (key, r)
    tracing.reset()
    assert nodes[True] == {"train_step": nodes[False]["train_step"] + 2 * 3,
                           "ema_update": nodes[False]["ema_update"] + 2}
    # the events change no result (the tiny fp32 backward on the card is
    # not bit-deterministic, so the losses are held close, not equal)
    assert losses[True] == pytest.approx(losses[False], rel=1e-3)


def test_an_eager_steps_parts_keep_the_backward(card, monkeypatch):
    """The train profile's part breakdown of an eager step of the tiny trainer
    at bf16 compute, with its EMA update, under the profiler: the backward's
    kernels, launched on autograd's thread, still form a part of their own
    beside the stages', and the spans around the stages (the step, its
    upload, the launches) take no kernel."""
    from torch.profiler import ProfilerActivity, profile

    from riffusion_tpu_torch import profile as port_profile

    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    _switch(monkeypatch, False)
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    trainer = DiffusionTrainer(device=card, learning_rate=1e-3, dtype=torch.bfloat16)
    trainer.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    params = dict(trainer.master.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()}
    ema_step = trainer.program("ema_update", functools.partial(ema_update, ema, params, 0.9))
    gen = torch.Generator(device=card).manual_seed(0)

    def step():
        trainer.step(latents, context, generator=gen)
        ema_step()
        torch.cuda.synchronize()

    step()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    annotations, kernels = port_profile.device_events(prof)
    parts = port_profile.kernel_ms_by_part(annotations, kernels)
    assert set(parts) <= set(port_profile.STAGES) | {port_profile.BACKWARD}, parts
    for part in (port_profile.BACKWARD, "riffusion.train.copy", "riffusion.train.forward",
                 "riffusion.train.optimizer", "riffusion.train.ema"):
        assert parts.get(part, 0.0) > 0, (part, parts)
    # on one card the optimizer reads the working copy's gradients: no hand-off
    assert "riffusion.train.grads" not in parts, parts
    assert sum(parts.values()) == pytest.approx(
        sum(k.time_range.elapsed_us() for k in kernels) / 1e3)
