"""
The store's CUDA graphs on a card (riffusion_tpu_torch/aot.py): both
forward kernels captured and replayed on new operands, the tiny model's
request as a graph against the same request run eagerly
(RIFFUSION_TPU_NO_AOT=1), with a new request's inputs and the kernel
counts per replay, and a program with a host sync refused at capture.
Every test is marked `cuda` and skips where torch sees no card. No jax
import, so it runs on a card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_aot_cuda.py
"""

import copy

import numpy as np
import pytest
import torch
from PIL import Image

from riffusion_tpu_torch import aot
from riffusion_tpu_torch.datatypes import InferenceInput, PromptInput
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops import attention as attn
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.riffusion_pipeline import RiffusionPipeline
from riffusion_tpu_torch.spectrogram_params import SpectrogramParams
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

SIZE = 256  # 32x32 latents: the tiny UNet's self-attention takes K1


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs and the Hopper kernels have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


@pytest.mark.parametrize("kernel,shape", [
    ("attention", (2, 1024, 8, 80)), ("attention", (2, 4096, 8, 40)),
    ("row_attention", (32, 4096, 8, 40))])
def test_kernels_replay_with_new_operands(card, kernel, shape):
    """K1 and K2 launch on the current stream, so a capture records them: a
    replay on new Q, K and V gives the kernel's eager output on those
    operands, bit for bit, and counts one launch."""
    fn = getattr(attn, kernel)
    b, s, h, d = shape
    counter = "launches" if kernel == "attention" else "row_launches"

    def program(q, k, v):
        return fn(q, k, v, num_heads=h, scale=d ** -0.5)

    gen = torch.Generator(device=card).manual_seed(0)
    operands = [tuple(torch.randn((b, s, h * d), generator=gen, device=card,
                                  dtype=torch.bfloat16) for _ in range(3)) for _ in range(3)]
    graph = aot.GraphProgram(program, f"{kernel}-{shape}")
    with torch.inference_mode():
        eager = [program(*x) for x in operands]
        for i, x in enumerate(operands):  # capture, then two replays on new operands
            COUNTS.reset()
            out = graph(*x)
            torch.cuda.synchronize()
            assert getattr(COUNTS, counter) == 1 and COUNTS.plain_calls == 0
            assert torch.equal(out, eager[i]), i
    assert len(graph) == 1


def _request(i: int, steps: int = 4) -> InferenceInput:
    return InferenceInput(start=PromptInput(prompt=f"church bells {i}", seed=1 + i, guidance=1.5),
                          end=PromptInput(prompt=f"techno {i}", seed=20 + i, guidance=1.5),
                          alpha=0.4, num_inference_steps=steps)


def test_tiny_request_graph_against_eager(card, monkeypatch):
    """The tiny model's riffuse_audio (pndm, fp32, K1 reached) on the card:
    the capturing call equals the eager call bit for bit (it is the eager
    program, run on a side stream), each replay with new requests equals
    their eager results, and every call counts the eager call's launches."""
    pipe = RiffusionPipeline(copy.deepcopy(random_bundle("tiny", seed=0, device="cpu",
                                                         dtype=torch.float32)), device="cuda")
    rng = np.random.default_rng(2)
    image = Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8))
    params = SpectrogramParams(num_frequencies=SIZE)

    def run(i):
        COUNTS.reset()
        im, seg = pipe.riffuse_audio(_request(i), image, params=params, scheduler="pndm")
        counts = COUNTS.snapshot()
        return np.asarray(im), seg.raw_data, counts

    monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    eager = [run(i) for i in range(3)]
    assert not pipe.graph_store.programs
    monkeypatch.delenv("RIFFUSION_TPU_NO_AOT")
    stored = [run(i) for i in range(3)] + [run(0)]
    (program,) = pipe.graph_store.programs.values()
    assert len(program) == 1
    for (ie, we, ce), (ig, wg, cg) in zip(eager + eager[:1], stored):
        assert ce == cg and ce["launches"] > 0 and ce["plain_calls"] == 0
        np.testing.assert_array_equal(ig, ie)
        np.testing.assert_array_equal(wg, we)


def test_a_host_sync_is_refused_at_capture(card):
    """A program that reads a value back to the host cannot be captured:
    the store raises with the key and the operation, and the card works
    on afterwards."""

    def synced(x):
        return x * float(x.sum().item())

    x = torch.ones(4, device=card)
    program = aot.GraphProgram(synced, "synced-program")
    with pytest.raises(aot.CaptureError, match=r"synced-program failed at .*item"):
        program(x)
    assert len(program) == 0
    assert float((x * 2).sum().item()) == 8.0
