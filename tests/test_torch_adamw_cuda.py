"""
The one-pass AdamW kernel (riffusion_tpu_torch/csrc/adamw.cu, through
ops/adamw.py) and the one-card trainer that runs it, on a card:
- five steps of the kernel at some of SD v1's UNet leaf sizes (bf16 working
  gradients of its largest convolution and feed-forward weights beside fp32
  norms and conv_out), at odd sizes about a chunk's edge, and over 150 small
  leaves (three launches of 72): the masters and moments no farther from
  torch's AdamW in fp64 than torch's capturable foreach AdamW in fp32 is,
  times 2. Both round the same fp32 operations (the kernel its bias
  corrections once from fp64); a chunk skipped, read from the wrong leaf
  or with the wrong step count lies orders above that;
- one step of the kernel against its plain version on the card;
- the tiny trainer at bf16 compute: a captured `train_step` against the
  same steps run eagerly (bit-equal where two eager runs are, else within
  twice their distance), and `adamw_launches` counting every replay;
- the wrapper raises on what the kernel does not take.
Every test is marked `cuda` and skips where torch sees no card. No jax
import, so it runs on a card machine:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_adamw_cuda.py
"""

import numpy as np
import pytest
import torch

from riffusion_tpu_torch import tracing
from riffusion_tpu_torch.models.weights import random_bundle
from riffusion_tpu_torch.ops import adamw
from riffusion_tpu_torch.ops.kernels import COUNTS
from riffusion_tpu_torch.parallel.train import DiffusionTrainer
from riffusion_tpu_torch.util import torch_util

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
# (shape, the working gradient's dtype) of each leaf
CASES = {
    # up-block resnet conv1, GEGLU proj_in, a norm, conv_in, conv_out (fp32), a bias
    "unet": [((1280, 2560, 3, 3), BF16), ((10240, 1280), BF16), ((1280,), F32),
             ((320, 4, 3, 3), BF16), ((4, 320, 3, 3), F32), ((320,), BF16)],
    "odd": [((1,), F32), ((3,), BF16), ((4095,), BF16), ((4096,), F32), ((4097,), BF16),
            ((12345,), F32), ((1, 7, 5), BF16)],
    "many": [((int(n),), BF16 if i % 2 else F32)
             for i, n in enumerate(np.random.default_rng(0).integers(1, 5000, 150))],
}
STEPS = 5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch_util.configure_numerics()
    return torch.device("cuda")


def rate(step: int) -> float:
    return 1e-3 * (1.0 + step) / (2.0 + step * step)


def _leaves(card, case: str):
    gen = torch.Generator(device=card).manual_seed(0)
    masters = [0.05 * torch.randn(shape, generator=gen, device=card) for shape, _ in CASES[case]]
    grads = [[(torch.randn(shape, generator=gen, device=card) * 10.0 ** (i % 5 - 3)).to(dtype)
              for i, (shape, dtype) in enumerate(CASES[case])] for _ in range(STEPS)]
    return masters, grads


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().double().flatten() for t in tensors])


def _run(kind: str, masters, grads, card):
    """STEPS steps of one optimizer from `masters`: "kernel" (OnePassAdamW,
    reading the working dtypes' gradients), "torch" (capturable foreach
    AdamW on fp32 gradients), "fp64" (torch's AdamW in fp64); the masters
    and both moments, flat in fp64."""
    dtype = torch.float64 if kind == "fp64" else torch.float32
    params = [torch.nn.Parameter(m.clone().to(dtype)) for m in masters]
    # the working copy whose gradients the kernel reads in their own dtypes
    working = [torch.zeros_like(g, requires_grad=True) for g in grads[0]]
    hyper = dict(lr=rate(0), betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)
    if kind == "kernel":
        opt = adamw.OnePassAdamW(params, working=working, capturable=True, **hyper)
    else:
        opt = torch.optim.AdamW(params, capturable=kind == "torch", **hyper)
    for step in range(STEPS):
        for p, w, g in zip(params, working, grads[step]):
            if kind == "kernel":
                w.grad = g
            else:
                p.grad = g.to(dtype)
        opt.param_groups[0]["lr"] = (rate(step) if kind == "fp64" else
                                     torch.tensor(rate(step), device=card))
        opt.step()
    torch.cuda.synchronize()
    state = [opt.state[p] for p in params]
    assert {float(s["step"]) for s in state} == {float(STEPS)}
    return {"masters": _flat(params), "exp_avg": _flat(s["exp_avg"] for s in state),
            "exp_avg_sq": _flat(s["exp_avg_sq"] for s in state)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_against_fp64(card, case):
    masters, grads = _leaves(card, case)
    COUNTS.reset()
    ours = _run("kernel", masters, grads, card)
    assert COUNTS.adamw_launches == STEPS * adamw.launches([m.numel() for m in masters])
    theirs = _run("torch", masters, grads, card)
    exact = _run("fp64", masters, grads, card)
    moved = float((exact["masters"] - _flat(masters)).norm())
    for key in ("masters", "exp_avg", "exp_avg_sq"):
        err = float((ours[key] - exact[key]).norm())
        ref = float((theirs[key] - exact[key]).norm())
        assert err <= 2 * ref, (key, err, ref)
    # and the masters moved as far as fp64's, to within a thousandth
    assert float((ours["masters"] - exact["masters"]).norm()) <= 1e-3 * moved


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_against_plain_on_the_card(card, case):
    masters, grads = _leaves(card, case)
    results = {}
    for name in ("kernel", "plain"):
        torch.manual_seed(0)
        params = [m.clone() for m in masters]
        exp_avgs = [torch.randn_like(m).abs() * 1e-3 for m in masters]
        exp_avg_sqs = [e * e for e in exp_avgs]
        steps = [torch.full((), 3.0, device=card) for _ in masters]
        args = (params, grads[0], exp_avgs, exp_avg_sqs, steps)
        hyper = dict(lr=torch.tensor(1e-3, device=card), beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=1e-2)
        (adamw.adamw_ if name == "kernel" else adamw.adamw_reference)(*args, **hyper)
        results[name] = [_flat(x) for x in (params, exp_avgs, exp_avg_sqs)]
        assert {float(s) for s in steps} == {4.0}
    start = _flat(masters)
    (p, m, v), (pp, mp, vp) = results["kernel"], results["plain"]
    assert float((p - pp).norm() / (pp - start).norm()) < 1e-5
    for ours, plain in ((m, mp), (v, vp)):
        assert float((ours - plain).norm() / plain.norm()) < 1e-6


def _steps(card, monkeypatch, eager: bool, steps: int = 3):
    """`steps` steps of the tiny trainer at bf16 compute on 32x32 latents;
    the masters and moments, flat, and each step's adamw_launches."""
    if eager:
        monkeypatch.setenv("RIFFUSION_TPU_NO_AOT", "1")
    else:
        monkeypatch.delenv("RIFFUSION_TPU_NO_AOT", raising=False)
    trainer = DiffusionTrainer(device=card, learning_rate=rate, dtype=torch.bfloat16)
    trainer.init_from(random_bundle("tiny", seed=0, device="cpu").unet)
    assert isinstance(trainer.optimizer, adamw.OnePassAdamW)
    rng = np.random.default_rng(0)
    latents = torch.from_numpy(rng.standard_normal((2, 32, 32, 4)).astype(np.float32))
    context = torch.from_numpy(rng.standard_normal((2, 77, 64)).astype(np.float32))
    gen = torch.Generator(device=card)
    counts = []
    for step in range(steps):
        gen.manual_seed(1000 + step)
        COUNTS.reset()
        trainer.step(latents, context, generator=gen)
        counts.append(COUNTS.adamw_launches)
    torch.cuda.synchronize()
    params = list(trainer.master.parameters())
    state = [trainer.optimizer.state[p] for p in params]
    assert all(w.grad is None for w in trainer.unet.parameters())
    return {"masters": _flat(params), "exp_avg": _flat(s["exp_avg"] for s in state),
            "exp_avg_sq": _flat(s["exp_avg_sq"] for s in state)}, counts, trainer


def test_a_captured_step_agrees_with_the_eager_one(card, monkeypatch):
    a, counts_a, trainer = _steps(card, monkeypatch, eager=True)
    b, _, _ = _steps(card, monkeypatch, eager=True)
    ours, counts, graph_trainer = _steps(card, monkeypatch, eager=False)
    assert sorted(graph_trainer.graph_store.programs) == ["train_step"]
    expected = adamw.launches([p.numel() for p in trainer.master.parameters()])
    assert counts == counts_a == [expected] * 3
    start = _flat(random_bundle("tiny", seed=0, device="cpu").unet.parameters()).to(card)
    if all(torch.equal(a[k], b[k]) for k in a):
        for key in a:
            assert torch.equal(ours[key], a[key]), key
        return
    for key in a:  # the eager runs differ: within twice their distance of the nearer one
        scale = (a[key] - start).norm() if key == "masters" else a[key].norm()
        eager = float((a[key] - b[key]).norm() / scale)
        gap = min(float((ours[key] - r[key]).norm() / scale) for r in (a, b))
        assert gap <= max(2 * eager, 1e-6), (key, gap, eager)


def test_tracing_export_counts_the_replays(card, monkeypatch):
    _, counts, trainer = _steps(card, monkeypatch, eager=False, steps=4)
    expected = adamw.launches([p.numel() for p in trainer.master.parameters()])
    assert counts == [expected] * 4 and expected > 0
    COUNTS.reset()
    trainer.step(np.zeros((2, 32, 32, 4), np.float32), np.zeros((2, 77, 64), np.float32),
                 generator=torch.Generator(device=card).manual_seed(0))
    assert tracing.export()["counters"]["adamw_launches"] == expected


def test_the_wrapper_raises_on_what_the_kernel_does_not_take(card):
    p = torch.zeros(8, device=card)
    good = dict(params=[p], grads=[torch.zeros(8, device=card, dtype=BF16)],
                exp_avgs=[torch.zeros(8, device=card)], exp_avg_sqs=[torch.zeros(8, device=card)],
                steps=[torch.zeros((), device=card)])
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    adamw.adamw_(**good, **hyper)
    for key, bad in (("grads", [torch.zeros(8, device=card, dtype=torch.float16)]),
                     ("steps", [torch.zeros(())]),
                     ("exp_avgs", [torch.zeros(16, device=card)[::2]]),
                     ("params", [torch.zeros(8, device=card, dtype=torch.float64)])):
        with pytest.raises(ValueError):
            adamw.adamw_(**dict(good, **{key: bad}), **hyper)
