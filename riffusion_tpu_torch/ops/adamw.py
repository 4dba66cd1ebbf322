"""
AdamW over a model's parameters in one pass, reading each gradient where
the backward left it: the hand-written Hopper kernel (csrc/adamw.cu), its
plain PyTorch version, the launch geometry, and `OnePassAdamW`, the
torch.optim.AdamW whose step runs it.

`adamw_(params, grads, exp_avgs, exp_avg_sqs, steps, lr=..., ...)` takes one
AdamW step in place over lists of leaves: fp32 (or, on the CPU, any float)
masters, their gradients (bf16 or the masters' dtype: a bf16 gradient is
widened exactly as .to() widens it), the moments and the step counts (0-d
tensors), with optax.adamw's arithmetic as torch's AdamW computes it (the
decay on every parameter, decoupled; the bias corrections from the step
count); `lr` is a float or a 0-d tensor.

- For CUDA tensors the wrapper launches the kernel (fp32 masters, moments
  and step counts; lr a 0-d fp32 tensor on the card, or a float), or
  raises. Nothing falls back.
- For CPU tensors it runs `adamw_reference`, the plain version: the same
  arithmetic in torch operations, leaf by leaf.

No TPU kernel stands behind it: the JAX trainer's step is one jitted
program into which XLA fuses optax's AdamW. The kernel exists because the
port's step ran torch's foreach AdamW on fp32 copies of the gradients (the
trainer's `riffusion.train.grads` stage), a third of the step's device time
for a few milliseconds of traffic.

`COUNTS.adamw_launches` (ops.kernels.COUNTS) counts the kernel's launches
(`launches`: per batch of LEAVES_PER_LAUNCH leaves, the update and the
step counts' increment); a replayed CUDA graph counts them again (aot.py).
The kernel is built with the trainer's round (ops.kernels.TRAIN_KERNELS) at
its first use; serving never builds or loads it.
"""

from __future__ import annotations

import ctypes
import typing as T

import torch

from riffusion_tpu_torch.ops import kernels

__all__ = ["adamw_", "adamw_reference", "launches", "OnePassAdamW", "LEAVES_PER_LAUNCH",
           "BLOCKS_PER_SM"]

#: Leaves a launch (csrc/adamw.cu kMaxLeaves, what a launch's 4 KB of
#: parameters holds), for `launches`.
LEAVES_PER_LAUNCH = 72
#: The blocks a launch's grid holds per SM, at most (a block walks the
#: launch's chunks in a grid-stride loop). On an H100, scripts/time_adamw.py
#: at the UNet's leaves read 7.74-8.03 ms over 1, 2, 3, 4 and 8 (PERF.md
#: section 6): flat, since two 256-thread blocks of 98 registers fit an SM.
BLOCKS_PER_SM = 4


def launches(numels: T.Sequence[int]) -> int:
    """The kernel launches of one step over leaves of these sizes: per batch
    of LEAVES_PER_LAUNCH leaves, the update (where the batch holds an
    element) and the step counts' increment."""
    batches = [numels[i:i + LEAVES_PER_LAUNCH] for i in range(0, len(numels), LEAVES_PER_LAUNCH)]
    return sum(1 + (sum(b) > 0) for b in batches)


def adamw_reference(
    params: T.Sequence[torch.Tensor], grads: T.Sequence[torch.Tensor],
    exp_avgs: T.Sequence[torch.Tensor], exp_avg_sqs: T.Sequence[torch.Tensor],
    steps: T.Sequence[torch.Tensor], *, lr: T.Union[float, torch.Tensor], beta1: float,
    beta2: float, eps: float, weight_decay: float,
) -> None:
    """The plain version, in place, leaf by leaf: the step count + 1, then
    torch's AdamW arithmetic in the masters' dtype (the decay, the lerp of
    m, v's multiply and addcmul) with the gradient widened to that dtype,
    and the bias corrections 1 - beta^count in fp64, rounded to that dtype
    (torch's AdamW takes them from a Python float count; fp32 would keep
    about four digits of 1 - 0.999^count at the first steps)."""
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps, strict=True):
        step += 1
        g = g.to(p.dtype)
        p.mul_(1 - lr * weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        count = step.double()
        bc1, bc2 = ((1 - beta ** count).to(p.dtype) for beta in (beta1, beta2))
        p.sub_(lr / bc1 * m / (v.sqrt() / bc2.sqrt() + eps))


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr: torch.Tensor) -> None:
    """What the kernel reads: contiguous fp32 masters and moments of one
    shape a leaf, a contiguous bf16 or fp32 gradient of the leaf's size, an
    fp32 0-d step count, and a 0-d fp32 lr, all on one card."""
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"adamw_ runs on cuda or cpu tensors, got {device}")
    if lr.shape != () or lr.dtype != torch.float32 or lr.device != device:
        raise ValueError(f"lr must be a 0-d float32 tensor on {device}, got {tuple(lr.shape)} "
                         f"{lr.dtype} {lr.device}")
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps, strict=True):
        for name, x in (("param", p), ("exp_avg", m), ("exp_avg_sq", v)):
            if x.dtype != torch.float32 or x.device != device or not x.is_contiguous() \
                    or x.shape != p.shape:
                raise ValueError(f"{name} must be a contiguous float32 tensor of shape "
                                 f"{tuple(p.shape)} on {device}, got {tuple(x.shape)} {x.dtype} "
                                 f"{x.device}")
        if g.dtype not in (torch.bfloat16, torch.float32) or g.device != device \
                or not g.is_contiguous() or g.numel() != p.numel():
            raise ValueError(f"a gradient must be a contiguous bfloat16 or float32 tensor of "
                             f"{p.numel()} elements on {device}, got {tuple(g.shape)} {g.dtype} "
                             f"{g.device}")
        if step.shape != () or step.dtype != torch.float32 or step.device != device:
            raise ValueError(f"a step count must be a 0-d float32 tensor on {device} (a "
                             f"capturable optimizer's), got {step.dtype} on {step.device}")


def _launch(params, grads, exp_avgs, exp_avg_sqs, steps, lr: torch.Tensor, beta1: float,
            beta2: float, eps: float, weight_decay: float) -> None:
    """Every batch's launches on the current stream; raises if one is
    refused."""
    _check(params, grads, exp_avgs, exp_avg_sqs, steps, lr)
    n = len(params)

    def pointers(tensors) -> ctypes.Array:
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])

    device = params[0].device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rc = kernels.entry("adamw")(
        pointers(params), pointers(exp_avgs), pointers(exp_avg_sqs), pointers(grads),
        pointers(steps), (ctypes.c_longlong * n)(*[p.numel() for p in params]),
        (ctypes.c_int * n)(*[int(g.dtype == torch.bfloat16) for g in grads]), n, lr.data_ptr(),
        float(beta1), float(beta2), float(eps), float(weight_decay), BLOCKS_PER_SM * sms,
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"adamw kernel launch failed with CUDA error {rc}")


@torch.no_grad()
def adamw_(
    params: T.Sequence[torch.Tensor], grads: T.Sequence[torch.Tensor],
    exp_avgs: T.Sequence[torch.Tensor], exp_avg_sqs: T.Sequence[torch.Tensor],
    steps: T.Sequence[torch.Tensor], *, lr: T.Union[float, torch.Tensor], beta1: float,
    beta2: float, eps: float, weight_decay: float,
) -> None:
    """One AdamW step in place over the leaves (module docstring):
    csrc/adamw.cu for CUDA tensors, `adamw_reference` for CPU tensors."""
    if not params:
        return
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay)
    device = params[0].device
    if device.type == "cpu":
        adamw_reference(params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr, **hyper)
        return
    if not isinstance(lr, torch.Tensor):  # a fill on the card: no upload, so it captures
        lr = torch.full((), lr, dtype=torch.float32, device=device)
    _launch(params, grads, exp_avgs, exp_avg_sqs, steps, lr, **hyper)
    kernels.COUNTS.adamw_launches += launches([p.numel() for p in params])


class OnePassAdamW(torch.optim.AdamW):
    """torch.optim.AdamW whose step is `adamw_`: its param_groups, its
    per-parameter state (`step`, `exp_avg`, `exp_avg_sq`), its state_dict
    and its profiler annotation as torch's, for each group one pass over
    its parameters that have a gradient. `working`, paired in order with
    `params` (tensors), names where a parameter's gradient lies when its
    own `.grad` is None: a working copy's parameter, whose bf16 gradient
    the pass reads as it is (parallel/train.py on one card). amsgrad,
    maximize and differentiable are not taken."""

    def __init__(self, params: T.Iterable[torch.Tensor],
                 working: T.Optional[T.Iterable[torch.Tensor]] = None, **kwargs: T.Any):
        params = list(params)
        super().__init__(params, **kwargs)
        for flag in ("amsgrad", "maximize", "differentiable"):
            if self.defaults[flag]:
                raise ValueError(f"OnePassAdamW does not take {flag}=True")
        self._working = ({} if working is None else
                         {id(p): w for p, w in zip(params, working, strict=True)})

    def _grad(self, p: torch.Tensor) -> T.Optional[torch.Tensor]:
        if p.grad is not None:
            return p.grad
        work = self._working.get(id(p))
        return None if work is None else work.grad

    @torch.no_grad()
    def step(self, closure: T.Optional[T.Callable[[], float]] = None) -> T.Optional[float]:
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            leaves = []
            for p in group["params"]:
                grad = self._grad(p)
                if grad is None:
                    continue
                state = self.state[p]
                if not state:  # torch's AdamW state, made at a parameter's first step
                    on_device = group["capturable"] or group["fused"]
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device if on_device else "cpu")
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                leaves.append((p, grad, state["exp_avg"], state["exp_avg_sq"], state["step"]))
            if leaves:
                beta1, beta2 = group["betas"]
                adamw_(*map(list, zip(*leaves)), lr=group["lr"], beta1=beta1, beta2=beta2,
                       eps=group["eps"], weight_decay=group["weight_decay"])
        return loss
