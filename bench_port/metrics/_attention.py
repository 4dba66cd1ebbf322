"""Shared arithmetic of the attention rooflines (not a metric: no reader
is found under a name that starts with an underscore)."""

import re

from bench_port import count

FORWARD = "attention_fwd_bf16_kernel"
DKV = "attention_dkv_bf16_kernel"
DQ = "attention_dq_bf16_kernel"

_DEMANGLED = re.compile(r"<\s*(\d+)\s*,\s*(\d+)")
_MANGLED = re.compile(r"ILi(\d+)ELi(\d+)E")


def head_dim(kernel: str):
    """A kernel instance's head width, its second template argument."""
    m = _DEMANGLED.search(kernel) or _MANGLED.search(kernel)
    return int(m.group(2)) if m else None


def unet_batch(record) -> int:
    if record.cell["kind"] == "finetune":
        return record.cell["params"]["batch_size"]
    return 2  # a served clip's guided UNet


def sites(record):
    """The cell's self-attention sites by head width."""
    cfg = record.config
    if record.cell["kind"] == "finetune":
        h, w = cfg["dataset"]["latent_shape"][:2]
    else:
        h = w = 512 // 8
    return {s.head_dim: s for s in count.self_attention_sites(cfg["unet"], h, w)}


def share(record, backward=False):
    """Percent of the roofline: the least time of every traced forward
    launch at a site (with its backward where `backward`), over the traced
    time of those launches (and of the backward kernels); None where the
    trace has none."""
    trace = record.device_trace
    if trace is None:
        return None
    by_dim, batch = sites(record), unet_batch(record)
    bound = spent = 0.0
    for name, _, dur in trace.ops:
        if FORWARD not in name:
            continue
        d = head_dim(name)
        site = by_dim.get(d)
        if site is None:
            continue
        bound += count.least_seconds(*count.attention_cost(batch, site.seq, site.heads, d,
                                                           backward))
        spent += dur / 1e6
    if backward:
        spent += sum(dur for name, _, dur in trace.ops if DKV in name or DQ in name) / 1e6
    if spent == 0:
        return None
    return 100.0 * bound / spent
