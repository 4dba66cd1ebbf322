"""k1_roofline.<cell>: K1 (csrc/attention.cu), the forward attention kernel
at every self-attention site it takes: its least time summed over the
traced launches, from each launch's site shape (count.py: FLOPs, bytes,
exp2), over their traced time (attention_fwd_bf16_kernel instances)."""

from bench_port.metrics import _attention

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"


def read(record, name):
    return _attention.share(record)
