"""attn_roofline.<cell>: the training step's attention kernels together, K1
with the log-sum-exp forward, dK/dV (csrc/attention_dkv.cu) and dQ
(csrc/attention_dq.cu): the least time of each site's forward and backward
(count.py) over the traced time of all three kernels' launches."""

from bench_port.metrics import _attention

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"


def read(record, name):
    return _attention.share(record, backward=True)
