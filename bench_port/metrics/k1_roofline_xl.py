"""k1_roofline_xl.<cell>: K1 (csrc/attention.cu) at SDXL's self-attention
sites, (2, 4096, 10 x 64) x 10 and (2, 1024, 20 x 64) x 60 an evaluation:
its least time (count_xl.py) over the traced time of its launches
(attention_fwd_bf16_kernel instances of head width 64). Both sites take
the same instance, so each traced launch is given the evaluation's mean
least time a launch; a trace that cuts an evaluation moves the share by at
most 70 launches' worth of the difference. None where the trace has no
such launch."""

from bench_port import count_xl
from bench_port.metrics import _attention

SOURCE, UNIT, BETTER = "device_trace", "%", "higher"


def read(record, name):
    trace = record.device_trace
    if trace is None:
        return None
    spent = [dur / 1e6 for op, _, dur in trace.ops
             if _attention.FORWARD in op and _attention.head_dim(op) == 64]
    if not spent:
        return None
    height, width = record.notes["image_size"]
    bound = count_xl.k1_least_seconds_per_launch(record.config, height, width)
    return 100.0 * bound * len(spent) / sum(spent)
