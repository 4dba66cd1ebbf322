"""mfu.<cell>: model FLOPs of the work completed in the window (count.py:
the UNet's and the VAE's products, forward; forward and backward for a
training step) over the window's length times the cards' bf16 dense
peak. In a traced run, over the part of the window before the trace."""

from bench_port import count

SOURCE, UNIT, BETTER = "host_clock", "%", "higher"


def read(record, name):
    cfg, params = record.config, record.cell["params"]
    seconds, requests = record.untraced()
    if record.cell["kind"] == "finetune":
        steps = [t for t in record.steps if t < record.window[0] + seconds]
        work = len(steps) * count.train_step_flops(cfg, params["batch_size"])
    else:
        work = len(requests) * count.clip_flops(cfg, record.notes["evaluations"])
    if work == 0 or seconds <= 0:
        return None
    return 100.0 * work / (seconds * record.cell["chips"] * count.PEAK_BF16_FLOPS)
