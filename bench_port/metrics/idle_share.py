"""idle_share.<cell>: the share of the traced window in which no kernel,
copy or set ran on the card (torch.profiler's device intervals, merged)."""

SOURCE, UNIT, BETTER = "device_trace", "%", "lower"


def read(record, name):
    trace = record.device_trace
    if trace is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
