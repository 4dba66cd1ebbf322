"""clip_latency_ms: the mean client wall time, from sending to reading the
whole response, of the POST /run_inference/ requests completed in the
window."""

import statistics

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(record, name):
    done = record.in_window()
    if not done:
        return None
    return 1e3 * statistics.fmean(r.wall_s for r in done)
