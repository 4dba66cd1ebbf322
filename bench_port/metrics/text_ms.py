"""text_ms.<cell>: the host ms a request spends in the pipeline's
`riffusion.text` span (both towers' encodes where a prompt is new, the
embedding caches' lookups, the alpha walk of the context and the pooled
vector), the mean over the requests (`riffusion.request` spans) of the
window's part before its trace. None where the run recorded no such span
(the program's tracing off)."""

import statistics

from bench_port.metrics import _program

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(record, name):
    found = _program.spans_in(record, ("riffusion.request", "riffusion.text"))
    requests = {s["id"] for s in found if s["name"] == "riffusion.request"}
    if not requests:
        return None
    text = dict.fromkeys(requests, 0.0)
    for s in found:
        if s["name"] == "riffusion.text" and s["id"] in text:
            text[s["id"]] += s["dur_ns"] / 1e6
    return statistics.fmean(text.values())
