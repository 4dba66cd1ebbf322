"""What the readers of the program's own spans and stage times share
(host_ms, device_ms; not a metric: no reader is found under a name that
starts with an underscore): riffusion_tpu_torch/tracing.py's export, which
a run puts in the record's counters["tracing"], and the window's part
before its trace on the export's clock (time.time_ns(); the record's
window is on the monotonic clock)."""

from __future__ import annotations

import time
import typing as T


def exported(record) -> T.Optional[T.Dict[str, T.Any]]:
    """The program's export, or None where the run has none."""
    return record.counters.get("tracing") or None


def untraced_ns(record) -> T.Tuple[int, int]:
    """The window's part before its trace (all of it, untraced), in ns of
    time.time_ns()."""
    offset = time.time_ns() - time.monotonic_ns()
    lo, hi = record.window[0], min(record.window[1], record.traced_from)
    return int(lo * 1e9) + offset, int(hi * 1e9) + offset


def spans_in(record, names: T.Iterable[str]) -> T.List[T.Dict[str, T.Any]]:
    """The program's spans of `names` that lie whole in the window's part
    before its trace."""
    traced = exported(record)
    if traced is None:
        return []
    lo, hi = untraced_ns(record)
    names = set(names)
    return [s for s in traced["spans"] if s["name"] in names and lo <= s["start_ns"]
            and s["start_ns"] + s["dur_ns"] <= hi]


def replays_in(record) -> T.List[T.Dict[str, T.Any]]:
    """The replays (read or not) launched in the window's part before its
    trace."""
    traced = exported(record)
    if traced is None:
        return []
    lo, hi = untraced_ns(record)
    return [r for r in traced["replays"] if lo <= r["start_ns"] < hi]


def self_ms(record, outer: str, inner: str) -> T.Dict[int, float]:
    """Per request or step id, the ms of its `outer` spans less those of
    their `inner` children, over the window's part before its trace."""
    found = spans_in(record, (outer, inner))
    out: T.Dict[int, float] = {}
    for s in found:
        if s["name"] == outer:
            out[s["id"]] = out.get(s["id"], 0.0) + s["dur_ns"] / 1e6
    for s in found:
        if s["name"] == inner and s["parent"] == outer and s["id"] in out:
            out[s["id"]] -= s["dur_ns"] / 1e6
    return out
