"""The readers of the program's own spans and stage times (metrics/host_ms.py,
metrics/device_ms.py) and bench_port/traced.py's additions, on synthetic
records: the window's part before the trace on the export's clock, each
part's self time per request or step, the stage sums per replay read, None
where nothing was recorded; the idle time by idle_gaps' labels; the
program's export and spans put into the record only with its tracing on;
the metrics' entries against the benchmark's rules."""

from __future__ import annotations

import time

import pytest

from bench_port import harness
from bench_port.metrics import _program
from bench_port.tests.test_bench_port_manifest import NAME, UNIT, _line

OFFSET = time.time_ns() - time.monotonic_ns()


def _ns(t: float) -> int:
    """A monotonic time on the export's clock."""
    return int(t * 1e9) + OFFSET


def _record(spans=(), replays=(), window=(100.0, 200.0), traced_from=150.0, export=True):
    record = harness.Record(cell={"name": "c"}, config={}, seed=0, seconds=100.0, trace=True,
                            started=0.0)
    record.window, record.traced_from = window, traced_from
    if export:
        record.counters["tracing"] = {"spans": list(spans), "replays": list(replays),
                                      "totals": {}, "stages": {}, "counters": {}}
    return record


def _span(name, parent, ident, start_s, dur_ms):
    return {"name": name, "parent": parent, "id": ident, "thread": 1, "start_ns": _ns(start_s),
            "dur_ns": int(dur_ms * 1e6)}


def _request(ident, at, request_ms, call_ms, readback_ms):
    return [_span("riffusion.request", None, ident, at, request_ms),
            _span("riffusion.call", "riffusion.request", ident, at + 0.001, call_ms),
            _span("riffusion.readback", "riffusion.call", ident, at + 0.002, readback_ms)]


def _read(family, record, name):
    return harness.reader(family).read(record, name)


def test_host_ms_reads_self_time_before_the_trace():
    spans = (_request(1, 110.0, 100.0, 80.0, 50.0) + _request(2, 120.0, 120.0, 90.0, 70.0)
             + _request(3, 90.0, 500.0, 400.0, 1.0)  # before the window
             + _request(4, 160.0, 500.0, 400.0, 1.0)  # in the trace
             + _request(5, 149.99, 500.0, 400.0, 1.0))  # ends in the trace
    record = _record(spans)
    assert _read("host_ms", record, "host_ms.front") == pytest.approx(25.0)
    assert _read("host_ms", record, "host_ms.call") == pytest.approx(25.0)
    assert _read("host_ms", record, "host_ms.step") is None


def test_host_ms_step_and_a_child_of_another_parent():
    spans = [_span("riffusion.train.step", None, 7, 101.0, 10.0),
             _span("riffusion.train.upload", "riffusion.train.step", 7, 101.0, 4.0),
             _span("riffusion.train.step", None, 8, 102.0, 12.0),
             _span("riffusion.train.upload", "riffusion.train.step", 8, 102.0, 2.0),
             _span("riffusion.train.upload", "riffusion.launch", 8, 102.0, 2.0)]
    record = _record(spans, traced_from=float("inf"))
    assert _read("host_ms", record, "host_ms.step") == pytest.approx(8.0)


def _replay(key, at, stages):
    return {"key": key, "id": None, "start_ns": _ns(at), "stages": stages}


def test_device_ms_reads_the_replays_read_before_the_trace():
    serve = {"riffusion.vae_encode": 30.0, "riffusion.denoise": 600.0,
             "riffusion.vae_decode": 70.0, "riffusion.audio": 40.0}
    replays = [_replay("riffuse", 110.0, serve),
               _replay("riffuse", 111.0, dict(serve, **{"riffusion.denoise": 620.0})),
               _replay("riffuse", 112.0, None),  # unread: not a reading
               _replay("riffuse", 99.0, dict(serve, **{"riffusion.denoise": 1.0})),
               _replay("riffuse", 151.0, dict(serve, **{"riffusion.denoise": 1.0}))]
    record = _record(replays=replays)
    assert _read("device_ms", record, "device_ms.denoise") == pytest.approx(610.0)
    assert _read("device_ms", record, "device_ms.vae") == pytest.approx(100.0)
    assert _read("device_ms", record, "device_ms.dsp") == pytest.approx(40.0)
    assert _read("device_ms", record, "device_ms.unet") is None
    assert [r["stages"] is None for r in _program.replays_in(record)] == [False, False, True]


def test_device_ms_of_the_train_programs():
    step = {"riffusion.train.copy": 5.0, "riffusion.train.forward": 30.0,
            "riffusion.train.backward": 60.0, "riffusion.train.grads": 4.0,
            "riffusion.train.optimizer": 11.0}
    replays = [_replay("train_step", 101.0, step), _replay("ema_update", 101.1,
                                                           {"riffusion.train.ema": 3.0})]
    record = _record(replays=replays)
    assert _read("device_ms", record, "device_ms.unet") == pytest.approx(90.0)
    assert _read("device_ms", record, "device_ms.optimizer") == pytest.approx(20.0)
    assert _read("device_ms", record, "device_ms.ema") == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["host_ms.front", "host_ms.call", "host_ms.step",
                                  "device_ms.denoise", "device_ms.vae", "device_ms.dsp",
                                  "device_ms.unet", "device_ms.optimizer", "device_ms.ema"])
def test_nothing_recorded_reads_none(name):
    family = name.split(".")[0]
    assert _read(family, _record(export=False), name) is None  # a program without tracing
    assert _read(family, _record(), name) is None  # its tracing off


def test_idle_by_label_sums_the_gaps_idle_gaps_names():
    from bench_port import traced

    trace = harness.Trace(ops=[("k", 0.0, 10.0), ("k", 20.0, 10.0), ("k", 50.0, 10.0),
                               ("k", 100.0, 5.0)], window_s=1e-4, busy_s=3.5e-5)
    spans = [("riffusion.request", 0.0, 70.0), ("riffusion.readback", 15.0, 10.0),
             ("request (the HTTP front outside the call)", 0.0, 110.0)]
    # gaps 10-20 (middle 15: readback), 30-50 (request), 60-100 (middle 80:
    # only the client's span)
    assert traced.idle_by_label(trace, spans) == pytest.approx({
        "riffusion.readback": 10e-6, "riffusion.request": 20e-6,
        "request (the HTTP front outside the call)": 40e-6})


@pytest.mark.parametrize("on", [False, True])
def test_export_puts_the_programs_spans_in_the_record_only_with_the_switch(monkeypatch, on):
    from bench_port import traced
    from riffusion_tpu_torch import tracing

    if on:
        monkeypatch.setenv("RIFFUSION_TPU_TRACE", "1")
    else:
        monkeypatch.delenv("RIFFUSION_TPU_TRACE", raising=False)
    tracing.reset()
    with tracing.span("riffusion.request"):
        pass
    record = _record(export=False)
    record.spans.append(("request (the HTTP front outside the call)", 0.0, 1.0))
    traced.export(record)
    tracing.reset()
    assert ("tracing" in record.counters) == on
    assert [s[0] for s in record.spans] == ["request (the HTTP front outside the call)"] + (
        ["riffusion.request"] if on else [])
    if on:
        (span,) = record.counters["tracing"]["spans"]
        assert record.spans[1][1:] == (span["start_ns"] / 1e3, span["dur_ns"] / 1e3)


def test_the_traced_metrics_keep_the_benchmarks_rules():
    from bench_port import traced

    cells = {c["name"] for c in harness.manifest()["workloads"]}
    names = [m["name"] for m in traced.TRACED_METRICS]
    assert len(names) == len(set(names)) == 9
    assert not set(names) & {m["name"] for m in harness.manifest()["per_layer"]}
    for entry in traced.TRACED_METRICS:
        assert NAME.match(entry["name"]) and UNIT.match(entry["unit"]) and _line(entry["layer"])
        assert entry["source"] in ("program_counter", "host_clock")
        assert set(entry["workloads"]) <= cells
        assert harness.reader(entry["name"]).SOURCE == entry["source"]
