"""
Serving traffic on SDXL: the closed-loop listeners of traffic/serve.py
(`POST /run_inference/` to the port's HTTP server in this process, over
127.0.0.1, prompts walking in alpha steps), with the system composed by
sut_xl.py and the window's clips checked by check_serve_xl.py.

serve.py's driver runs as it is, on a module object of its own whose `sut`
and `check_serve` are SDXL's: the weights and the pipeline of sut_xl.py,
the cell's seed image tiled along time at set-up and written to a
temporary directory that the server reads it from by id, and the SDXL
reference's check.

Where the run is traced (`--trace 1`), the program's own tracing is on from
before set-up (RIFFUSION_TPU_TRACE=1, so the request's graph is captured
with its stage events), and after the window tracing.export() goes into
the record's counters["tracing"] and the program's spans into its spans,
as bench_port/traced.py puts them; with `--trace 0` none of this happens.
"""

from __future__ import annotations

import os
import tempfile
import types
from pathlib import Path

from bench_port import check_serve_xl, harness, sut_xl


def export(record: harness.Record) -> None:
    """The program's export into counters["tracing"], its spans into the
    record's spans (name, start_us, duration_us); nothing where the program
    has no tracing of its own or it is off."""
    try:
        from riffusion_tpu_torch import tracing
    except ImportError:
        return
    if not tracing.enabled():
        return
    exported = tracing.export()
    record.counters["tracing"] = exported
    record.spans.extend((s["name"], s["start_ns"] / 1e3, s["dur_ns"] / 1e3)
                        for s in exported["spans"])


def run(record: harness.Record) -> None:
    if record.trace:
        os.environ["RIFFUSION_TPU_TRACE"] = "1"
    serve = harness.traffic("serve")
    with tempfile.TemporaryDirectory(prefix="bench_port_seed_") as tmp:
        record.notes["image_size"] = sut_xl.write_seed_image(record.cell["params"], Path(tmp))

        def server(pipe):
            from riffusion_tpu_torch import server as port_server

            port_server.PIPELINE = pipe
            return port_server.RiffusionServer(("127.0.0.1", 0), seed_images_dir=tmp)

        serve.sut = types.SimpleNamespace(weights=sut_xl.weights, pipeline=sut_xl.pipeline,
                                          server=server, INPUTS=Path(tmp))
        serve.check_serve = check_serve_xl
        serve.run(record)
    if record.trace:
        export(record)
