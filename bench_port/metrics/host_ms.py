"""host_ms.<part>: the mean host ms per request or step of one of the
program's own spans (riffusion_tpu_torch/tracing.py) less its child that
waits on the card or on the socket, over the window's part before its
trace:
- front: `riffusion.request` (server.py's do_POST: the JSON and the seed
  image, the encodes, the send) less its `riffusion.call`;
- call: `riffusion.call` (the pipeline's riffuse_audio: the host part, the
  launch, the results' PIL and AudioSegment) less its `riffusion.readback`;
- step: `riffusion.train.step` (the trainer's step: the launch) less its
  `riffusion.train.upload` (the copies that wait for the last step).
None where the run recorded none of them (the program's tracing off)."""

import statistics

from bench_port.metrics import _program

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"

PARTS = {
    "front": ("riffusion.request", "riffusion.call"),
    "call": ("riffusion.call", "riffusion.readback"),
    "step": ("riffusion.train.step", "riffusion.train.upload"),
}


def read(record, name):
    found = _program.self_ms(record, *PARTS[name.split(".", 1)[1]])
    return statistics.fmean(found.values()) if found else None
