"""device_ms.<part>: the mean device ms per replay read of the stages of
one layer, timed by events inside the replayed CUDA graph
(riffusion_tpu_torch/tracing.py: each stage span records a pair, read at
the graph's next launch), over the replays launched in the window's part
before its trace:
- denoise: `riffusion.denoise` (the UNet's CFG loop, K1);
- vae: `riffusion.vae_encode` + `riffusion.vae_decode` (fp32);
- dsp: `riffusion.audio` (codec, inverse mel, Griffin-Lim);
- unet: `riffusion.train.forward` + `riffusion.train.backward`;
- optimizer: `riffusion.train.copy` + `.grads` + `.optimizer` (the masters'
  copies and AdamW);
- ema: `riffusion.train.ema`.
None where no replay with those stages was read."""

import statistics

from bench_port.metrics import _program

SOURCE, UNIT, BETTER = "program_counter", "ms", "lower"

PARTS = {
    "denoise": ("riffusion.denoise",),
    "vae": ("riffusion.vae_encode", "riffusion.vae_decode"),
    "dsp": ("riffusion.audio",),
    "unet": ("riffusion.train.forward", "riffusion.train.backward"),
    "optimizer": ("riffusion.train.copy", "riffusion.train.grads", "riffusion.train.optimizer"),
    "ema": ("riffusion.train.ema",),
}


def read(record, name):
    stages = PARTS[name.split(".", 1)[1]]
    found = [sum(r["stages"].get(s, 0.0) for s in stages) for r in _program.replays_in(record)
             if r["stages"] and any(s in r["stages"] for s in stages)]
    return statistics.fmean(found) if found else None
