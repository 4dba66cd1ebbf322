"""stage_ms.<part>: the SDXL player's stage times, read as
metrics/device_ms.py reads the same parts: the mean device ms per replay
of the part's stages, timed by events inside the replayed CUDA graph,
over the replays launched in the window's part before its trace:
- denoise: `riffusion.denoise` (the UNet's CFG loop, K1);
- vae: `riffusion.vae_encode` + `riffusion.vae_decode` (fp32).
None where no replay with those stages was read."""

from bench_port.metrics import device_ms

SOURCE, UNIT, BETTER = device_ms.SOURCE, device_ms.UNIT, device_ms.BETTER


def read(record, name):
    return device_ms.read(record, name)
