"""mfu_xl.<cell>: SDXL's model FLOPs of the clips completed in the window
(count_xl.py: the UNet's products at each guided evaluation, the VAE's
encode and decode) over the window's length times the cards' bf16 dense
peak; in a traced run, over the part of the window before the trace."""

from bench_port import count, count_xl

SOURCE, UNIT, BETTER = "host_clock", "%", "higher"


def read(record, name):
    seconds, requests = record.untraced()
    if not requests or seconds <= 0:
        return None
    height, width = record.notes["image_size"]
    work = len(requests) * count_xl.clip_flops(record.config, record.notes["evaluations"],
                                               height, width)
    return 100.0 * work / (seconds * record.cell["chips"] * count.PEAK_BF16_FLOPS)
