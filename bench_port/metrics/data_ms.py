"""data_ms.<cell>: the mean host time of drawing one batch from
LatentDataset.batches (training/dataset.py) in the window, a span of the
benchmark's around the loop's next(batches); in a traced run, before the
trace."""

import statistics

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(record, name):
    draws = [d for t, d in record.data_s if t < record.traced_from]
    return 1e3 * statistics.fmean(draws) if draws else None
