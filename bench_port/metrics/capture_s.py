"""capture_s: the seconds the graph stores spent on the cell's program keys
in set-up, each key's warm-up run and its capture (aot.py's stage reports:
the pipeline's graph store, or the trainer's)."""

SOURCE, UNIT, BETTER = "program_counter", "s", "lower"


def read(record, name):
    reports = record.counters.get("graphs")
    if not reports:
        return None
    return sum(r["warmup_s"] + r["capture_s"] for r in reports)
