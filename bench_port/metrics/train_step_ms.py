"""train_step_ms: the window's length over the optimizer steps completed in
it; a step is run_finetune's loop body (a batch drawn, the step, the EMA),
and the window ends when the card has finished the last one."""

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(record, name):
    return 1e3 * record.window_s / len(record.steps) if record.steps else None
