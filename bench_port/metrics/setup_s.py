"""setup_s: seconds from the process's start to the window's first request
or step: weights made on the card, the program built, kernels built or
loaded, every shape of the window warmed up and its CUDA graphs captured."""

SOURCE, UNIT, BETTER = "host_clock", "s", "lower"


def read(record, name):
    return record.setup_s
