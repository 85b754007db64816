"""Host milliseconds of the port's span "step.loss" (train/step.py: the
losses: retrieval, and the set criterion with the matcher over every
decoder layer): the mean over the untraced window, from the program's
ring (portbench/spans.py::host_ms)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "step.loss")
