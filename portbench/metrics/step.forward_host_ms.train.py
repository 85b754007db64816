"""Host milliseconds of the port's span "step.forward" (train/step.py: the
model's forward): the mean over the untraced window, from the program's
ring (portbench/spans.py::host_ms)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "step.forward")
