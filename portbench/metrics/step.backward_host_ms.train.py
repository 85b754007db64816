"""Host milliseconds of the port's span "step.backward" (train/step.py:
loss.backward()): the mean over the untraced window, from the program's
ring (portbench/spans.py::host_ms)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "step.backward")
