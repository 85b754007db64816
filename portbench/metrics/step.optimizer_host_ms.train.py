"""Host milliseconds of the port's span "step.optimizer" (train/step.py:
the gradient sync where there is one, the global norm and the three-
group Adam update): the mean over the untraced window, from the
program's ring (portbench/spans.py::host_ms)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "step.optimizer")
