"""Device milliseconds a traced step of the kernels launched inside the
port's span "step.backward" (train/step.py: loss.backward()), on any
host thread (portbench/spans.py)."""

from portbench.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "step.backward")
