"""Device milliseconds a traced step of the kernels launched inside the
port's span "step.loss" (train/step.py: the losses: retrieval, and the
set criterion with the matcher over every decoder layer), on any host
thread (portbench/spans.py)."""

from portbench.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "step.loss")
