"""Device milliseconds a traced step of the kernels launched inside the
port's span "step.optimizer" (train/step.py: the gradient sync where
there is one, the global norm and the three-group Adam update), on any
host thread (portbench/spans.py)."""

from portbench.spans import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "step.optimizer")
