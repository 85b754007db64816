"""Host milliseconds for a call of the port's train step (train/step.py) to
return, with no synchronize inside the window: the mean over the window."""


def read(ctx):
    return ctx.host.get("step_host_s", 0.0) * 1e3 or None
