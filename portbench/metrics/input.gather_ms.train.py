"""Device milliseconds a step of the kernels launched inside the
benchmark's `record_function` range around its call to the port's
data/device_data.py::gather_batch, over the traced steps."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.trace_units:
        return None
    return t.range_device_s("portbench.gather_batch") / ctx.trace_units * 1e3
