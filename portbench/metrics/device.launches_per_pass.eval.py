"""Device kernels in the traced window over the evaluations in it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.trace_units:
        return None
    return len(t.kernels) / ctx.trace_units
