"""The port's own kernels' device time (the launches the kernel tables
name) over all kernel time in the traced window, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernel_s:
        return None
    return ctx.port_kernel_s / t.kernel_s * 100.0
