"""The port's kernels' share of their roofline: the least time of each of
their calls in the traced window (kernels/*.py: operations at the peak of
the call's precision or bytes at the HBM rate, whichever is larger), summed,
over the device time of every launch the kernel tables name, in %."""


def read(ctx):
    least, spent = ctx.kernel_least_s, ctx.port_kernel_s
    if not spent or not least or least != least:
        return None
    return least / spent * 100.0
