"""The port's kernels' share of their roofline in an evaluation, as
`kernels_roofline.train`: the least time of each of their calls in the
traced passes (kernels/*.py; here #1's forward and #3's at the eval batch,
and #4 over the split), summed, over the device time of every launch the
kernel tables name, in %."""


def read(ctx):
    least, spent = ctx.kernel_least_s, ctx.port_kernel_s
    if not spent or not least or least != least:
        return None
    return least / spent * 100.0
