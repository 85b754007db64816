"""The device's idle share of an evaluation at the untraced pace, in %: one
less the device's busy seconds a pass (kernels, copies and sets, from the
traced passes) over the host clock's seconds a pass in the untraced
window."""


def read(ctx):
    t, h = ctx.trace, ctx.host
    if t is None or not t.busy_s or not ctx.trace_units or not h.get("units"):
        return None
    return (1.0 - (t.busy_s / ctx.trace_units) / (h["window_s"] / h["units"])) * 100.0
