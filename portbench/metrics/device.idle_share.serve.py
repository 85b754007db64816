"""The device's idle share at the untraced pace, in %: one less the
device's busy seconds a unit (kernels, copies and sets, from the traced
window) over the host clock's seconds a unit in the untraced window.  (The
profiler slows the host, so the traced window's own idle share reads high;
`device.busy_s` / `device.window_s` of the result line keep that one.)"""


def read(ctx):
    t, h = ctx.trace, ctx.host
    if t is None or not t.busy_s or not ctx.trace_units or not h.get("units"):
        return None
    return (1.0 - (t.busy_s / ctx.trace_units) / (h["window_s"] / h["units"])) * 100.0
