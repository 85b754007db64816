"""Host-blocking calls a traced step that start inside the port's span
"step" (train/step.py), on any host thread: synchronizes of a stream, the
device or an event, and synchronous copies (portbench/spans.py::SYNC_CALLS).
The Trainer's loss read between steps lies outside the span."""

from portbench.spans import host_syncs


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels or not ctx.trace_units:
        return None
    n = host_syncs(t, "step")
    return None if n is None else n / ctx.trace_units
