"""The program's spans in a traced window: the device time and the host
syncs each owns, attributed by time.

The program opens its spans (mgsv_tpu_torch/core/profiling.py::span) as
`record_function` ranges while the profiler runs, so each is a
`user_annotation` interval of the trace on the clock of the device's
kernels and of the CUDA runtime's calls.  A kernel belongs to a span when
the call that launched it (a `cuda_runtime` or `cuda_driver` event,
joined by `correlation`) starts inside one of the span's intervals, on any
host thread: the autograd engine launches the backward's kernels from a
thread of its own while the main thread waits inside "step.backward".
(`Summary.range_device_s` matches launches on the range's own thread only.)

Each function returns None where the trace holds no interval of the span,
as on a program without it.
"""

from __future__ import annotations

import bisect
from typing import Optional

from mgsv_tpu_torch.core import profiling

# host calls that block until the device has caught up; PyTorch copies into
# pageable host memory as cudaMemcpyAsync then cudaStreamSynchronize, so
# such a copy counts once, by its synchronize
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def _within(trace, name: str):
    """A test of whether a trace time lies inside one of the intervals of
    the `user_annotation` events `name` (any thread), or None where the
    trace has none."""
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for ops in trace._host.values() for e in ops
                 if e["cat"] == "user_annotation" and e["name"] == name)
    if not ivs:
        return None
    starts = [a for a, _ in ivs]

    def inside(ts: float) -> bool:
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= ivs[i][1]

    return inside


def span_device_s(trace, name: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the span `name`."""
    inside = _within(trace, name)
    if inside is None:
        return None
    total = 0.0
    for e in trace.kernels:
        launch = trace._launch_of.get(e.get("args", {}).get("correlation"))
        if launch is not None and inside(launch["ts"]):
            total += e["dur"]
    return total * 1e-6


def host_syncs(trace, name: str = "step") -> Optional[int]:
    """Host-blocking calls (SYNC_CALLS) that start inside the span `name`,
    on any thread."""
    inside = _within(trace, name)
    if inside is None:
        return None
    return sum(1 for e in trace._launch_of.values()
               if e.get("name") in SYNC_CALLS and inside(e["ts"]))


def per_step_ms(ctx, name: str) -> Optional[float]:
    """Device milliseconds a traced step of the span `name`."""
    t = ctx.trace
    if t is None or not t.kernels or not ctx.trace_units:
        return None
    s = span_device_s(t, name)
    return None if s is None else s / ctx.trace_units * 1e3


def host_ms(ctx, name: str) -> Optional[float]:
    """The mean host milliseconds of the span `name` over the untraced
    window: its last `ctx.host["units"]` records taken with no profiler
    running, read from the program's ring."""
    n = ctx.host.get("units")
    if not n:
        return None
    read = getattr(profiling, "span_durations_ms", None)   # absent without the spans
    got = read(name, n) if read is not None else None
    return sum(got) / len(got) if got else None
