"""Profiling hooks, ported from mgsv_tpu/core/profiling.py.

`StepProfiler` wraps a window of training steps in `torch.profiler` (host
and, on a GPU, device activity) and writes a Chrome trace into
run_dir/profile.

`span(name)` marks a phase of the program where its work happens.  It
always records (name, parent, step, t_start_ns, t_end_ns, profiled) on the
host's `time.perf_counter_ns()` clock into a ring of the last `RING`
records of its name; while a `torch.profiler` runs it also opens
`torch.profiler.record_function(name)`, so that the phase lands in the
profiler's trace as a `user_annotation`, on the clock of the device's
kernels.  `parent` is the span open around it on the same thread, and a
span takes its parent's `step` unless given one.  `span_records` and
`span_durations_ms` read the rings back; nothing is written anywhere.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

RING = 4096  # records kept per span name


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    step: Optional[int]
    t_start_ns: int
    t_end_ns: int
    profiled: bool   # a torch.profiler ran when the span opened


_rings: Dict[str, collections.deque] = {}
_open = threading.local()   # .stack: the spans open on this thread, innermost last


class span:
    """`with span(name, step=None):` records the block's host interval;
    see the module docstring."""

    __slots__ = ("name", "step", "_parent", "_profiled", "_rf", "_t0")

    def __init__(self, name: str, step: Optional[int] = None):
        self.name, self.step = name, step

    def __enter__(self) -> "span":
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self._parent = stack[-1] if stack else None
        if self.step is None and self._parent is not None:
            self.step = self._parent.step
        stack.append(self)
        self._profiled = torch.autograd._profiler_enabled()
        self._rf = None
        if self._profiled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open.stack.pop()
        ring = _rings.get(self.name)
        if ring is None:
            ring = _rings.setdefault(self.name, collections.deque(maxlen=RING))
        ring.append((self.name, None if self._parent is None else self._parent.name,
                     self.step, self._t0, t1, self._profiled))


def span_records(name: str) -> List[SpanRecord]:
    """The ring of `name`, oldest first."""
    return [SpanRecord(*r) for r in list(_rings.get(name, ()))]


def span_durations_ms(name: str, last: int) -> List[float]:
    """Host milliseconds of the last `last` records of `name` taken with no
    profiler running, oldest first (fewer where the ring holds fewer)."""
    out: List[float] = []
    for r in reversed(list(_rings.get(name, ()))):
        if len(out) == last:
            break
        if not r[5]:
            out.append((r[4] - r[3]) * 1e-6)
    return out[::-1]


def clear_spans() -> None:
    """Empty every ring."""
    _rings.clear()


class StepProfiler:
    """Trace steps [start, stop) of an epoch into run_dir/profile."""

    def __init__(self, run_dir: str, start_step: int = 5, num_steps: int = 5,
                 enabled: bool = False):
        self.log_dir = os.path.join(run_dir, "profile")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.enabled = enabled
        self._prof = None

    def step(self, step_idx: int) -> None:
        if not self.enabled:
            return
        if step_idx == self.start_step and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif step_idx == self.stop_step and self._prof is not None:
            self.close()
            self.enabled = False  # one window per run

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(self.log_dir, f"trace_steps_{self.start_step}_{self.stop_step}.json"))

