"""The device trace of a traced sub-window, and what the per-layer metrics
read from it.

`traced()` runs a block under `torch.profiler` (CPU and CUDA activity),
writes the Chrome trace into the run's temporary directory, reads it back
and deletes it.  From it come: the device's busy seconds (the union of
kernel, copy and set intervals), the kernels by name, the device time of
the kernels launched inside a named host range (`record_function`), and the
longest idle gaps of the device, each named by the host operation that
launched the kernel that ended it.

`DeviceClock` is the light clock of a whole window: the profiler with
the device's activity alone, read from its events in memory (no trace
written), giving the device's busy seconds of the block.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def union(intervals) -> List[List[float]]:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_seconds(events, on_device: bool) -> float:
    """The busy seconds of the profiler's events (`_KinetoEvent`s): the union
    of the intervals of the device's activity (kernels, copies, sets; its
    user annotations left out), or on the CPU of its operators.  A profiler
    of the device's activity alone records no host operators, and the
    runtime's launch calls are host events."""
    kind = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU
    spans = [(e.start_ns(), e.end_ns()) for e in events
             if e.device_type() == kind and not e.is_user_annotation()]
    return sum(b - a for a, b in union(spans)) * 1e-9


class DeviceClock:
    """`busy_s`: the device's busy seconds over every block run under it."""

    def __init__(self, device: torch.device):
        self.device, self.busy_s = device, 0.0

    @contextlib.contextmanager
    def __call__(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.start()
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize(self.device)
            prof.stop()
            self.busy_s += busy_seconds(prof.profiler.kineto_results.events(), cuda)


class Summary:
    """What one traced window holds; times in seconds."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.kernels = [e for e in dev if e["cat"] == "kernel"]
        self.kernel_s = sum(e["dur"] for e in self.kernels) * 1e-6
        merged = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        launches = [e for e in events if e.get("cat") in LAUNCH_CATS]
        self._launch_of = {e.get("args", {}).get("correlation"): e for e in launches}
        self._host = defaultdict(list)
        for e in events:
            if e.get("cat") in HOST_CATS and "dur" in e:
                self._host[e["tid"]].append(e)
        for ops in self._host.values():
            ops.sort(key=lambda e: e["ts"])
        self._starts = {tid: [e["ts"] for e in ops] for tid, ops in self._host.items()}
        self._gaps = self._name_gaps(merged, dev)

    def _host_op(self, launch: dict) -> str:
        """The innermost host operation around a launch."""
        tid, ts = launch["tid"], launch["ts"]
        ops, starts = self._host.get(tid, []), self._starts.get(tid, [])
        best = None
        for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            e = ops[i]
            if e["ts"] + e["dur"] >= ts:
                best = e
                break
            if ts - e["ts"] > 5e6:
                break
        return best["name"] if best else launch.get("name", "?")

    def _name_gaps(self, merged, dev) -> List[Tuple[str, float]]:
        """Each idle gap named by the host operation that launched the work
        ending it, summed by name, longest first."""
        first_at = {}
        for e in sorted(dev, key=lambda e: e["ts"]):
            first_at.setdefault(e["ts"], e)
        total: Dict[str, float] = defaultdict(float)
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            e = first_at[nxt]
            launch = self._launch_of.get(e.get("args", {}).get("correlation"))
            total[self._host_op(launch) if launch else e["name"]] += (nxt - end) * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])

    def top_kernels(self, n: int = 10) -> List[Tuple[str, float]]:
        total: Dict[str, float] = defaultdict(float)
        for e in self.kernels:
            total[e["name"]] += e["dur"] * 1e-6
        return sorted(total.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        return self._gaps[:n]

    def kernel_s_matching(self, match) -> float:
        return sum(e["dur"] for e in self.kernels if match(e["name"])) * 1e-6

    def range_device_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside the host ranges
        called `name`."""
        ranges = defaultdict(list)
        for tid, ops in self._host.items():
            ranges[tid] = [(e["ts"], e["ts"] + e["dur"]) for e in ops
                           if e["cat"] == "user_annotation" and e["name"] == name]
        total = 0.0
        for e in self.kernels:
            launch = self._launch_of.get(e.get("args", {}).get("correlation"))
            if launch and any(a <= launch["ts"] <= b for a, b in ranges.get(launch["tid"], ())):
                total += e["dur"]
        return total * 1e-6


@contextlib.contextmanager
def traced(out: Dict[str, Optional[Summary]]):
    """Profile the block; `out["summary"]` holds its Summary afterwards."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    prof = profile(activities=acts)
    sync()
    prof.start()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        window = time.perf_counter() - t0
        prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        out["summary"] = Summary(events, window)
