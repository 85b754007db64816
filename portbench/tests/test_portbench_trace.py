"""The trace reader on a hand-made Chrome trace: busy time is the union of
the device's intervals, an idle gap is named by the host operation that
launched the kernel ending it, and a named host range owns the device time
of the kernels launched inside it."""

import pytest

from portbench.trace import Summary

EVENTS = [
    {"cat": "kernel", "ts": 0, "dur": 10, "name": "k1", "args": {"correlation": 1}},
    {"cat": "kernel", "ts": 5, "dur": 10, "name": "k1", "args": {"correlation": 3}},
    {"cat": "gpu_memcpy", "ts": 60, "dur": 5, "name": "copy", "args": {"correlation": 4}},
    {"cat": "kernel", "ts": 30, "dur": 10, "name": "k2", "args": {"correlation": 2}},
    {"cat": "cuda_runtime", "ts": 25, "dur": 1, "tid": 7, "name": "cudaLaunchKernel",
     "args": {"correlation": 2}},
    {"cat": "cuda_runtime", "ts": 2, "dur": 1, "tid": 7, "name": "cudaLaunchKernel",
     "args": {"correlation": 3}},
    {"cat": "cpu_op", "ts": 20, "dur": 10, "tid": 7, "name": "aten::mm"},
    {"cat": "user_annotation", "ts": 19, "dur": 20, "tid": 7, "name": "portbench.x"},
]


def test_summary():
    s = Summary(EVENTS, 100e-6)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.kernel_s == pytest.approx(30e-6)
    assert s.idle_gaps() == [("copy", pytest.approx(20e-6)), ("aten::mm", pytest.approx(15e-6))]
    assert s.range_device_s("portbench.x") == pytest.approx(10e-6)
    assert s.top_kernels()[0] == ("k1", pytest.approx(20e-6))
    assert s.kernel_s_matching(lambda n: n == "k2") == pytest.approx(10e-6)
