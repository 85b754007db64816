"""Host milliseconds of the port's span "input.gather"
(data/device_data.py::gather_batch): the mean over the untraced window,
from the program's ring (portbench/spans.py::host_ms)."""

from portbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "input.gather")
