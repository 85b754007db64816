"""Profiling hooks, ported from mgsv_tpu/core/profiling.py.

`StepProfiler` wraps a window of training steps in `torch.profiler` (host
and, on a GPU, device activity) and writes a Chrome trace into
run_dir/profile.
"""

from __future__ import annotations

import os

import torch


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

