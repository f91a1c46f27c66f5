"""A one-shot profiler window over a loop's steps (counterpart of
``StepTimer`` in cris_tpu/utils/profiling.py:35-60, on ``torch.profiler``),
and the card's busy time in a profile.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

TRACE_NAME = "trace.json"


def busy_time(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


def device_events(prof) -> list:
    """The card's events of a finished ``torch.profiler`` profile: its
    kernels, copies and sets (the CPU ops that launched them carry the
    same time again; the profiler's own buffer requests are not work)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("Activity Buffer")]


class StepTimer:
    """Traces steps [start, stop) of a loop with ``torch.profiler`` (the
    CPU, and the card when there is one) and writes the Chrome trace to
    ``log_dir/trace.json``; does nothing when ``log_dir`` is None.

    Once the window has closed, ``window`` holds its steps, its wall time
    (host clock, from its first step to the card's last work in it), and
    on the card the union of the card's work in it and that union's
    share of the wall time (None on the CPU)."""

    def __init__(self, log_dir: Optional[str], start: int = 10, stop: int = 15):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self.window: Optional[dict] = None
        self._prof = None
        self._t0 = 0.0
        self._last = -1  # the last step begun
        self._done = not log_dir

    def step(self, i: int):
        """Call before step ``i`` of the loop."""
        if self._done:
            return
        if i >= self.stop and self._prof is not None:
            self.close()
            return
        self._last = i
        if i == self.start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
            self._t0 = time.perf_counter()

    def close(self):
        """End the window (if one is open), measure it and write its
        trace."""
        if self._prof is None:
            return
        on_card = torch.cuda.is_available()
        if on_card:
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self._t0) * 1e6
        self._prof.stop()
        busy_us = None
        if on_card:
            busy_us = busy_time((e.time_range.start, e.time_range.end)
                                for e in device_events(self._prof))
        self.window = {
            "steps": self._last + 1 - self.start, "wall_ms": wall_us / 1e3,
            "device_busy_ms": None if busy_us is None else busy_us / 1e3,
            "device_busy_share": None if busy_us is None else busy_us / wall_us}
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(os.path.join(self.log_dir, TRACE_NAME))
        self._prof = None
        self._done = True
