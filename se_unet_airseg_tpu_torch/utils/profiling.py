"""Tracing/profiling utilities.

The reference's only observability is wall-clock prints persisted to
`_time.txt` reports (reference tree_parsing.py:53-76,
preprocessing.py:151-155). `time_report` keeps that contract; `Timer`
adds named phase timers and `device_trace` a trace of the host and the
card through `torch.profiler` (a Chrome trace, viewable in
chrome://tracing or Perfetto).

Counterpart of the JAX package's `utils/profiling.py`: `Timer` and
`time_report` are copies; `device_trace` traces with `torch.profiler`
where the JAX package uses `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import os
import time


class Timer:
    """Named phase timer: `with Timer() as t: ... t.lap("phase")`."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t0 = now
        return dt


def time_report(path: str, lines: dict[str, float | int]):
    """Write a reference-style `_time.txt` report: one
    '<label> %d seconds' (or raw int) line per entry."""
    with open(path, "w") as f:
        for label, value in lines.items():
            if "time" in label.lower():
                f.write("%s %d seconds\n" % (label, value))
            else:
                f.write("%s %d\n" % (label, value))


@contextlib.contextmanager
def device_trace(log_dir: str = "./trace"):
    """torch.profiler over the block, CPU and (where there is a card)
    CUDA activities; on exit the Chrome trace is written to
    `<log_dir>/trace.json`. Yields the profiler (`key_averages()` gives
    the sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
