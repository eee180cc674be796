"""Profiling hooks: a ``torch.profiler`` trace and per-step wall timing.

Port of ``pmce_tpu/utils/profiler.py``:

- :func:`trace` wraps a region in a ``torch.profiler`` trace (the host's
  operators, and the card's kernels when one is in use) and writes it to
  ``logdir`` as a Chrome / Perfetto trace file;
- :class:`StepTimer` times steps with the first ``warmup`` excluded from
  the summary. On the card each stop synchronizes first, so a step's time
  is the card's and not the host's enqueue time.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the ``with`` block; on exit the trace is written to
    ``logdir/trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """``with timer:`` around each step; :meth:`summary` over the steps
    after the first ``warmup``. Once the process has used the card, each
    stop waits for it."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._times.append(time.perf_counter() - self._t0)

    @property
    def steady_times(self) -> np.ndarray:
        return np.asarray(self._times[self.warmup:])

    def summary(self) -> dict:
        t = self.steady_times
        if len(t) == 0:
            return {"steps": len(self._times)}
        return {
            "steps": len(self._times),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
        }
