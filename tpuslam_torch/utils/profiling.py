"""Tracing and timing utilities (port of ``tpuslam/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
kernels when a card is present) and writes it as Chrome trace JSON, which
``chrome://tracing`` or Perfetto opens.  ``time_fn`` times a function in
steady state, ending its warm-up and its timed loop in
``torch.cuda.synchronize()`` whenever the process has used a card, so it
never times dispatch alone, whatever ``fn`` returns.
``StageTimer`` accumulates named host-side stage times.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Record a ``torch.profiler`` trace of the block into ``log_dir/trace.json`` (Chrome trace JSON)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> dict:
    """Steady-state timing of ``fn(*args)``: total seconds and ms a call over ``iters`` calls."""
    for _ in range(warmup):
        fn(*args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"total_s": dt, "per_call_ms": dt / iters * 1e3, "iters": iters}


class StageTimer:
    """Accumulates named host-side stage timings (the FPS harness)."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict[str, dict]:
        return {
            k: {
                "total_s": self.totals[k],
                "mean_ms": self.totals[k] / max(self.counts[k], 1) * 1e3,
                "count": self.counts[k],
            }
            for k in self.totals
        }
