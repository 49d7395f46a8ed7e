"""Tracing and timing utilities (port of ``tpuslam/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
kernels when a card is present) and writes it as Chrome trace JSON, which
``chrome://tracing`` or Perfetto opens.  ``time_fn`` times a function in
steady state, ending its warm-up and its timed loop in
``torch.cuda.synchronize()`` whenever the process has used a card, so it
never times dispatch alone, whatever ``fn`` returns.
``StageTimer`` accumulates named host-side stage times.  ``synced_call``
and ``synced_ms`` time calls with the card synchronised on either side (a
stage's time in place), and ``device_profile`` counts a call's device
kernels and its device-busy share through ``torch.profiler``.
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


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 10) -> dict:
    """Steady-state timing of ``fn(*args)``: total seconds and ms a call over ``iters`` calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    dt = time.perf_counter() - t0
    return {"total_s": dt, "per_call_ms": dt / iters * 1e3, "iters": iters}


def synced_call(fn: Callable):
    """``(fn(), host milliseconds)`` with the card synchronised before and after the call."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, 1e3 * (time.perf_counter() - t0)


def synced_ms(fn: Callable, reps: int = 5, warmup: int = 1) -> float:
    """Median host milliseconds of ``fn()`` over ``reps`` synchronised calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = sorted(synced_call(fn)[1] for _ in range(reps))
    return times[len(times) // 2]


def device_profile(fn: Callable) -> dict:
    """``torch.profiler`` over one synchronised call of ``fn()``.

    Returns the device kernels it ran, their summed device time, the
    call's host wall time (profiler on) and the busy share, device time
    over wall; the profiler's host overhead lengthens the wall, so the
    share is a lower bound of the unprofiled one.  Without a card the
    device fields are None (not measured).
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    _sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if not on_card:
        return {"device_kernels": None, "device_ms": None, "wall_ms": wall_ms, "busy_share": None}
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3
    return {"device_kernels": sum(e.count for e in kernels), "device_ms": device_ms, "wall_ms": wall_ms,
            "busy_share": device_ms / wall_ms}


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
