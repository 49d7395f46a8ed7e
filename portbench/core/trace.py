"""Device trace of a few steps: ``torch.profiler`` (CUPTI) reduced to the numbers the readers need.

``DeviceTrace`` records host and device activity between ``start`` and
``stop``; the harness marks the traced steps with a ``record_function``
span named ``WINDOW``.  ``reduce`` takes the device's kernels, copies and
sets inside that span and gives: the span's length, the union of device
activity (busy seconds), the launches, the device seconds by operation
name, and the idle gaps, each named by the innermost host operation open
at its middle ("host (no operation)" where none was: the interpreter between operations).
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np
import torch

from portbench.core.stats import covered, gaps

WINDOW = "portbench.window"


def base_name(name: str) -> str:
    """The bare function name of a device kernel: 'void (anonymous namespace)::f<T>(args)' → 'f'."""
    head = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", "")).split("(")[0].split("<")[0]
    return head.split("::")[-1].strip()


class DeviceTrace:
    """``torch.profiler`` with CPU and CUDA activity, started and stopped around the traced steps."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> list:
        self._prof.stop()
        return list(self._prof.profiler.kineto_results.events())


def reduce(events: list, top: int = 10) -> dict:
    """The traced window's numbers from the profiler's events (see the module docstring)."""
    cuda = torch.autograd.DeviceType.CUDA
    host, device = [], []
    window = None
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith("portbench."):
                device.append((s, end, name))
        else:
            if name == WINDOW:
                window = (s, end)
            host.append((s, end, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = window
    inside = [(s, e, n) for s, e, n in device if s < hi and e > lo]
    if not inside:
        raise RuntimeError("no device operation ran inside the traced window")
    spans = [(max(s, lo), min(e, hi)) for s, e, _ in inside]
    by_op: dict[str, list[float]] = defaultdict(lambda: [0, 0.0])
    for (s, e), (_, _, n) in zip(spans, inside):
        by_op[n][0] += 1
        by_op[n][1] += (e - s) * 1e-9
    idle = _name_gaps(gaps(spans, lo, hi), [h for h in host if h[0] < hi and h[1] > lo and h[2] != WINDOW])
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": covered(spans, lo, hi) * 1e-9,
        "launches": len(inside),
        "device_s": sum(v[1] for v in by_op.values()),
        "ops": {n: {"count": c, "seconds": t} for n, (c, t) in by_op.items()},
        "idle": idle,
        "top_ops": [[n[:160], t] for n, (c, t) in sorted(by_op.items(), key=lambda kv: -kv[1][1])[:top]],
        "top_idle": sorted(([n, t] for n, t in idle.items()), key=lambda x: -x[1])[:top],
    }


def _name_gaps(idle: list[tuple[int, int]], host: list[tuple[int, int, str]]) -> dict[str, float]:
    """Seconds of idle device time by the innermost host operation open at each gap's middle."""
    if not idle:
        return {}
    mids = np.array([(s + e) // 2 for s, e in idle], dtype=np.int64)
    order = np.argsort(mids)
    mids = mids[order]
    owner = np.full(len(mids), -1, dtype=np.int64)
    width = np.full(len(mids), np.iinfo(np.int64).max, dtype=np.int64)
    starts = np.array([h[0] for h in host], dtype=np.int64)
    ends = np.array([h[1] for h in host], dtype=np.int64)
    first = np.searchsorted(mids, starts, side="left")
    last = np.searchsorted(mids, ends, side="left")
    for i in np.nonzero(last > first)[0]:
        w = ends[i] - starts[i]
        sl = slice(first[i], last[i])
        narrower = width[sl] > w
        owner[sl] = np.where(narrower, i, owner[sl])
        width[sl] = np.where(narrower, w, width[sl])
    out: dict[str, float] = defaultdict(float)
    for j, g in enumerate(order):
        s, e = idle[g]
        out[host[owner[j]][2] if owner[j] >= 0 else "host (no operation)"] += (e - s) * 1e-9
    return dict(out)
