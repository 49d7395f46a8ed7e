"""Helpers the metric readers share: device seconds of a kernel in the trace, and its bound."""

from __future__ import annotations

import statistics

from portbench.core.bounds import KERNELS
from portbench.core.trace import base_name


def kernel_seconds(record: dict, kernel: str) -> tuple[int, float]:
    """(calls, device seconds) of one of ``KERNELS`` in the traced window; a call is a launch of the
    kernel's last function."""
    names = KERNELS[kernel]
    calls, seconds = 0, 0.0
    for op, v in record["trace"]["ops"].items():
        base = base_name(op)
        if base in names:
            seconds += v["seconds"]
            if base == names[-1]:
                calls += v["count"]
    return calls, seconds


def roofline(record: dict, kernels: list[str]) -> float | None:
    """Σ bound / Σ device time (%) of ``kernels`` over the traced steps; None where none of them ran,
    or where one ran another number of calls than the cell's shapes give (the yardstick then does not
    know the path)."""
    if "trace" not in record:
        return None
    bound = time = 0.0
    for k in kernels:
        calls, seconds = kernel_seconds(record, k)
        per_step = record["kernels"].get(k, [])
        if calls == 0:
            continue
        if calls != len(per_step) * record["traced_steps"]:
            return None
        bound += record["traced_steps"] * sum(w.bound_s() for w in per_step)
        time += seconds
    return 100.0 * bound / time if time > 0 else None


def mean(values: list[float]) -> float | None:
    return statistics.fmean(values) if values else None
