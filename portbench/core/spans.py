"""Per-step numbers of the port's own spans and counters, for the ``program_span`` and
``program_counter`` readers.

The port records while a ``torch.profiler`` session runs, which in a run
is the ``trace_steps`` steps of a ``--trace 1`` run: each
``SlamPipeline.process_chunks`` call is a ``vo.step`` span tree, with
each span's start and end on the host, and, on a card, its count of
synchronising CUDA calls under ``vo.host_syncs``.  The entry point read
here is the recorder of ``tpuslam_torch/utils/profiling.py``:
``RECORDER.steps``, the last steps it recorded (``StepRecord``:
``name``, ``spans``, ``counters``, ``total_ns(name)``).  Each number is
the mean over the ``vo.step`` steps the recorder holds, and None where
it holds none, or where the program has no such recorder (a program
older than it), no such span or no such counter.
"""

from __future__ import annotations

import statistics

STEP = "vo.step"


def _steps() -> list:
    try:
        from tpuslam_torch.utils.profiling import RECORDER
    except ImportError:
        return []
    return [s for s in getattr(RECORDER, "steps", ()) if getattr(s, "name", None) == STEP]


def span_ms(name: str) -> float | None:
    """Mean host ms of the spans ``name`` in a recorded step (their sum within the step)."""
    per_step = [s.total_ns(name) for s in _steps()]
    if not per_step or None in per_step:
        return None
    return statistics.fmean(per_step) / 1e6


def rest_ms(parts: tuple[str, ...]) -> float | None:
    """Mean host ms of a step's ``vo.step`` span less its spans ``parts``."""
    steps = _steps()
    per_step = [[s.total_ns(STEP), *(s.total_ns(p) for p in parts)] for s in steps]
    if not per_step or any(None in row for row in per_step):
        return None
    return statistics.fmean(row[0] - sum(row[1:]) for row in per_step) / 1e6


def counter_mean(name: str) -> float | None:
    """Mean of a step's counter ``name`` over the recorded steps that kept it (None where none did,
    as on a CPU, where the syncs are not counted)."""
    values = [s.counters[name] for s in _steps() if name in s.counters]
    return statistics.fmean(values) if values else None
