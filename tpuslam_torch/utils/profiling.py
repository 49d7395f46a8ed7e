"""Tracing and timing utilities (port of ``tpuslam/utils/profiling.py``).

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
kernels when a card is present) and writes it as Chrome trace JSON, which
``chrome://tracing`` or Perfetto opens.  ``time_fn`` times a function in
steady state, ending its warm-up and its timed loop in
``torch.cuda.synchronize()`` whenever the process has used a card, so it
never times dispatch alone, whatever ``fn`` returns.  ``synced_call``
times one call with the card synchronised on either side (a stage's time
in place).

``StageTimer`` accumulates named host-side stage times, and is the
program's span recorder: ``span(name)`` and ``step(name, ...)`` mark where
the work happens, ``count(name, n)`` counts at those places.  The recorder
is on only while a ``torch.profiler`` session records (``device_trace``, or
any ``torch.profiler.profile``): off, a span is one read of the profiler's
flag and nothing else.  On, each span is also a ``record_function`` range
of the same name, so it lands on the profiler's timeline beside the
device's rows, and its start and end are kept in memory on the profiler's
host clock (``time.time_ns``).  The in-memory log holds the spans of the
last ``MAX_STEPS`` (64) steps, each a tree keyed by its step id, and each step's
counters.  A step may also count the synchronising CUDA calls made inside
it (``torch.cuda.set_sync_debug_mode("warn")``), each booked to the
innermost open span.

``RECORDER`` is the process's one recorder, which the pipeline's step
writes into and the benchmark's span readers read; ``span``, ``step`` and
``count`` are its methods.  It is meant for one thread.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from pathlib import Path
from typing import Callable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC_WARNING = "called a synchronizing CUDA operation"  # the text of torch's sync debug warning
MAX_STEPS = 64  # steps the in-memory log keeps


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


class SpanRecord:
    """One span of a step: its name, the index of its parent in the step's spans (None for the root),
    start and end on the profiler's host clock (ns), and the counts booked to it while innermost."""

    __slots__ = ("counts", "end_ns", "name", "parent", "start_ns")

    def __init__(self, name: str, parent: int | None, start_ns: int):
        self.name = name
        self.parent = parent
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.counts: dict[str, int] = {}

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class StepRecord:
    """One step: its id, the root span's name and metadata, its spans (the root first) and counters."""

    __slots__ = ("counters", "meta", "name", "spans", "step_id")

    def __init__(self, step_id: int, name: str, meta: dict):
        self.step_id = step_id
        self.name = name
        self.meta = meta
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}

    def total_ns(self, name: str) -> int | None:
        """Summed duration of the step's spans named ``name`` (None where it has none)."""
        found = [s.ns for s in self.spans if s.name == name]
        return sum(found) if found else None


class _Off:
    """The context of a span while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    """A ``record_function`` range, and the in-memory span when a step is open."""

    __slots__ = ("_index", "_name", "_range", "_rec")

    def __init__(self, rec: StageTimer, name: str):
        self._rec = rec
        self._name = name

    def __enter__(self) -> None:
        self._index = self._rec._open_span(self._name)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self._rec._close_span(self._index)
        return False


class _SyncCounter:
    """Books each synchronising CUDA call to ``name``: sync debug mode "warn", its warnings caught
    (every one: the filter at "always" for them), the mode and the warning hooks restored on stop."""

    def __init__(self, rec: StageTimer, name: str):
        self._rec = rec
        self._name = name

    def _book(self, message, category, filename, lineno, file=None, line=None) -> None:
        if SYNC_WARNING in str(message):
            self._rec.count(self._name)
        else:
            self._show(message, category, filename, lineno, file, line)

    def start(self) -> None:
        self._mode = torch.cuda.get_sync_debug_mode()  # first: raises where torch has no CUDA, before any hook
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._book
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        try:
            torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self._warnings.__exit__(None, None, None)


class _Step:
    """The root span of a step: a new ``StepRecord`` in the log, open until the step ends."""

    __slots__ = ("_counter", "_meta", "_name", "_rec", "_root", "_syncs")

    def __init__(self, rec: StageTimer, name: str, sync_counter: str | None, meta: dict):
        self._rec = rec
        self._name = name
        self._meta = meta
        self._counter = sync_counter

    def __enter__(self) -> None:
        rec = self._rec
        record = StepRecord(rec._next_step_id, self._name, self._meta)
        self._syncs = None
        if self._counter is not None:
            self._syncs = _SyncCounter(rec, self._counter)
            self._syncs.start()  # before the step opens: where it raises, nothing is left open
            record.counters[self._counter] = 0
        rec._next_step_id += 1
        rec.steps.append(record)
        rec._current = record
        args = ", ".join(f"{k}={v}" for k, v in {"step": record.step_id, **self._meta}.items())
        rec._open_span(self._name)
        self._root = torch.profiler.record_function(self._name, args)
        self._root.__enter__()

    def __exit__(self, *exc) -> bool:
        rec = self._rec
        try:
            if self._syncs is not None:
                self._syncs.stop()
        finally:
            self._root.__exit__(*exc)
            rec._close_span(0)
            rec._current = None
            rec._open.clear()
        return False


class StageTimer:
    """Accumulates named host-side stage timings (the FPS harness), and records spans and counts.

    ``stage(name)`` adds to ``report()``'s totals.  ``span``, ``step`` and
    ``count`` act only while a ``torch.profiler`` session records;
    ``steps`` holds the last ``MAX_STEPS`` steps (see the module docstring).
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.steps: collections.deque[StepRecord] = collections.deque(maxlen=MAX_STEPS)
        self._current: StepRecord | None = None
        self._open: list[int] = []  # indices of the current step's open spans, innermost last
        self._next_step_id = 0

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

    def span(self, name: str):
        """A context: while recording, a ``record_function`` range named ``name`` and, inside a step, a
        span of that step; otherwise nothing."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def step(self, name: str, sync_counter: str | None = None, **meta):
        """A context: while recording, the root span of a new step (``meta`` kept with it and given to
        its range), counting under ``sync_counter`` the synchronising CUDA calls made inside it where
        named (only on a card); a plain span inside an open step; otherwise nothing."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        if self._current is not None:
            return _Span(self, name)
        return _Step(self, name, sync_counter, meta)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the open step's counter ``name`` and to its innermost open span's; nothing
        outside a step."""
        step = self._current
        if step is None:
            return
        step.counters[name] = step.counters.get(name, 0) + n
        counts = step.spans[self._open[-1]].counts  # a step's root is open while the step is
        counts[name] = counts.get(name, 0) + n

    def clear(self) -> None:
        """Forget every recorded step."""
        self.steps.clear()

    def _open_span(self, name: str) -> int:
        step = self._current
        if step is None:
            return -1
        step.spans.append(SpanRecord(name, self._open[-1] if self._open else None, time.time_ns()))
        index = len(step.spans) - 1
        self._open.append(index)
        return index

    def _close_span(self, index: int) -> None:
        if index < 0 or self._current is None:
            return
        self._current.spans[index].end_ns = time.time_ns()
        self._open.pop()  # spans close innermost first


RECORDER = StageTimer()
span = RECORDER.span
step = RECORDER.step
count = RECORDER.count
