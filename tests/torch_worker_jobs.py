"""Picklable helpers for tests that run code in ``tpuslam_torch.dist.workers`` processes.

A worker process unpickles what it is sent by importing the module that
defines it, so these live in a module that imports neither JAX nor a test
file.
"""

import os
import sys


class RecordedDraws:
    """A draw hook that answers from a table keyed by its integer arguments.

    Built around a live hook (``RecordedDraws(fn)``) it calls ``fn`` and
    records each answer; pickled, it carries the table alone, so a worker
    process replays what ``fn`` answered here, and a call the recording
    never saw raises ``KeyError`` there.
    """

    def __init__(self, fn=None):
        self.fn = fn
        self.table = {}

    def __call__(self, *args):
        key = tuple(int(a) for a in args)
        if self.fn is not None and key not in self.table:
            self.table[key] = self.fn(*args)
        return self.table[key]

    def __getstate__(self):
        return {"fn": None, "table": self.table}


def bump_launches(name: str, n: int) -> int:
    """Add ``n`` to kernel wrapper ``name``'s launch count in this process, as ``n`` launches would."""
    from tpuslam_torch.kernels import _wrappers

    _wrappers()[name].launches += n
    return os.getpid()


def answer(n: int) -> dict:
    """An answer of a float32 tensor of ``n`` values, an int64 one, a numpy array and a scalar."""
    import numpy as np
    import torch

    return {"x": torch.linspace(0, 1, n), "i": torch.arange(n // 2), "a": np.arange(7, dtype=np.uint8), "s": n}


def loaded() -> dict:
    """This process's pid and whether it has imported JAX or the reference package."""
    return {"pid": os.getpid(), "jax": "jax" in sys.modules,
            "tpuslam": any(m == "tpuslam" or m.startswith("tpuslam.") for m in sys.modules)}
