"""The least time an H100 could take for one kernel call: its bound.

Each wrapper module has a small ``*_work`` function beside its kernel that
counts, from the call's shapes (and, where the work depends on the data,
from its inputs), the bytes the function must move — each input read
once, each output written once — and the operations it must do.  The
bound is the larger of bytes over the memory rate and operations over the
peak rate for their type.  Rates: NVIDIA's data sheet for the H100 SXM,
dense, at its 700 W limit.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # int8 tensor cores


class Work(NamedTuple):
    bytes: int
    ops: int
    peak: float  # operations per second for this kind of operation

    def bound_us(self) -> float:
        return 1e6 * max(self.bytes / HBM_BYTES_PER_S, self.ops / self.peak)

    def bound_by(self) -> str:
        return "bytes" if self.bytes / HBM_BYTES_PER_S >= self.ops / self.peak else "operations"
