"""kernels_roofline: Σ bound over Σ device time of the port's own kernels in the traced window."""

from portbench.core.bounds import KERNELS
from portbench.core.readers import roofline


def read(record: dict) -> float | None:
    return roofline(record, list(KERNELS))
