"""kernel_device_pct: the port's own kernels' share of all device time in the traced window."""

from portbench.core.bounds import KERNELS
from portbench.core.readers import kernel_seconds


def read(record: dict) -> float | None:
    if "trace" not in record:
        return None
    own = sum(kernel_seconds(record, k)[1] for k in KERNELS)
    return 100.0 * own / record["trace"]["device_s"] if own > 0 else None
