"""step_dispatch_ms: the benchmark's span from the step's call to its return, mean over the untraced steps."""

from portbench.core.readers import mean


def read(record: dict) -> float | None:
    return mean(record["dispatch_ms"])
