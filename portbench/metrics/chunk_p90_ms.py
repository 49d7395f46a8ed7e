"""chunk_p90_ms: the 90th percentile over every step of the window, from the call to its poses on the host."""

from portbench.core.stats import percentile


def read(record: dict) -> float:
    return percentile(record["chunk_ms"], 90)
