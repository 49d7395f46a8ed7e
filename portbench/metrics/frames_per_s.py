"""frames_per_s: every frame whose pose reached the host in the window, over the whole window."""

from portbench.core.stats import rate


def read(record: dict) -> float:
    return rate(record["frames"], record["window_s"])
