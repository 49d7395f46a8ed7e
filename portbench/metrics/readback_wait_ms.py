"""readback_wait_ms: from the step's return to its poses on the host, mean over the untraced steps:
the card's work the host waits for."""

from portbench.core.readers import mean


def read(record: dict) -> float | None:
    return mean(record["readback_ms"])
