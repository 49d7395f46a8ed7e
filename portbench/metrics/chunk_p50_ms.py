"""chunk_p50_ms: the median step, from the same samples as the tail (the untraced steps of a traced run)."""

import statistics


def read(record: dict) -> float | None:
    return statistics.median(record["chunk_ms"]) if record["chunk_ms"] else None
