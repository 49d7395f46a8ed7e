"""device_idle_pct: the share of the traced window in which no operation ran on the device."""


def read(record: dict) -> float | None:
    if "trace" not in record:
        return None
    t = record["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
