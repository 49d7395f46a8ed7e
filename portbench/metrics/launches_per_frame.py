"""launches_per_frame: device kernels, copies and sets in the traced window, over its frames."""


def read(record: dict) -> float | None:
    if "trace" not in record:
        return None
    return record["trace"]["launches"] / (record["traced_steps"] * record["frames_per_step"])
