"""setup_s: process start to the first timed step (imports, the kernels built or loaded, frames, bank, warm-up)."""


def read(record: dict) -> float:
    return record["setup_s"]
