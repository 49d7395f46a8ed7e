"""brief_dots_roofline: the brief_dots kernel's bound over its device time in the traced window."""

from portbench.core.readers import roofline


def read(record: dict) -> float | None:
    return roofline(record, ["brief_dots"])
