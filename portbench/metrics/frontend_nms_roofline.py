"""frontend_nms_roofline: the frontend_nms kernel's bound over its device time in the traced window."""

from portbench.core.readers import roofline


def read(record: dict) -> float | None:
    return roofline(record, ["frontend_nms"])
