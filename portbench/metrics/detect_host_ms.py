"""detect_host_ms: host ms a traced step inside the port's ``vo.detect`` span, detection on every level:
kernel 1 and NMS/top-k or kernel 5 and top-k, then orientation, kernels 2-3 and the bits.

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or the span.
"""

from portbench.core.spans import span_ms


def read(record: dict) -> float | None:
    return span_ms("vo.detect")
