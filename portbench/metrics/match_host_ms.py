"""match_host_ms: host ms a traced step inside the port's ``vo.match`` span, matching: the pairs with
the carried frame, match_descriptors and the point gathers.

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or the span.
"""

from portbench.core.spans import span_ms


def read(record: dict) -> float | None:
    return span_ms("vo.match")
