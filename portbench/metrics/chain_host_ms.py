"""chain_host_ms: host ms a traced step inside the port's ``vo.chain`` span, the scale and the chaining
(_scale_and_chain) with the per-sequence split.

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or the span.
"""

from portbench.core.spans import span_ms


def read(record: dict) -> float | None:
    return span_ms("vo.chain")
