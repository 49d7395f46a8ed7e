"""draws_host_ms: host ms a traced step inside the port's ``vo.draws`` span, the draws: a generator
reseeded and draw_ranks for every frame of the step.

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or the span.
"""

from portbench.core.spans import span_ms


def read(record: dict) -> float | None:
    return span_ms("vo.draws")
