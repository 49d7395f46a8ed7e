"""step_rest_host_ms: host ms a traced step inside the port's ``vo.step`` span and outside its
``vo.detect``, ``vo.match``, ``vo.draws``, ``vo.pose`` and ``vo.chain`` spans: the upload, the
undistortion, the triangulation and the glue between the stages.

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or a span.
"""

from portbench.core.spans import rest_ms


def read(record: dict) -> float | None:
    return rest_ms(("vo.detect", "vo.match", "vo.draws", "vo.pose", "vo.chain"))
