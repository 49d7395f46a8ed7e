"""host_syncs_per_step: synchronising CUDA calls a traced step makes inside the port's ``vo.step``
span (the port's ``vo.host_syncs`` counter: ``torch.cuda.set_sync_debug_mode("warn")`` while the
step runs on the card).

Read from the port's span recorder (``tpuslam_torch.utils.profiling.RECORDER``, through
``portbench/core/spans.py``): the mean over the traced steps; None without the recorder or the
counter (the CPU does not count them).
"""

from portbench.core.spans import counter_mean


def read(record: dict) -> float | None:
    return counter_mean("vo.host_syncs")
