"""tpuslam_torch.kernels — wrappers of the hand-written CUDA kernels.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors, and counts its launches in an integer attribute
``launches``; :func:`launch_counts` reads all six counts and
:func:`reset_launch_counts` zeroes them.  Launches made in the worker
processes of ``dist/workers.py`` reach the parent with each call's answer
(:func:`add_launch_counts`), so :func:`launch_counts` counts them too.
"""

from __future__ import annotations

_WORKER_LAUNCHES: dict[str, int] = {}  # launches reported by worker processes since the last reset


def _wrappers():
    from tpuslam_torch.kernels.brief import brief_own_bin_dots, extract_brief_patches
    from tpuslam_torch.kernels.frontend import fused_frontend_batch, fused_frontend_nms_batch
    from tpuslam_torch.kernels.jacobi import jacobi_nullvec
    from tpuslam_torch.kernels.pose import msac_scores

    return {
        "fused_frontend_batch": fused_frontend_batch,
        "fused_frontend_nms_batch": fused_frontend_nms_batch,
        "extract_brief_patches": extract_brief_patches,
        "brief_own_bin_dots": brief_own_bin_dots,
        "msac_scores": msac_scores,
        "jacobi_nullvec": jacobi_nullvec,
    }


def launch_counts() -> dict[str, int]:
    """Each wrapper's launches in this process plus those its worker processes reported."""
    return {name: fn.launches + _WORKER_LAUNCHES.get(name, 0) for name, fn in _wrappers().items()}


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add launches a worker process made (``dist/workers.py``) to this process's counts."""
    for name, n in counts.items():
        _WORKER_LAUNCHES[name] = _WORKER_LAUNCHES.get(name, 0) + int(n)


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _WORKER_LAUNCHES.clear()
