"""tpuslam_torch.kernels — wrappers of the hand-written CUDA kernels.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors, and counts its launches in an integer attribute
``launches``; :func:`launch_counts` reads all four counts and
:func:`reset_launch_counts` zeroes them.
"""

from __future__ import annotations


def _wrappers():
    from tpuslam_torch.kernels.brief import brief_own_bin_dots, extract_brief_patches
    from tpuslam_torch.kernels.frontend import fused_frontend_batch
    from tpuslam_torch.kernels.pose import msac_scores

    return {
        "fused_frontend_batch": fused_frontend_batch,
        "extract_brief_patches": extract_brief_patches,
        "brief_own_bin_dots": brief_own_bin_dots,
        "msac_scores": msac_scores,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
