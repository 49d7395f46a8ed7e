"""Kernel 1 and kernel 5 wrappers (``csrc/frontend.cu``, ``csrc/nms.cu``).

Kernel 1, fused blur + FAST + score, replaces
``tpuslam/kernels/frontend_pallas.py::fused_frontend_batch``.  Kernel 5,
fused blur + FAST + windowed NMS, replaces ``fused_frontend_nms_batch`` of
the same file.  On a CUDA tensor each wrapper launches its kernel (or
raises); on a CPU tensor it runs its plain twin.  Both kernels apply the
reference package's border rules themselves (the blur's 2-px border is
copied from the source, corners are masked to the 3-px interior), so a
wrapper only checks, allocates and launches.  The kernels take a FAST
threshold in [0, 255] and ``contiguous`` in [1, 16] (the twins take any).
"""

from __future__ import annotations

import torch

from tpuslam_torch.frontend.brief import gaussian_blur_u8
from tpuslam_torch.frontend.fast import (
    BORDER,
    _packed_key,
    fast_response_and_mask,
    idx_shift,
    local_max_nms,
)
from tpuslam_torch.kernels.bounds import PEAK_F32_OPS, Work
from tpuslam_torch.kernels.build import library

# Image halo kernel 5 may need beyond its output tile: (window − 1) for the
# NMS window plus 3 for FAST — the reference kernel's bound (window ≤ 14).
NMS_HALO = 16


def fused_frontend_reference(
    images: torch.Tensor, *, threshold: int, contiguous: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 1: ``(blur u8, corner bool, score i32)``, each (B, H, W)."""
    corner, score = fast_response_and_mask(images, threshold, contiguous)
    return gaussian_blur_u8(images, taps), corner, score


def frontend_work(b: int, h: int, w: int) -> Work:
    """Kernel 1's bytes (1 in, 1 + 1 + 4 out a pixel) and blur float32 operations (25 mul + 25 add).

    FAST's integer compares have no published peak to count against.
    """
    return Work(bytes=7 * b * h * w, ops=50 * b * h * w, peak=PEAK_F32_OPS)


def frontend_nms_work(b: int, h: int, w: int) -> Work:
    """Kernel 5's bytes (1 in, 1 + 8 out a pixel) and blur float32 operations."""
    return Work(bytes=10 * b * h * w, ops=50 * b * h * w, peak=PEAK_F32_OPS)


def _check(images: torch.Tensor, taps: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise ValueError(f"images must be (B, H, W) uint8, got {images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    if taps.shape != (5, 5) or taps.dtype != torch.float32:
        raise ValueError(f"taps must be (5, 5) float32, got {taps.dtype} {tuple(taps.shape)}")


def _check_cuda(images: torch.Tensor, threshold: int, contiguous: int) -> None:
    """The kernels' own limits: a u8 SWAR threshold and a 16-pixel ring."""
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    if not (0 <= threshold <= 255 and 1 <= contiguous <= 16):
        raise ValueError(f"threshold must be in [0, 255] and contiguous in [1, 16], "
                         f"got {threshold}, {contiguous}")


def fused_frontend_batch(
    images: torch.Tensor, *, threshold: int, contiguous: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blur + FAST on (B, H, W) uint8 → ``(blur u8, corner bool, score i32)``."""
    _check(images, taps)
    if images.device.type == "cpu":
        return fused_frontend_reference(
            images, threshold=threshold, contiguous=contiguous, taps=taps
        )
    _check_cuda(images, threshold, contiguous)
    b, h, w = images.shape
    blur = torch.empty_like(images)
    corner = torch.empty(images.shape, dtype=torch.bool, device=images.device)
    score = torch.empty(images.shape, dtype=torch.int32, device=images.device)
    taps_host = taps.detach().to("cpu").contiguous()  # read by the host before launch
    with torch.cuda.device(images.device):
        library().call(
            "tpuslam_frontend",
            images.data_ptr(), blur.data_ptr(), corner.data_ptr(), score.data_ptr(),
            b, h, w, int(threshold), int(contiguous), taps_host.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    fused_frontend_batch.launches += 1
    return blur, corner, score


fused_frontend_batch.launches = 0


def fused_frontend_nms_reference(
    images: torch.Tensor, *, threshold: int, contiguous: int, window: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 5: ``(blur u8, post-NMS packed key int64)``, each (B, H, W)."""
    corner, score = fast_response_and_mask(images, threshold, contiguous)
    key = _packed_key(score, local_max_nms(corner, score, window))
    return gaussian_blur_u8(images, taps), key


def fused_frontend_nms_batch(
    images: torch.Tensor, *, threshold: int, contiguous: int, window: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blur + FAST + (2·window−1)² NMS on (B, H, W) uint8 → ``(blur u8, key int64)``.

    ``key`` is the post-NMS packed key, zero where there is no survivor;
    feed it to ``frontend.fast.select_from_key``.  The kernel writes the
    int64 plane directly (8 bytes a pixel): a uint32 plane widened by the
    wrapper would move 4 + 4 + 8 bytes a pixel instead.
    """
    _check(images, taps)
    if not 1 <= window <= NMS_HALO - BORDER + 1:
        raise ValueError(f"window must be in [1, {NMS_HALO - BORDER + 1}], got {window}")
    if images.device.type == "cpu":
        return fused_frontend_nms_reference(
            images, threshold=threshold, contiguous=contiguous, window=window, taps=taps
        )
    _check_cuda(images, threshold, contiguous)
    b, h, w = images.shape
    blur = torch.empty_like(images)
    key = torch.empty(images.shape, dtype=torch.int64, device=images.device)
    taps_host = taps.detach().to("cpu").contiguous()  # read by the host before launch
    with torch.cuda.device(images.device):
        library().call(
            "tpuslam_frontend_nms",
            images.data_ptr(), blur.data_ptr(), key.data_ptr(),
            b, h, w, int(threshold), int(contiguous), int(window), idx_shift(h * w),
            taps_host.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    fused_frontend_nms_batch.launches += 1
    return blur, key


fused_frontend_nms_batch.launches = 0
