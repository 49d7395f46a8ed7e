"""Kernel 1 wrapper: fused blur + FAST + score (``csrc/frontend.cu``).

Replaces ``tpuslam/kernels/frontend_pallas.py::fused_frontend_batch``.  On
a CUDA tensor the wrapper launches the kernel (or raises); on a CPU tensor
it runs :func:`fused_frontend_reference`, the plain twin.  The reference
package's border rules stay here, outside the kernel: the blur's 2-px
border is copied from the source and corners are masked to the 3-px
interior.
"""

from __future__ import annotations

import torch

from tpuslam_torch.frontend.brief import gaussian_blur_u8
from tpuslam_torch.frontend.fast import BORDER, fast_response_and_mask
from tpuslam_torch.kernels.build import library


def fused_frontend_reference(
    images: torch.Tensor, *, threshold: int, contiguous: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 1: ``(blur u8, corner bool, score i32)``, each (B, H, W)."""
    corner, score = fast_response_and_mask(images, threshold, contiguous)
    return gaussian_blur_u8(images, taps), corner, score


def _check(images: torch.Tensor, taps: torch.Tensor) -> None:
    if images.dtype != torch.uint8 or images.dim() != 3:
        raise ValueError(f"images must be (B, H, W) uint8, got {images.dtype} {tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    if taps.shape != (5, 5) or taps.dtype != torch.float32:
        raise ValueError(f"taps must be (5, 5) float32, got {taps.dtype} {tuple(taps.shape)}")


def fused_frontend_batch(
    images: torch.Tensor, *, threshold: int, contiguous: int, taps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blur + FAST on (B, H, W) uint8 → ``(blur u8, corner bool, score i32)``."""
    _check(images, taps)
    if images.device.type == "cpu":
        return fused_frontend_reference(
            images, threshold=threshold, contiguous=contiguous, taps=taps
        )
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
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
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    blur_border = (row < 2) | (row >= h - 2) | (col < 2) | (col >= w - 2)
    blur = torch.where(blur_border, images, blur)
    in_frame = (row >= BORDER) & (row < h - BORDER) & (col >= BORDER) & (col < w - BORDER)
    return blur, corner & in_frame, score


fused_frontend_batch.launches = 0
