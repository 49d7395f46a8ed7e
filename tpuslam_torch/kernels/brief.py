"""Kernel 2 and 3 wrappers: BRIEF patch extraction and own-bin dots (``csrc/brief.cu``).

Replace ``tpuslam/kernels/brief_pallas.py::extract_brief_patches_tpu`` and
``brief_own_bin_dots``.  On a CUDA tensor each wrapper launches its kernel
(or raises); on a CPU tensor it runs the plain twin named beside it.
"""

from __future__ import annotations

import torch

from tpuslam_torch.frontend.brief import (
    extract_brief_patches_i8,
    own_bin_dots_onehot,
    padded_patch_len,
    patch_side,
    rotation_patch_half,
)
from tpuslam_torch.kernels.build import library

# The plain twins (tpuslam_torch/frontend/brief.py).
extract_brief_patches_reference = extract_brief_patches_i8
brief_own_bin_dots_reference = own_bin_dots_onehot


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def extract_brief_patches(
    images_blurred: torch.Tensor, kps_xy: torch.Tensor, patch_size: int
) -> torch.Tensor:
    """(B, H, W) uint8 blurred frames + (B, K, 2) float32 keypoints → (B, K, S2p) int8."""
    if images_blurred.dtype != torch.uint8 or images_blurred.dim() != 3:
        raise ValueError("images_blurred must be (B, H, W) uint8")
    b, h, w = images_blurred.shape
    if kps_xy.dtype != torch.float32 or kps_xy.dim() != 3 or kps_xy.shape[0] != b or kps_xy.shape[2] != 2:
        raise ValueError(f"kps_xy must be (B, K, 2) float32, got {kps_xy.dtype} {tuple(kps_xy.shape)}")
    if kps_xy.device != images_blurred.device:
        raise ValueError("images_blurred and kps_xy must be on one device")
    if images_blurred.device.type == "cpu":
        return extract_brief_patches_reference(images_blurred, kps_xy, patch_size)
    _require_cuda(images_blurred)
    if not (images_blurred.is_contiguous() and kps_xy.is_contiguous()):
        raise ValueError("images_blurred and kps_xy must be contiguous")
    k = kps_xy.shape[1]
    s2p = padded_patch_len(patch_size)
    out = torch.empty((b, k, s2p), dtype=torch.int8, device=images_blurred.device)
    if b * k:
        with torch.cuda.device(images_blurred.device):
            library().call(
                "tpuslam_extract_patches",
                images_blurred.data_ptr(), kps_xy.data_ptr(), out.data_ptr(),
                b, h, w, k, patch_side(patch_size), rotation_patch_half(patch_size), s2p,
                torch.cuda.current_stream().cuda_stream,
            )
        extract_brief_patches.launches += 1
    return out


extract_brief_patches.launches = 0


def pack_bin_weights(bin_weights_3d: torch.Tensor) -> torch.Tensor:
    """(bins, S2p, P) int8 → (bins, S2p/4, P) int32, four consecutive rows per word.

    Byte j of word (b, q, p) is ``W[b, 4q + j, p]`` (little-endian), the
    layout kernel 3 feeds to ``__dp4a``.
    """
    bins, s2p, p = bin_weights_3d.shape
    return (
        bin_weights_3d.reshape(bins, s2p // 4, 4, p)
        .permute(0, 1, 3, 2)
        .contiguous()
        .view(torch.int32)
        .reshape(bins, s2p // 4, p)
    )


def brief_own_bin_dots(
    patches_i8: torch.Tensor, bin_idx: torch.Tensor, bin_weights_3d: torch.Tensor
) -> torch.Tensor:
    """(B, K, P) int32: ``patches[b, k] · W[bin_idx[b, k]]``; bins out of range give 0."""
    if patches_i8.dtype != torch.int8 or patches_i8.dim() != 3:
        raise ValueError("patches_i8 must be (B, K, S2p) int8")
    if bin_weights_3d.dtype != torch.int8 or bin_weights_3d.dim() != 3:
        raise ValueError("bin_weights_3d must be (bins, S2p, P) int8")
    b, k, s2p = patches_i8.shape
    bins, s2p_w, p = bin_weights_3d.shape
    if s2p_w != s2p or s2p % 4 or bin_idx.shape != (b, k):
        raise ValueError(
            f"shape mismatch: patches {tuple(patches_i8.shape)}, bins {tuple(bin_idx.shape)}, "
            f"weights {tuple(bin_weights_3d.shape)}"
        )
    devices = {patches_i8.device, bin_idx.device, bin_weights_3d.device}
    if len(devices) != 1:
        raise ValueError("patches, bin_idx and weights must be on one device")
    if patches_i8.device.type == "cpu":
        return brief_own_bin_dots_reference(patches_i8, bin_idx, bin_weights_3d)
    _require_cuda(patches_i8)
    patches = patches_i8.contiguous()
    bins32 = bin_idx.to(torch.int32).contiguous()
    w4 = pack_bin_weights(bin_weights_3d)
    out = torch.empty((b, k, p), dtype=torch.int32, device=patches.device)
    if b * k:
        with torch.cuda.device(patches.device):
            library().call(
                "tpuslam_own_bin_dots",
                patches.data_ptr(), bins32.data_ptr(), w4.data_ptr(), out.data_ptr(),
                b, k, s2p, p, bins, torch.cuda.current_stream().cuda_stream,
            )
        brief_own_bin_dots.launches += 1
    return out


brief_own_bin_dots.launches = 0
