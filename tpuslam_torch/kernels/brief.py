"""Kernel 2 and 3 wrappers: BRIEF patch extraction and own-bin dots (``csrc/brief.cu``).

Replace ``tpuslam/kernels/brief_pallas.py::extract_brief_patches_tpu`` and
``brief_own_bin_dots``.  On a CUDA tensor each wrapper launches its kernel
(or raises); on a CPU tensor it runs the plain twin named beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.frontend.brief import (
    extract_brief_patches_i8,
    own_bin_dots_grouped,
    padded_patch_len,
    patch_side,
    rotation_patch_half,
)
from tpuslam_torch.kernels.bounds import PEAK_INT8_OPS, Work
from tpuslam_torch.kernels.build import library

# The plain twins (tpuslam_torch/frontend/brief.py).
extract_brief_patches_reference = extract_brief_patches_i8
brief_own_bin_dots_reference = own_bin_dots_grouped


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


def extract_patches_work(b: int, h: int, w: int, k: int, patch_size: int) -> Work:
    """Bytes one call moves: the blurred frames and keypoints in, the patches out.

    It is a gather with a −128 shift: no operation counts toward its bound.
    """
    s2p = padded_patch_len(patch_size)
    return Work(bytes=b * h * w + b * k * 8 + b * k * s2p, ops=0, peak=PEAK_INT8_OPS)


class PackedBinWeights(NamedTuple):
    """Kernel 3's weight layout: ``t`` (bins, P, S2p) int8, contiguous.

    ``t[b, p, s] == W[b, s, p]``: each pair's column of a bin is contiguous
    along S2p, the k-major B operand of the tensor-core product.  Built once
    (:func:`pack_bin_weights`, at detector init), never per call.
    """

    t: torch.Tensor

    def as_3d(self) -> torch.Tensor:
        """The (bins, S2p, P) weights the plain twin takes (a view)."""
        return self.t.transpose(1, 2)


def pack_bin_weights(bin_weights_3d: torch.Tensor) -> PackedBinWeights:
    """(bins, S2p, P) int8 → :class:`PackedBinWeights` (bins, P, S2p), on the same device."""
    if bin_weights_3d.dtype != torch.int8 or bin_weights_3d.dim() != 3:
        raise ValueError("bin_weights_3d must be (bins, S2p, P) int8")
    return PackedBinWeights(bin_weights_3d.transpose(1, 2).contiguous())


def own_bin_dots_work(bin_idx: torch.Tensor, weights: PackedBinWeights) -> Work:
    """Bytes and int8 operations one call needs: 2·S2p·P per keypoint of an in-range bin.

    Inputs read once (patches, int64 bin indices, the used bins' weights),
    the int32 output written once.
    """
    bins, p, s2p = weights.t.shape
    b, k = bin_idx.shape
    in_range = (bin_idx >= 0) & (bin_idx < bins)
    used_bins = int(torch.unique(bin_idx[in_range]).numel())
    n_dots = int(in_range.sum())
    return Work(
        bytes=b * k * (s2p + 8 + 4 * p) + used_bins * p * s2p,
        ops=2 * n_dots * p * s2p,
        peak=PEAK_INT8_OPS,
    )


def brief_own_bin_dots(
    patches_i8: torch.Tensor, bin_idx: torch.Tensor, weights: PackedBinWeights
) -> torch.Tensor:
    """(B, K, P) int32: ``patches[b, k] · W[bin_idx[b, k]]``; bins out of range give 0.

    ``weights`` is the layout :func:`pack_bin_weights` builds; the kernel
    takes S2p a multiple of 64, P a multiple of 128 and at most 128 bins.
    """
    if patches_i8.dtype != torch.int8 or patches_i8.dim() != 3:
        raise ValueError("patches_i8 must be (B, K, S2p) int8")
    if not isinstance(weights, PackedBinWeights):
        raise ValueError(f"weights must be PackedBinWeights (pack_bin_weights), got {type(weights)}")
    wt = weights.t
    if wt.dtype != torch.int8 or wt.dim() != 3 or not wt.is_contiguous():
        raise ValueError("weights.t must be a contiguous (bins, P, S2p) int8 tensor")
    b, k, s2p = patches_i8.shape
    bins, p, s2p_w = wt.shape
    if s2p_w != s2p or bin_idx.shape != (b, k):
        raise ValueError(
            f"shape mismatch: patches {tuple(patches_i8.shape)}, bins {tuple(bin_idx.shape)}, "
            f"weights (bins, P, S2p) {tuple(wt.shape)}"
        )
    devices = {patches_i8.device, bin_idx.device, wt.device}
    if len(devices) != 1:
        raise ValueError("patches, bin_idx and weights must be on one device")
    if patches_i8.device.type == "cpu":
        return brief_own_bin_dots_reference(patches_i8, bin_idx, weights.as_3d())
    _require_cuda(patches_i8)
    if s2p % 64 or p % 128 or bins > 128:
        raise ValueError(f"kernel 3 takes S2p % 64 == 0, P % 128 == 0 and at most 128 bins, "
                         f"got {s2p}, {p}, {bins}")
    patches = patches_i8.contiguous()
    bins64 = bin_idx.to(torch.int64).contiguous()  # quantize_angles' dtype: no copy on the path
    out = torch.empty((b, k, p), dtype=torch.int32, device=patches.device)
    # the kernel's scratch: rows grouped by bin (group j from j·B·K on), and each group's size
    order = torch.empty(((bins + 1) * b * k,), dtype=torch.int32, device=patches.device)
    group_size = torch.zeros((bins + 1,), dtype=torch.int32, device=patches.device)
    if b * k:
        with torch.cuda.device(patches.device):
            library().call(
                "tpuslam_own_bin_dots",
                patches.data_ptr(), bins64.data_ptr(), wt.data_ptr(), out.data_ptr(),
                order.data_ptr(), group_size.data_ptr(),
                b, k, s2p, p, bins, torch.cuda.current_stream().cuda_stream,
            )
        brief_own_bin_dots.launches += 1
    return out


brief_own_bin_dots.launches = 0
