"""The yardstick for the port's five hand-written kernels: their work and the H100's peaks.

A frozen copy of the port's ``*_work`` counts (bytes each input read once
and each output written once, and the operations the call must do,
counted from its shapes) and of the published peaks of one H100 SXM at
700 W (NVIDIA's data sheet, dense).  A kernel's bound is the larger of its
bytes over the memory rate and its operations over their peak.

``step_kernels`` lists each kernel's calls in one VO step of a cell, from
the configuration's shapes alone, keyed by the name that ``KERNELS`` maps
the device trace's kernel names to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # int8 tensor cores

# name in the benchmark → the CUDA functions of that call, as the device trace names them
KERNELS = {
    "frontend": ("frontend_kernel",),  # kernel 1: blur + FAST + score
    "frontend_nms": ("frontend_nms_kernel",),  # kernel 5: blur + FAST + NMS
    "brief_patches": ("extract_kernel",),  # kernel 2: BRIEF patch extraction
    "brief_dots": ("bin_sort_kernel", "own_bin_kernel"),  # kernel 3: own-bin BRIEF dots (two launches a call)
    "msac": ("msac_kernel",),  # kernel 4: MSAC hypothesis scores
}


class Work(NamedTuple):
    bytes: int
    ops: int
    peak: float

    def bound_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / self.peak)


def frontend_work(b: int, h: int, w: int) -> Work:
    """1 byte in, 1 + 1 + 4 out a pixel; the blur's 25 multiplies and 25 adds (float32)."""
    return Work(7 * b * h * w, 50 * b * h * w, PEAK_F32_OPS)


def frontend_nms_work(b: int, h: int, w: int) -> Work:
    """1 byte in, 1 + 8 out a pixel; the blur's float32 operations."""
    return Work(10 * b * h * w, 50 * b * h * w, PEAK_F32_OPS)


def _rotation_half(patch: int) -> int:
    return int(np.ceil((patch / 2.0) * np.sqrt(2.0)))


def padded_patch_len(patch: int) -> int:
    side = -(-(2 * _rotation_half(patch) + 1) // 8) * 8
    return -(-(side * side) // 128) * 128


def patches_work(b: int, h: int, w: int, k: int, patch: int) -> Work:
    """The blurred frames and the keypoints (8 bytes each) in, the int8 patches out; a gather."""
    s2p = padded_patch_len(patch)
    return Work(b * h * w + b * k * 8 + b * k * s2p, 0, PEAK_INT8_OPS)


def dots_work(b: int, k: int, pairs: int, patch: int, used_bins: int) -> Work:
    """Patches, int64 bins and int32 dots per keypoint, the used bins' weights; 2·S2p·P int8
    operations per keypoint (every keypoint's bin is in range)."""
    s2p = padded_patch_len(patch)
    return Work(b * k * (s2p + 8 + 4 * pairs) + used_bins * pairs * s2p, 2 * b * k * pairs * s2p, PEAK_INT8_OPS)


def msac_work(b: int, h: int, m: int) -> Work:
    """E and the (9, 5M) operand read once, the scores written once; 97 float32 operations per
    (hypothesis, match)."""
    return Work(4 * (b * h * 9 + b * 9 * 5 * m + b * h), 97 * b * h * m, PEAK_F32_OPS)


def levels(params: dict) -> list[tuple[int, int, int]]:
    """(h_l, w_l, keypoints) of every pyramid level the configuration detects on."""
    d, cam = params["detector"], params["camera"]
    h, w = cam["height"], cam["width"]
    out = []
    for level in range(d["num_levels"]):
        s = d["scale_factor"] ** level
        h_l, w_l = int(round(h / s)), int(round(w / s))
        if min(h_l, w_l) < 4 * d["patch_size"]:
            break
        out.append((h_l, w_l))
    areas = [a * b for a, b in out]
    caps = [max(32, int(round(d["max_keypoints"] * a / float(sum(areas))))) for a in areas]
    caps[0] += d["max_keypoints"] - sum(caps)
    return [(h_l, w_l, c) for (h_l, w_l), c in zip(out, caps)]


def step_kernels(params: dict, frames: int, nms_fused: bool) -> dict[str, list[Work]]:
    """Each kernel's calls in one step over ``frames`` frames.  Kernel 5 runs on every level when the
    configuration fuses NMS (each level's tiles outnumber its keypoints here); otherwise kernel 1.
    Kernel 3's used bins: all of them (hundreds of thousands of keypoints fall in every bin)."""
    d = params["detector"]
    out: dict[str, list[Work]] = {k: [] for k in KERNELS}
    for h_l, w_l, k_l in levels(params):
        out["frontend_nms" if nms_fused else "frontend"].append(
            (frontend_nms_work if nms_fused else frontend_work)(frames, h_l, w_l))
        out["brief_patches"].append(patches_work(frames, h_l, w_l, k_l, d["patch_size"]))
        out["brief_dots"].append(dots_work(frames, k_l, d["num_brief_pairs"], d["patch_size"],
                                           d["brief_quantized_bins"]))
    out["msac"].append(msac_work(frames, params["pose"]["num_hypotheses"], d["max_keypoints"]))
    return {k: v for k, v in out.items() if v}
