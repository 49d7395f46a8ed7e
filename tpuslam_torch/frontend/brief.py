"""Gaussian blur, patch orientation and quantised steered BRIEF.

Port of the quantised path of ``tpuslam/frontend/brief.py``.  The plain
functions here are the twins of the hand-written kernels:

  * :func:`gaussian_blur_u8` — the blur half of kernel 1 (``csrc/frontend.cu``);
  * :func:`extract_brief_patches_i8` — kernel 2 (``csrc/brief.cu``);
  * :func:`own_bin_dots_onehot` — kernel 3 (``csrc/brief.cu``), the one-hot
    formulation of :func:`compute_brief_descriptors_quantized`.

Host-side constants (pattern, ±1 bin weights, disc moment weights) are the
reference package's numpy code, copied, so both packages build identical
arrays from the same config.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuslam_torch.frontend.fast import KeypointSet

BLUR_KERNEL_SIZE = 5
BLUR_SIGMA = 1.0


def gaussian_kernel(kernel_size: int = BLUR_KERNEL_SIZE, sigma: float = BLUR_SIGMA) -> np.ndarray:
    """Normalised Gaussian kernel, float64 on host."""
    if kernel_size % 2 == 0:
        raise ValueError("Kernel size must be odd")
    half = kernel_size // 2
    ii, jj = np.meshgrid(np.arange(-half, half + 1), np.arange(-half, half + 1), indexing="ij")
    k = np.exp(-(ii * ii + jj * jj) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur_u8(images: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Blur (B, H, W) uint8 images with a (k, k) float32 kernel; borders copied.

    Interior pixels are ``floor(Σ tap·pixel + 0.5)``, the taps added one at
    a time in row-major order, each product and sum rounded to float32 —
    the order kernel 1 uses, so the two agree bit for bit.
    """
    k = kernel.shape[-1]
    half = k // 2
    b, h, w = images.shape
    padded = F.pad(images.to(torch.float32), (half, half, half, half))
    acc = torch.zeros((b, h, w), dtype=torch.float32, device=images.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + kernel[dy, dx] * padded[:, dy : dy + h, dx : dx + w]
    interior = torch.floor(acc + 0.5).to(torch.uint8)
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    border = (row < half) | (row >= h - half) | (col < half) | (col >= w - half)
    return torch.where(border, images, interior)


class BriefPattern(NamedTuple):
    """Fixed sampling pattern (P pairs), generated once."""

    p1: torch.Tensor  # (P, 2) int32 — first point offsets (x, y)
    p2: torch.Tensor  # (P, 2) int32
    pair_valid: torch.Tensor  # (P,) bool — survived rejection sampling
    slot_to_pair: torch.Tensor  # (P,) int64 — compaction permutation (clamped)
    slot_used: torch.Tensor  # (P,) bool


def generate_brief_pattern_numpy(
    num_pairs: int, patch_size: int, seed: int = 42
) -> dict[str, np.ndarray]:
    """Gaussian point-pair pattern with the reference's rejection rule (numpy).

    Pairs with any coordinate ≥ patch/2 are dropped, not resampled.
    """
    rng = np.random.default_rng(seed)
    scale = patch_size / 2.0
    coords = rng.normal(0.0, 1.0, size=(num_pairs, 4)) * scale
    keep = np.all(np.abs(coords) < scale, axis=1)
    ints = coords.astype(np.int32)  # C-style trunc toward zero
    p1 = np.where(keep[:, None], ints[:, 0:2], 0)
    p2 = np.where(keep[:, None], ints[:, 2:4], 0)
    ranks = np.cumsum(keep) - 1
    slot_to_pair = np.full(num_pairs, num_pairs, dtype=np.int32)
    valid_j = np.nonzero(keep)[0]
    slot_to_pair[ranks[valid_j]] = valid_j
    slot_used = slot_to_pair < num_pairs
    return {
        "p1": p1.astype(np.int32),
        "p2": p2.astype(np.int32),
        "pair_valid": keep,
        "slot_to_pair": np.minimum(slot_to_pair, num_pairs - 1),
        "slot_used": slot_used,
    }


def generate_brief_pattern(
    num_pairs: int, patch_size: int, seed: int = 42, device: torch.device | str = "cpu"
) -> BriefPattern:
    arrs = generate_brief_pattern_numpy(num_pairs, patch_size, seed)
    return BriefPattern(
        p1=torch.from_numpy(arrs["p1"]).to(device),
        p2=torch.from_numpy(arrs["p2"]).to(device),
        pair_valid=torch.from_numpy(arrs["pair_valid"]).to(device),
        slot_to_pair=torch.from_numpy(arrs["slot_to_pair"].astype(np.int64)).to(device),
        slot_used=torch.from_numpy(arrs["slot_used"]).to(device),
    )


def rotation_patch_half(patch_size: int) -> int:
    """Half-size of a patch that contains every rotated BRIEF point."""
    return int(np.ceil((patch_size / 2.0) * np.sqrt(2.0)))


def patch_side(patch_size: int) -> int:
    """Rotation-patch side (2·half+1) rounded up to a multiple of 8."""
    return -(-(2 * rotation_patch_half(patch_size) + 1) // 8) * 8


def padded_patch_len(patch_size: int) -> int:
    """Flattened rotation-patch length rounded up to a multiple of 128."""
    s = patch_side(patch_size)
    return -(-(s * s) // 128) * 128


def disc_moment_weights(patch_size: int) -> np.ndarray:
    """(S2p, 2) int8 disc weights for patch-local orientation moments.

    Column 0 carries the m01 (v) weights, column 1 the m10 (u) weights.  The
    disc is symmetric, so moments of −128-shifted patches equal those of the
    raw intensities exactly.
    """
    half = rotation_patch_half(patch_size)
    r = patch_size // 2
    S = patch_side(patch_size)
    W = np.zeros((padded_patch_len(patch_size), 2), dtype=np.int8)
    for v in range(-r, r + 1):
        for u in range(-r, r + 1):
            if u * u + v * v <= r * r:
                idx = (v + half) * S + (u + half)
                W[idx, 0] = v
                W[idx, 1] = u
    return W


def build_brief_bin_weights(
    pattern: dict[str, np.ndarray], patch_size: int, bins: int
) -> tuple[np.ndarray, np.ndarray]:
    """Constant ±1 weights (S2p, bins·P) int8 for the quantised BRIEF path.

    Column b·P + j holds +1 at pair j's rotated p2 and −1 at its rotated p1
    (rotation by bin b), so ``patch · W`` is ``I(p2) − I(p1)``.  Returns
    (W, in-patch validity (bins, P)).
    """
    half = rotation_patch_half(patch_size)
    S = patch_side(patch_size)
    p1 = np.asarray(pattern["p1"])
    p2 = np.asarray(pattern["p2"])
    pv = np.asarray(pattern["pair_valid"])
    P = p1.shape[0]
    W = np.zeros((padded_patch_len(patch_size), bins * P), dtype=np.int8)
    ok = np.zeros((bins, P), dtype=bool)
    for b in range(bins):
        a = 2.0 * np.pi * b / bins
        ca, sa = np.float32(np.cos(a)), np.float32(np.sin(a))
        x1 = (p1[:, 0] * ca - p1[:, 1] * sa).astype(np.int32)
        y1 = (p1[:, 0] * sa + p1[:, 1] * ca).astype(np.int32)
        x2 = (p2[:, 0] * ca - p2[:, 1] * sa).astype(np.int32)
        y2 = (p2[:, 0] * sa + p2[:, 1] * ca).astype(np.int32)
        inside = (
            (np.abs(x1) <= half) & (np.abs(y1) <= half)
            & (np.abs(x2) <= half) & (np.abs(y2) <= half) & pv
        )
        ok[b] = inside
        idx1 = (y1 + half) * S + (x1 + half)
        idx2 = (y2 + half) * S + (x2 + half)
        cols = b * P + np.arange(P)
        np.add.at(W, (idx2[inside], cols[inside]), 1)
        np.add.at(W, (idx1[inside], cols[inside]), -1)
    return W, ok


def bin_rotated_offsets(p1: torch.Tensor, p2: torch.Tensor, bins: int) -> torch.Tensor:
    """(bins, P, 4) int32 pattern offsets (x1, y1, x2, y2) rotated by each bin's angle.

    The in-image test of :func:`brief_bits_from_dots` uses these; they are
    computed once, in float32 on the host, exactly as the reference package
    computes them per keypoint (``cos``/``sin`` of the float32 bin angle,
    then truncation toward zero), so every device reads the same table.
    """
    a = torch.arange(bins, dtype=torch.float32) * (2.0 * np.pi / bins)
    cos_t = torch.cos(a)[:, None]
    sin_t = torch.sin(a)[:, None]
    out = []
    for p in (p1.cpu().to(torch.float32), p2.cpu().to(torch.float32)):
        x = p[None, :, 0] * cos_t - p[None, :, 1] * sin_t
        y = p[None, :, 0] * sin_t + p[None, :, 1] * cos_t
        out += [x.to(torch.int32), y.to(torch.int32)]
    return torch.stack(out, dim=-1)


def extract_brief_patches_i8(
    images_blurred: torch.Tensor, kps_xy: torch.Tensor, patch_size: int
) -> torch.Tensor:
    """(B, K, S2p) int8 flattened patches centred on each keypoint (twin of kernel 2).

    Keypoint coordinates truncate toward zero and clip to the image; the
    patch's top-left is (y − half, x − half).  Intensities shift by −128
    into int8, pixels outside the image read as 0 (→ −128), and the tail
    past side² is 0.
    """
    half = rotation_patch_half(patch_size)
    S = patch_side(patch_size)
    b, h, w = images_blurred.shape
    k = kps_xy.shape[1]
    dev = images_blurred.device
    padded = F.pad(images_blurred, (half, S - half - 1, half, S - half - 1))
    xi = kps_xy[..., 0].to(torch.int64).clamp(0, w - 1)
    yi = kps_xy[..., 1].to(torch.int64).clamp(0, h - 1)
    rr = torch.arange(S, device=dev)
    rows = (yi[..., None] + rr)[..., :, None]  # (B, K, S, 1)
    cols = (xi[..., None] + rr)[..., None, :]  # (B, K, 1, S)
    wp = padded.shape[-1]
    flat_idx = (rows * wp + cols).reshape(b, k * S * S)
    patches = torch.gather(padded.reshape(b, -1), 1, flat_idx).reshape(b, k, S * S)
    flat = (patches.to(torch.int16) - 128).to(torch.int8)
    return F.pad(flat, (0, padded_patch_len(patch_size) - S * S))


def orientations_from_patches(
    patches_i8: torch.Tensor,
    moment_weights: torch.Tensor,
    kps: KeypointSet,
    patch_size: int,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Intensity-centroid angles (degrees) from (B, K, S2p) int8 patches.

    The moments are one (K, S2p)·(S2p, 2) product, in float32: every
    partial sum is an integer below 2^24, so it is exact.  Keypoints whose
    disc is clipped by the border, or invalid ones, get angle 0.
    """
    h, w = image_shape
    m = torch.matmul(patches_i8.to(torch.float32), moment_weights.to(torch.float32))
    m01 = m[..., 0]
    m10 = m[..., 1]
    radius = patch_size // 2
    xi = kps.xy[..., 0].to(torch.int32)
    yi = kps.xy[..., 1].to(torch.int32)
    in_bounds = (xi - radius >= 0) & (xi + radius < w) & (yi - radius >= 0) & (yi + radius < h)
    angle = torch.atan2(m01, m10) * (180.0 / np.pi)
    return torch.where(in_bounds & kps.valid, angle, 0.0).to(torch.float32)


def quantize_angles(angles_deg: torch.Tensor, bins: int) -> torch.Tensor:
    """Angle (degrees) → orientation bin over the full circle (int64).

    ``torch.remainder`` is the floored modulo of ``jnp.mod``.
    """
    theta = angles_deg * np.float32(np.pi / 180.0)
    frac = torch.remainder(theta / np.float32(2.0 * np.pi), 1.0)
    return torch.clamp((frac * bins + 0.5).to(torch.int64) % bins, 0, bins - 1)


def own_bin_dots_onehot(
    patches_i8: torch.Tensor, bin_idx: torch.Tensor, bin_weights_3d: torch.Tensor
) -> torch.Tensor:
    """(B, K, P) int32 ``patches[b, k] · W[bin[b, k]]`` (twin of kernel 3).

    All bins' dots as one float32 product (exact: integer partial sums
    below 2^24), then a one-hot select of each keypoint's own bin.
    """
    bins, s2p, p = bin_weights_3d.shape
    w_flat = bin_weights_3d.permute(1, 0, 2).reshape(s2p, bins * p).to(torch.float32)
    dots = torch.matmul(patches_i8.to(torch.float32), w_flat)  # (B, K, bins·P)
    dots = dots.reshape(*patches_i8.shape[:-1], bins, p)
    onehot = F.one_hot(bin_idx.to(torch.int64).clamp(0, bins - 1), bins).to(torch.float32)
    onehot = onehot * ((bin_idx >= 0) & (bin_idx < bins))[..., None]
    return (dots * onehot[..., None]).sum(dim=-2).to(torch.int32)


def brief_bits_from_dots(
    own: torch.Tensor,
    bin_idx: torch.Tensor,
    kps: KeypointSet,
    pattern: BriefPattern,
    rotated: torch.Tensor,
    num_pairs: int,
    patch_size: int,
    image_shape: tuple[int, int],
) -> torch.Tensor:
    """Own-bin dots (B, K, P) → packed descriptors (B, K, num_pairs/8) uint8.

    Applies in-image validity from the quantised rotation (``rotated`` is
    :func:`bin_rotated_offsets`), the static pattern compaction, the border
    rule (all-zero descriptor within patch/2 of the border) and LSB-first
    byte packing.
    """
    h, w = image_shape
    xi = kps.xy[..., 0].to(torch.int32)[..., None]
    yi = kps.xy[..., 1].to(torch.int32)[..., None]
    off = rotated[bin_idx]  # (B, K, P, 4)
    x1 = off[..., 0] + xi
    y1 = off[..., 1] + yi
    x2 = off[..., 2] + xi
    y2 = off[..., 3] + yi
    in_img = (
        (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h)
        & (x2 >= 0) & (x2 < w) & (y2 >= 0) & (y2 < h)
    )
    bit_val = (own > 0) & in_img & pattern.pair_valid
    bits = bit_val[..., pattern.slot_to_pair] & pattern.slot_used
    radius = patch_size // 2
    xk = xi[..., 0]
    yk = yi[..., 0]
    ok = (
        (xk - radius >= 0) & (xk + radius < w) & (yk - radius >= 0) & (yk + radius < h)
        & kps.valid
    )
    bits = bits & ok[..., None]
    weights = (1 << torch.arange(8, device=own.device)).to(torch.uint8)
    packed = bits.reshape(*bits.shape[:-1], num_pairs // 8, 8).to(torch.uint8) * weights
    return packed.sum(dim=-1, dtype=torch.uint8)


def compute_brief_descriptors_quantized(
    images_blurred: torch.Tensor,
    kps: KeypointSet,
    angles_deg: torch.Tensor,
    pattern: BriefPattern,
    bin_weights_3d: torch.Tensor,
    rotated: torch.Tensor,
    num_pairs: int,
    patch_size: int,
) -> torch.Tensor:
    """Steered BRIEF with orientation quantised to ``bins`` — the plain path."""
    bins = bin_weights_3d.shape[0]
    h, w = images_blurred.shape[-2:]
    bin_idx = quantize_angles(angles_deg, bins)
    patches = extract_brief_patches_i8(images_blurred, kps.xy, patch_size)
    own = own_bin_dots_onehot(patches, bin_idx, bin_weights_3d)
    return brief_bits_from_dots(
        own, bin_idx, kps, pattern, rotated, num_pairs, patch_size, (h, w)
    )
