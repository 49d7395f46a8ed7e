"""Reference front end: undistortion, blur, FAST, NMS and top-k, the pyramid, steered BRIEF, matching.

Each function is the plain form of a stage of the port's chunk step, with
the same integer arithmetic and the same float32 operation order, so the
port's integer outputs (keypoints, angles' bins, descriptors, matches) are
expected bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3
SCORE_BITS = 12
IDX_BITS = 32 - SCORE_BITS
SENT16 = 32767


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (..., K, 2) float32
    response: torch.Tensor  # (..., K) float32
    angle: torch.Tensor  # (..., K) float32, degrees
    valid: torch.Tensor  # (..., K) bool


# --- camera --------------------------------------------------------------------------------------


def undistort_map(K: np.ndarray, D: np.ndarray, width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat int64 source index and validity of each output pixel: the forward radial-tangential model
    (k1, k2, p1, p2; k3 unused, as the calibration's consumer does), rounded half away from zero."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d = [float(D[i]) if D.size > i else 0.0 for i in range(4)]
    k1, k2, p1, p2 = d
    u = np.arange(width, dtype=np.float64)[None, :].repeat(height, axis=0)
    v = np.arange(height, dtype=np.float64)[:, None].repeat(width, axis=1)
    x = (u - cx) / fx
    y = (v - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)

    def round_away(a):
        return np.where(a >= 0, np.floor(a + 0.5), np.ceil(a - 0.5))

    us = round_away(fx * xd + cx).astype(np.int64)
    vs = round_away(fy * yd + cy).astype(np.int64)
    valid = (us >= 0) & (us < width) & (vs >= 0) & (vs < height)
    flat = np.clip(vs, 0, height - 1) * width + np.clip(us, 0, width - 1)
    return flat, valid


def undistort(images: torch.Tensor, flat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    b, h, w = images.shape
    out = images.reshape(b, h * w)[:, flat.reshape(-1)].reshape(b, h, w)
    return torch.where(valid, out, torch.zeros((), dtype=images.dtype, device=images.device))


# --- blur and FAST -------------------------------------------------------------------------------


def gaussian_taps() -> np.ndarray:
    """The 5×5, sigma 1 Gaussian, normalised in float64, then float32."""
    ii, jj = np.meshgrid(np.arange(-2, 3), np.arange(-2, 3), indexing="ij")
    k = np.exp(-(ii * ii + jj * jj) / 2.0)
    return (k / k.sum()).astype(np.float32)


def blur_u8(images: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """floor(Σ tap·pixel + 0.5) with the taps added one at a time, row-major, each step in float32;
    the 2-px border copied from the source."""
    b, h, w = images.shape
    padded = F.pad(images.to(torch.float32), (2, 2, 2, 2))
    acc = torch.zeros((b, h, w), dtype=torch.float32, device=images.device)
    for dy in range(5):
        for dx in range(5):
            acc = acc + float(taps[dy, dx]) * padded[:, dy : dy + h, dx : dx + w]
    interior = torch.floor(acc + 0.5).to(torch.uint8)
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    border = (row < 2) | (row >= h - 2) | (col < 2) | (col >= w - 2)
    return torch.where(border, images, interior)


def fast_corners(images: torch.Tensor, threshold: int, contiguous: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(corner bool, score int32): the segment test of ``contiguous`` brighter or darker pixels on the
    16-circle (wrapping), the cardinal pretest, the 3-px interior; score = SAD to the 16 neighbours
    with zeros outside the image."""
    b, h, w = images.shape
    r = BORDER
    x = F.pad(images.to(torch.int16), (r, r, r, r))
    center = x[:, r : r + h, r : r + w]
    bright, dark = [], []
    score = torch.zeros(center.shape, dtype=torch.int32, device=images.device)
    for dx, dy in CIRCLE:
        nb = x[:, r + dy : r + dy + h, r + dx : r + dx + w]
        bright.append(nb > center + threshold)
        dark.append(nb < center - threshold)
        score += (nb - center).abs().to(torch.int32)
    seg = torch.zeros(center.shape, dtype=torch.bool, device=images.device)
    for flags in (bright, dark):
        for start in range(16):
            run = flags[start]
            for i in range(1, contiguous):
                run = run & flags[(start + i) % 16]
            seg |= run
    nb4 = sum(bright[c].to(torch.int8) for c in (0, 4, 8, 12))
    nd4 = sum(dark[c].to(torch.int8) for c in (0, 4, 8, 12))
    pretest = (bright[0] | dark[0] | bright[8] | dark[8]) & ((nb4 >= 3) | (nd4 >= 3))
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    interior = (row >= r) & (row < h - r) & (col >= r) & (col < w - r)
    return pretest & seg & interior, score


def _idx_shift(n: int) -> int:
    shift = 0
    while (n >> shift) > (1 << IDX_BITS) - 1:
        shift += 1
    return shift


def packed_key(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """score << 20 | inverted raster index (int64, a uint32 value); 0 where masked."""
    h, w = score.shape[-2:]
    n = h * w
    idx = torch.arange(n, dtype=torch.int64, device=score.device).reshape(h, w)
    key = (score.to(torch.int64) << IDX_BITS) | ((n - 1 - idx) >> _idx_shift(n))
    return torch.where(mask, key, 0)


def _window_max(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Max over a centred ``size`` window along ``dim``, zero padded (max_pool on an int64 plane)."""
    half = (size - 1) // 2
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [half, size - 1 - half]
    xp = F.pad(x, pad)
    n = x.shape[dim]
    out = xp.narrow(dim, 0, n)
    for i in range(1, size):
        out = torch.maximum(out, xp.narrow(dim, i, n))
    return out


def nms_keep(corner: torch.Tensor, score: torch.Tensor, window: int) -> torch.Tensor:
    """A corner survives iff its packed key is the max of its (2·window−1)² neighbourhood."""
    key = packed_key(score, corner)
    size = 2 * max(window - 1, 0) + 1
    pooled = _window_max(_window_max(key, size, -2), size, -1)
    return corner & (key == pooled) & (key > 0)


def top_keypoints(corner: torch.Tensor, score: torch.Tensor, window: int, max_keypoints: int) -> Keypoints:
    """The ``max_keypoints`` surviving corners with the largest keys, in descending key order."""
    b, h, w = corner.shape
    key = packed_key(score, nms_keep(corner, score, window)).reshape(b, h * w)
    top = torch.sort(key, dim=-1, descending=True, stable=True)
    keys = top.values[:, :max_keypoints]
    idx = top.indices[:, :max_keypoints]
    valid = keys > 0
    xy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    resp = (keys >> IDX_BITS).to(torch.float32)
    return Keypoints(
        xy=torch.where(valid[..., None], xy, 0.0),
        response=torch.where(valid, resp, 0.0),
        angle=torch.zeros(resp.shape, dtype=torch.float32, device=resp.device),
        valid=valid,
    )


# --- the pyramid ---------------------------------------------------------------------------------


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of an antialiased linear resize: the triangle kernel widened by
    max(1/scale, 1), sample positions (i + ½)/scale − ½ rounded once from float64, columns normalised
    (guarded by 1000·eps), zero outside the input."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    pos = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (pos.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist * (f32(1) / kernel_scale))
    total = np.zeros((1, n_out), f32)
    for row in w:
        total = total + row
    w = np.where(np.abs(total) > f32(1000 * np.finfo(f32).eps), w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T, dtype=f32)


def _taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Each output's nonzero weights in ascending input order, as (T, n_out) indices and weights."""
    wm = resize_weights(n_in, n_out)
    nz = wm != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    t = int(nz.sum(axis=1).max())
    idx = np.minimum(first[None, :] + np.arange(t)[:, None], n_in - 1)
    wt = np.take_along_axis(wm, idx.T, axis=1).T
    wt = np.where(first[None, :] + np.arange(t)[:, None] < n_in, wt, 0).astype(np.float32)
    return idx, wt


def resize_u8(images: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Rows then columns, each output's taps added in ascending input order (a multiply and an add
    each, float32), rounded half to even, clipped."""
    b, h, w = images.shape
    dev = images.device
    x = images.to(torch.float32)
    idx, wt = (torch.from_numpy(a).to(dev) for a in _taps(h, h_out))
    rows = torch.zeros((b, h_out, w), dtype=torch.float32, device=dev)
    for t in range(idx.shape[0]):
        rows = rows + wt[t][None, :, None] * x[:, idx[t], :]
    idx, wt = (torch.from_numpy(a).to(dev) for a in _taps(w, w_out))
    out = torch.zeros((b, h_out, w_out), dtype=torch.float32, device=dev)
    for t in range(idx.shape[0]):
        out = out + wt[t][None, None, :] * rows[:, :, idx[t]]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def pyramid_levels(h: int, w: int, cfg: dict) -> list[tuple[int, int, int, int]]:
    """(level, h_l, w_l, capacity) of every level at least 4 patches tall and wide; the capacities
    split ``max_keypoints`` by area (at least 32 each), the rounding remainder to level 0."""
    levels = []
    for level in range(cfg["num_levels"]):
        s = cfg["scale_factor"] ** level
        h_l, w_l = int(round(h / s)), int(round(w / s))
        if min(h_l, w_l) < 4 * cfg["patch_size"]:
            break
        levels.append((level, h_l, w_l))
    areas = [h_l * w_l for (_, h_l, w_l) in levels]
    caps = [max(32, int(round(cfg["max_keypoints"] * a / float(sum(areas))))) for a in areas]
    caps[0] += cfg["max_keypoints"] - sum(caps)
    return [(*lv, cap) for lv, cap in zip(levels, caps)]


# --- steered BRIEF -------------------------------------------------------------------------------


def rotation_half(patch_size: int) -> int:
    return int(np.ceil((patch_size / 2.0) * np.sqrt(2.0)))


def patch_side(patch_size: int) -> int:
    return -(-(2 * rotation_half(patch_size) + 1) // 8) * 8


def padded_len(patch_size: int) -> int:
    s = patch_side(patch_size)
    return -(-(s * s) // 128) * 128


class Brief:
    """The BRIEF pattern and its per-bin tables, built on the host from the configuration."""

    def __init__(self, cfg: dict, device: torch.device):
        pairs, ps, bins = cfg["num_brief_pairs"], cfg["patch_size"], cfg["brief_quantized_bins"]
        rng = np.random.default_rng(cfg["brief_seed"])
        scale = ps / 2.0
        coords = rng.normal(0.0, 1.0, size=(pairs, 4)) * scale
        keep = np.all(np.abs(coords) < scale, axis=1)
        ints = coords.astype(np.int32)
        p1 = np.where(keep[:, None], ints[:, 0:2], 0).astype(np.int32)
        p2 = np.where(keep[:, None], ints[:, 2:4], 0).astype(np.int32)
        ranks = np.cumsum(keep) - 1
        slot = np.full(pairs, pairs, dtype=np.int64)
        slot[ranks[np.nonzero(keep)[0]]] = np.nonzero(keep)[0]
        self.slot_used = torch.from_numpy(slot < pairs).to(device)
        self.slot_to_pair = torch.from_numpy(np.minimum(slot, pairs - 1)).to(device)
        self.pair_valid = torch.from_numpy(keep).to(device)

        half, side, s2p = rotation_half(ps), patch_side(ps), padded_len(ps)
        W = np.zeros((s2p, bins * pairs), dtype=np.int8)
        for b in range(bins):
            a = 2.0 * np.pi * b / bins
            ca, sa = np.float32(np.cos(a)), np.float32(np.sin(a))
            x1 = (p1[:, 0] * ca - p1[:, 1] * sa).astype(np.int32)
            y1 = (p1[:, 0] * sa + p1[:, 1] * ca).astype(np.int32)
            x2 = (p2[:, 0] * ca - p2[:, 1] * sa).astype(np.int32)
            y2 = (p2[:, 0] * sa + p2[:, 1] * ca).astype(np.int32)
            inside = (np.abs(x1) <= half) & (np.abs(y1) <= half) & (np.abs(x2) <= half) & (np.abs(y2) <= half) & keep
            cols = b * pairs + np.arange(pairs)
            np.add.at(W, ((y2[inside] + half) * side + x2[inside] + half, cols[inside]), 1)
            np.add.at(W, ((y1[inside] + half) * side + x1[inside] + half, cols[inside]), -1)
        self.weights = torch.from_numpy(W.astype(np.float32)).to(device)  # (S2p, bins·P)

        r = ps // 2
        M = np.zeros((s2p, 2), dtype=np.float32)
        for v in range(-r, r + 1):
            for u in range(-r, r + 1):
                if u * u + v * v <= r * r:
                    M[(v + half) * side + u + half] = (v, u)
        self.moments = torch.from_numpy(M).to(device)

        ang = torch.arange(bins, dtype=torch.float32) * (2.0 * np.pi / bins)
        cos_t, sin_t = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        rot = []
        for p in (torch.from_numpy(p1).float(), torch.from_numpy(p2).float()):
            rot += [(p[None, :, 0] * cos_t - p[None, :, 1] * sin_t).to(torch.int32),
                    (p[None, :, 0] * sin_t + p[None, :, 1] * cos_t).to(torch.int32)]
        self.rotated = torch.stack(rot, dim=-1).to(device)  # (bins, P, 4)
        self.cfg = cfg

    def patches(self, blurred: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
        """(B, K, S2p) int8 patches: top-left (y − half, x − half) of the truncated, clipped keypoint,
        intensities − 128, outside the image −128, the tail past side² zero."""
        ps = self.cfg["patch_size"]
        half, side = rotation_half(ps), patch_side(ps)
        b, h, w = blurred.shape
        k = xy.shape[1]
        padded = F.pad(blurred, (half, side - half - 1, half, side - half - 1))
        xi = xy[..., 0].to(torch.int64).clamp(0, w - 1)
        yi = xy[..., 1].to(torch.int64).clamp(0, h - 1)
        rr = torch.arange(side, device=blurred.device)
        flat = ((yi[..., None] + rr)[..., :, None] * padded.shape[-1] + (xi[..., None] + rr)[..., None, :])
        p = torch.gather(padded.reshape(b, -1), 1, flat.reshape(b, -1)).reshape(b, k, side * side)
        return F.pad((p.to(torch.int16) - 128).to(torch.int8), (0, padded_len(ps) - side * side))

    def describe(self, blurred: torch.Tensor, kps: Keypoints) -> tuple[Keypoints, torch.Tensor]:
        """Intensity-centroid angle, its bin, the own-bin pair tests, the in-image and border rules,
        LSB-first packing → (keypoints with angles, (B, K, P/8) uint8)."""
        c = self.cfg
        ps, bins, pairs = c["patch_size"], c["brief_quantized_bins"], c["num_brief_pairs"]
        h, w = blurred.shape[-2:]
        patches = self.patches(blurred, kps.xy)
        m = torch.matmul(patches.to(torch.float32), self.moments)
        r = ps // 2
        xi = kps.xy[..., 0].to(torch.int32)
        yi = kps.xy[..., 1].to(torch.int32)
        ok = (xi - r >= 0) & (xi + r < w) & (yi - r >= 0) & (yi + r < h) & kps.valid
        angle = torch.where(ok, torch.atan2(m[..., 0], m[..., 1]) * (180.0 / np.pi), 0.0).to(torch.float32)
        theta = angle * np.float32(np.pi / 180.0)
        frac = torch.remainder(theta / np.float32(2.0 * np.pi), 1.0)
        bin_idx = torch.clamp((frac * bins + 0.5).to(torch.int64) % bins, 0, bins - 1)
        # each keypoint's dots with every bin's pairs, then its own bin's (exact: integer sums < 2^24)
        flat = patches.reshape(-1, patches.shape[-1]).to(torch.float32)
        own = torch.empty((flat.shape[0], pairs), dtype=torch.int32, device=flat.device)
        bflat = bin_idx.reshape(-1)
        for j in range(bins):
            rows = torch.nonzero(bflat == j)[:, 0]
            own[rows] = torch.matmul(flat[rows], self.weights[:, j * pairs : (j + 1) * pairs]).to(torch.int32)
        own = own.reshape(*patches.shape[:-1], pairs)
        off = self.rotated[bin_idx]
        x1, y1 = off[..., 0] + xi[..., None], off[..., 1] + yi[..., None]
        x2, y2 = off[..., 2] + xi[..., None], off[..., 3] + yi[..., None]
        in_img = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h) & (x2 >= 0) & (x2 < w) & (y2 >= 0) & (y2 < h)
        bits = ((own > 0) & in_img & self.pair_valid)[..., self.slot_to_pair] & self.slot_used
        return kps._replace(angle=angle), pack_bits(bits & ok[..., None])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.int32)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.int32)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], desc.shape[-1] * 8)


class Detector:
    """Detection and description of (B, H, W) undistorted frames, one level or a pyramid."""

    def __init__(self, cfg: dict, device: torch.device):
        self.cfg = cfg
        self.taps = gaussian_taps()
        self.brief = Brief(cfg, device)

    def _level(self, images: torch.Tensor, cap: int) -> tuple[Keypoints, torch.Tensor]:
        c = self.cfg
        corner, score = fast_corners(images, c["intensity_threshold"], c["contiguous_pixels_threshold"])
        kps = top_keypoints(corner, score, c["suppression_window_size"], cap)
        return self.brief.describe(blur_u8(images, self.taps), kps)

    def __call__(self, images: torch.Tensor) -> tuple[Keypoints, torch.Tensor]:
        c = self.cfg
        if c["num_levels"] <= 1:
            return self._level(images, c["max_keypoints"])
        parts = []
        for level, h_l, w_l, cap in pyramid_levels(*images.shape[-2:], c):
            img = images if level == 0 else resize_u8(images, h_l, w_l)
            kps, desc = self._level(img, cap)
            scale = torch.tensor(c["scale_factor"] ** level, dtype=torch.float32, device=images.device)
            parts.append((kps._replace(xy=kps.xy * scale), desc))
        kps = Keypoints(*(torch.cat([p[0][i] for p in parts], dim=1) for i in range(4)))
        return kps, torch.cat([p[1] for p in parts], dim=1)


# --- matching ------------------------------------------------------------------------------------


class Matches(NamedTuple):
    train_idx: torch.Tensor  # (..., N1) int64, −1 where no match
    valid: torch.Tensor  # (..., N1) bool


def match(desc1, desc2, valid1, valid2, xy1, xy2, ratio: float, max_jump: float) -> Matches:
    """Every query's nearest train descriptor by Hamming distance (int16), scaled by (1 + d/R) and
    truncated where the pixel jump d exceeds R; invalid trains never win; the lowest index wins ties;
    kept where best < ratio · second best."""
    b1 = unpack_bits(desc1).to(torch.float32)
    b2 = unpack_bits(desc2).to(torch.float32)
    dist = (b1.sum(-1)[..., :, None] + b2.sum(-1)[..., None, :] - 2.0 * torch.matmul(b1, b2.transpose(-1, -2)))
    dist = dist.to(torch.int32).to(torch.int16)
    d2 = (xy1 * xy1).sum(-1)[..., :, None] + (xy2 * xy2).sum(-1)[..., None, :] - 2.0 * torch.matmul(
        xy1, xy2.transpose(-1, -2))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    penalized = (dist.to(torch.float32) * (1.0 + d / max_jump)).to(torch.int16)
    dist = torch.where(d > max_jump, penalized, dist)
    dist = torch.where(valid2[..., None, :], dist, SENT16)
    best = dist.amin(dim=-1)
    best_idx = torch.argmin(dist, dim=-1)
    col = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.where(col == best_idx[..., None], SENT16, dist).amin(dim=-1)
    good = valid1 & (best < SENT16) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    return Matches(train_idx=torch.where(good, best_idx, -1), valid=good)
