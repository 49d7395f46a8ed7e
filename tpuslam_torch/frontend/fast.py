"""FAST corners, packed-key NMS and tile-pooled top-k (port of ``tpuslam/frontend/fast.py``).

``fast_response_and_mask`` is the plain twin of the FAST half of kernel 1
(``tpuslam_torch/csrc/frontend.cu``): it evaluates the same wrap-around
bright/dark run counters over ``15 + contiguous`` circle steps, on a
zero-padded image, so corner mask and score agree with the kernel at every
pixel (and with the reference package's corners everywhere and its score
wherever there is a corner — the only place the score is read).

Torch has no uint32 shift, max or top-k, so the packed
``score << 20 | inverted raster index`` key is carried in int64; every key
fits in 32 bits, so comparisons are the reference's uint32 comparisons.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

# Bresenham circle offsets as (dx, dy), index 0 at 12 o'clock, clockwise.
CIRCLE_OFFSETS: tuple[tuple[int, int], ...] = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
BORDER = 3
_SCORE_BITS = 12  # max SAD = 16*255 = 4080 < 2^12
_IDX_BITS = 32 - _SCORE_BITS


class KeypointSet(NamedTuple):
    """Fixed-capacity keypoint buffer; every field has shape (..., K)."""

    xy: torch.Tensor  # (..., K, 2) float32 — (x, y) pixel coordinates
    response: torch.Tensor  # (..., K) float32 — FAST SAD score
    angle: torch.Tensor  # (..., K) float32 — orientation in degrees
    valid: torch.Tensor  # (..., K) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1, dtype=torch.int32)


def _mask_run(mask: torch.Tensor, run: int) -> torch.Tensor:
    """AND of ``run`` consecutive circle entries (dim 0, wrapping) starting at each position.

    The reference's segment test; :func:`fast_response_and_mask` computes
    the same segments with run counters (kernel 1's formulation), and the
    tests hold the two against each other.
    """
    acc = mask
    length = 1
    while length * 2 <= run:
        acc = acc & torch.roll(acc, -length, dims=0)
        length *= 2
    while length < run:
        acc = acc & torch.roll(mask, -length, dims=0)
        length += 1
    return acc


def fast_response_and_mask(
    images: torch.Tensor, threshold: int, contiguous: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) uint8 → (corner bool, score int32), each (B, H, W).

    Corners are masked to the 3-px interior; the score is the 16-neighbour
    SAD with zeros outside the image.  For a threshold ≥ 0 the tests run on
    uint8 against bounds saturated to [0, 255] (a bound past the range can
    never fire, clamped or not), so every pass reads one byte a pixel; a
    negative threshold widens them to int16.
    """
    b, h, w = images.shape
    r = BORDER
    work = images if threshold >= 0 else images.to(torch.int16)
    padded = F.pad(work, (r, r, r, r))

    def win(dy: int, dx: int) -> torch.Tensor:
        return padded[:, r + dy : r + dy + h, r + dx : r + dx + w]

    center = win(0, 0)
    wide = center.to(torch.int16)
    lo = (wide - threshold).clamp_(0, 255).to(work.dtype) if threshold >= 0 else wide - threshold
    hi = (wide + threshold).clamp_(0, 255).to(work.dtype) if threshold >= 0 else wide + threshold
    bright_run = torch.zeros_like(center)  # run lengths reach at most 31
    dark_run = torch.zeros_like(center)
    seg = torch.zeros(center.shape, dtype=torch.bool, device=images.device)
    score = torch.zeros(center.shape, dtype=torch.int16, device=images.device)  # at most 16 · 255
    card = {}
    # A wrap-around run of length `contiguous` starts at index ≤ 15, so it
    # ends by index 14 + contiguous; later steps only re-detect it.
    for i in range(min(2 * len(CIRCLE_OFFSETS), 15 + contiguous)):
        dx, dy = CIRCLE_OFFSETS[i % 16]
        nb = win(dy, dx)
        bright = nb > hi
        dark = nb < lo
        bright_run.add_(1).mul_(bright)
        dark_run.add_(1).mul_(dark)
        if i + 1 >= contiguous:  # no run is that long before
            seg |= bright_run >= contiguous
            seg |= dark_run >= contiguous
        if i < 16:
            score += torch.maximum(nb, center) - torch.minimum(nb, center)
            if i in (0, 4, 8, 12):
                card[i] = (bright, dark)
    nb4 = sum(card[c][0].to(torch.int8) for c in (0, 4, 8, 12))
    nd4 = sum(card[c][1].to(torch.int8) for c in (0, 4, 8, 12))
    first_pair = card[0][0] | card[0][1] | card[8][0] | card[8][1]
    pretest = first_pair & ((nb4 >= 3) | (nd4 >= 3))
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    in_border = (row >= r) & (row < h - r) & (col >= r) & (col < w - r)
    return pretest & seg & in_border, score.to(torch.int32)


def _packed_key(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int64 key = score (12 bits) << 20 | inverted raster index (20 bits).

    Larger key ⇔ (higher score, then smaller raster index); zero where
    masked.  Over 2^20 pixels the raster index is right-shifted, coarsening
    (not breaking) the tiebreak — the reference's rule.
    """
    h, w = score.shape[-2:]
    n = h * w
    idx = torch.arange(n, dtype=torch.int64, device=score.device).reshape(h, w)
    inv_idx = (n - 1 - idx) >> idx_shift(n)
    key = (score.to(torch.int64) << _IDX_BITS) | inv_idx
    return torch.where(mask, key, 0)


def idx_shift(n: int) -> int:
    """Right shift that fits the raster index of an ``n``-pixel plane in the key's 20 bits."""
    shift = 0
    while (n >> shift) > (1 << _IDX_BITS) - 1:
        shift += 1
    return shift


def _window_max(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Max over a centred ``size``-wide window along ``dim`` (SAME padding with 0).

    Exact for int64: running maxima over doubling lengths, then two
    overlapping power-of-two windows cover each ``size`` window.
    """
    half = (size - 1) // 2
    n = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [half, size - 1 - half]
    xp = F.pad(x, pad)
    length = 1
    run = xp
    while length * 2 <= size:
        run = torch.maximum(run.narrow(dim, 0, run.shape[dim] - length),
                            run.narrow(dim, length, run.shape[dim] - length))
        length *= 2
    # run[i] = max(xp[i : i + length]); combine [i, i+L) and [i+size-L, i+size)
    return torch.maximum(run.narrow(dim, 0, n), run.narrow(dim, size - length, n))


def local_max_nms(corner: torch.Tensor, score: torch.Tensor, window: int) -> torch.Tensor:
    """Windowed local-max NMS with deterministic tiebreak.

    A corner survives iff its packed key is the maximum over the
    (2·window−1)² neighbourhood (separable: rows, then columns).
    """
    key = _packed_key(score, corner)
    size = 2 * max(window - 1, 0) + 1
    pooled = _window_max(_window_max(key, size, -2), size, -1)
    return corner & (key == pooled) & (key > 0)


def _tile_max(key: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, H, W) → (B, ⌈H/tile⌉·⌈W/tile⌉) max over non-overlapping tiles (zero pad)."""
    b, h, w = key.shape
    padded = F.pad(key, (0, (-w) % tile, 0, (-h) % tile))
    th, tw = padded.shape[1] // tile, padded.shape[2] // tile
    return padded.reshape(b, th, tile, tw, tile).amax(dim=(2, 4)).reshape(b, th * tw)


def select_keypoints(
    corner: torch.Tensor,
    score: torch.Tensor,
    *,
    nms: bool = True,
    window: int = 12,
    max_keypoints: int = 1024,
) -> KeypointSet:
    """NMS + top-k from (B, H, W) corner mask and score map → batched KeypointSet.

    With NMS on, the top-k runs over per-tile maxima instead of every pixel
    — exactly: each ``window``-sized tile holds at most one survivor, whose
    key is its tile max, so positions come back from the key's raster index.
    Ties never occur among nonzero keys (they are unique); the stable
    descending sort puts equal keys lowest index first, as ``lax.top_k``.
    """
    keep = local_max_nms(corner, score, window) if nms else corner
    b, h, w = corner.shape
    n = h * w
    key = _packed_key(score, keep)
    if nms and tile_pool_exact(h, w, window, max_keypoints):
        return select_from_key(key, window=window, max_keypoints=max_keypoints)
    top_keys, top_idx = torch.sort(key.reshape(b, n), dim=-1, descending=True, stable=True)
    return _keypoints_from_top(top_keys[:, :max_keypoints], top_idx[:, :max_keypoints], w)


def tile_pool_exact(h: int, w: int, window: int, max_keypoints: int) -> bool:
    """Whether the tile-pooled top-k is exact on an (h, w) post-NMS key plane.

    Needs tiles of at least 2 px, an unshifted raster index in the key
    (``h·w < 2^20``) and at least ``max_keypoints`` tiles.
    """
    n_tiles = -(-h // window) * (-(-w // window))
    return window >= 2 and h * w < (1 << _IDX_BITS) and n_tiles >= max_keypoints


def select_from_key(key: torch.Tensor, *, window: int, max_keypoints: int) -> KeypointSet:
    """Top-k keypoints from a (B, H, W) int64 post-NMS packed-key plane.

    ``key`` is ``_packed_key(score, keep)`` with NMS and the border rule
    already applied (kernel 5 emits exactly this).  The caller ensures
    :func:`tile_pool_exact`; positions come back from the key's raster index.
    """
    n = key.shape[-2] * key.shape[-1]
    pooled = _tile_max(key, window)
    top_keys = torch.sort(pooled, dim=-1, descending=True, stable=True).values[:, :max_keypoints]
    top_idx = n - 1 - (top_keys & ((1 << _IDX_BITS) - 1))
    return _keypoints_from_top(top_keys, top_idx, key.shape[-1])


def detect_keypoints(
    image: torch.Tensor,
    *,
    threshold: int,
    contiguous: int,
    nms: bool = True,
    window: int = 12,
    max_keypoints: int = 1024,
) -> KeypointSet:
    """FAST on one (H, W) uint8 image → a (K,) score-sorted KeypointSet.

    Corners and scores come from kernel 1 at B = 1 (its plain twin on a CPU
    tensor); its blur is not used.
    """
    from tpuslam_torch.frontend.brief import gaussian_kernel
    from tpuslam_torch.kernels.frontend import fused_frontend_batch

    taps = torch.from_numpy(gaussian_kernel().astype("float32"))
    _, corner, score = fused_frontend_batch(
        image[None].contiguous(), threshold=threshold, contiguous=contiguous, taps=taps
    )
    kps = select_keypoints(corner, score, nms=nms, window=window, max_keypoints=max_keypoints)
    return KeypointSet(*(f[0] for f in kps))


def _keypoints_from_top(top_keys: torch.Tensor, top_idx: torch.Tensor, w: int) -> KeypointSet:
    """(B, K) sorted keys and their raster indices → KeypointSet (zero where invalid)."""
    valid = top_keys > 0
    y = (top_idx // w).to(torch.float32)
    x = (top_idx % w).to(torch.float32)
    resp = (top_keys >> _IDX_BITS).to(torch.float32)
    return KeypointSet(
        xy=torch.where(valid[..., None], torch.stack([x, y], dim=-1), 0.0),
        response=torch.where(valid, resp, 0.0),
        angle=torch.zeros(resp.shape, dtype=torch.float32, device=resp.device),
        valid=valid,
    )
