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


def fast_response_and_mask(
    images: torch.Tensor, threshold: int, contiguous: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) uint8 → (corner bool, score int32), each (B, H, W).

    Corners are masked to the 3-px interior; the score is the 16-neighbour
    SAD with zeros outside the image.
    """
    b, h, w = images.shape
    r = BORDER
    padded = F.pad(images.to(torch.int32), (r, r, r, r))

    def win(dy: int, dx: int) -> torch.Tensor:
        return padded[:, r + dy : r + dy + h, r + dx : r + dx + w]

    center = win(0, 0)
    lo = center - threshold
    hi = center + threshold
    bright_run = torch.zeros_like(center)
    dark_run = torch.zeros_like(center)
    seg = torch.zeros(center.shape, dtype=torch.bool, device=images.device)
    score = torch.zeros_like(center)
    card = {}
    # A wrap-around run of length `contiguous` starts at index ≤ 15, so it
    # ends by index 14 + contiguous; later steps only re-detect it.
    for i in range(min(2 * len(CIRCLE_OFFSETS), 15 + contiguous)):
        dx, dy = CIRCLE_OFFSETS[i % 16]
        nb = win(dy, dx)
        bright = nb > hi
        dark = nb < lo
        bright_run = torch.where(bright, bright_run + 1, 0)
        dark_run = torch.where(dark, dark_run + 1, 0)
        seg = seg | (bright_run >= contiguous) | (dark_run >= contiguous)
        if i < 16:
            score = score + (nb - center).abs()
            if i in (0, 4, 8, 12):
                card[i] = (bright, dark)
    nb4 = sum(card[c][0].to(torch.int32) for c in (0, 4, 8, 12))
    nd4 = sum(card[c][1].to(torch.int32) for c in (0, 4, 8, 12))
    first_pair = card[0][0] | card[0][1] | card[8][0] | card[8][1]
    pretest = first_pair & ((nb4 >= 3) | (nd4 >= 3))
    row = torch.arange(h, device=images.device)[:, None]
    col = torch.arange(w, device=images.device)[None, :]
    in_border = (row >= r) & (row < h - r) & (col >= r) & (col < w - r)
    return pretest & seg & in_border, score


def _packed_key(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int64 key = score (12 bits) << 20 | inverted raster index (20 bits).

    Larger key ⇔ (higher score, then smaller raster index); zero where
    masked.  Over 2^20 pixels the raster index is right-shifted, coarsening
    (not breaking) the tiebreak — the reference's rule.
    """
    h, w = score.shape[-2:]
    n = h * w
    shift = 0
    while (n >> shift) > (1 << _IDX_BITS) - 1:
        shift += 1
    idx = torch.arange(n, dtype=torch.int64, device=score.device).reshape(h, w)
    inv_idx = (n - 1 - idx) >> shift
    key = (score.to(torch.int64) << _IDX_BITS) | inv_idx
    return torch.where(mask, key, 0)


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
    tile = window
    n_tiles = -(-h // tile) * (-(-w // tile))
    if nms and tile >= 2 and n < (1 << _IDX_BITS) and n_tiles >= max_keypoints:
        pooled = _tile_max(key, tile)
        top_keys = torch.sort(pooled, dim=-1, descending=True, stable=True).values
        top_keys = top_keys[:, :max_keypoints]
        top_idx = n - 1 - (top_keys & ((1 << _IDX_BITS) - 1))
    else:
        flat = key.reshape(b, n)
        top_keys, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        top_keys = top_keys[:, :max_keypoints]
        top_idx = top_idx[:, :max_keypoints]
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
