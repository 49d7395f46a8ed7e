"""Brute-force descriptor matching with spatial-jump penalty and ratio test.

Port of ``tpuslam/frontend/matcher.py::match_descriptors`` and
``penalized_distance_matrix``, batched over frame pairs.  Same layout as
the reference package: int16 distances (the largest penalised distance,
256·(1 + diag/500), stays far below 32767), the second best from an
equality-masked min, and the pixel distance d² from the norm expansion,
whose cross term is a float32 matmul with TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.common.hamming import hamming_matrix

_SENT16 = 32767  # int16 sentinel: larger than any real (penalised) distance


class MatchSet(NamedTuple):
    """Fixed-capacity match buffer; every field has shape (..., M)."""

    query_idx: torch.Tensor  # int64
    train_idx: torch.Tensor  # int64
    distance: torch.Tensor  # float32 (penalised int distance)
    valid: torch.Tensor  # bool


def penalized_distance_matrix(
    dist: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor, max_jump_radius: float
) -> torch.Tensor:
    """dist ← int(dist · (1 + d/R)) where pixel distance d > R (truncation toward 0)."""
    cross = torch.matmul(xy1, xy2.transpose(-1, -2))
    d2 = (
        (xy1 * xy1).sum(dim=-1)[..., :, None]
        + (xy2 * xy2).sum(dim=-1)[..., None, :]
        - 2.0 * cross
    )
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    penalty = 1.0 + d / max_jump_radius
    penalized = (dist.to(torch.float32) * penalty).to(dist.dtype)
    return torch.where(d > max_jump_radius, penalized, dist)


def match_descriptors(
    desc1: torch.Tensor,
    desc2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    xy1: torch.Tensor | None = None,
    xy2: torch.Tensor | None = None,
    *,
    ratio_threshold: float = 0.5,
    max_jump_radius: float = 500.0,
    use_ratio_test: bool = True,
    filter_matches: bool = True,
    good_matches_count: int = 20,
    use_spatial_penalty: bool = True,
) -> MatchSet:
    """Match query (..., N1, D) against train (..., N2, D) descriptors.

    Invalid rows never match.  Output capacity is ``good_matches_count``
    when filtering, else N1.  Ties resolve to the lowest index, as the
    reference package's ``argmin`` and ``top_k`` do.
    """
    n1 = desc1.shape[-2]
    dev = desc1.device
    dist = hamming_matrix(desc1, desc2).to(torch.int16)
    if use_spatial_penalty and xy1 is not None and xy2 is not None:
        dist = penalized_distance_matrix(dist, xy1, xy2, max_jump_radius)
    sent = torch.tensor(_SENT16, dtype=torch.int16, device=dev)
    dist = torch.where(valid2[..., None, :], dist, sent)

    best = dist.amin(dim=-1)
    best_idx = torch.argmin(dist, dim=-1)  # first occurrence
    col = torch.arange(dist.shape[-1], device=dev)
    second = torch.where(col == best_idx[..., None], sent, dist).amin(dim=-1)

    good = valid1 & (best < _SENT16)
    if use_ratio_test:
        good = good & (best.to(torch.float32) < ratio_threshold * second.to(torch.float32))
    query_idx = torch.arange(n1, device=dev).expand(good.shape)
    distance = best.to(torch.float32)
    inf = torch.tensor(float("inf"), device=dev)

    if not filter_matches:
        return MatchSet(
            query_idx=query_idx,
            train_idx=torch.where(good, best_idx, -1),
            distance=torch.where(good, distance, inf),
            valid=good,
        )

    # Global top-K by (distance asc, query_idx asc): integer distances
    # scaled by n1 plus the index make the packed key unique.
    k = min(good_matches_count, n1)
    packed = torch.where(good, distance * float(n1) + query_idx.to(torch.float32), inf)
    order = torch.sort(packed, dim=-1, stable=True).indices[..., :k]
    sel_valid = torch.gather(good, -1, order)
    return MatchSet(
        query_idx=torch.where(sel_valid, torch.gather(query_idx, -1, order), -1),
        train_idx=torch.where(sel_valid, torch.gather(best_idx, -1, order), -1),
        distance=torch.where(sel_valid, torch.gather(distance, -1, order), inf),
        valid=sel_valid,
    )
