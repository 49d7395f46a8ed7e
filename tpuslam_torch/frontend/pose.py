"""Two-view relative pose: batched-RANSAC essential matrix + cheirality vote.

Port of ``tpuslam/frontend/pose.py`` (8-point path), batched over a
leading frame-pair dimension.  All H minimal samples are solved at once by
the 3-sweep Jacobi nullvector, scored by kernel 4 (MSAC, ``csrc/pose.cu``),
the best L=4 refined by three annealed LO rounds (16× → 4× → 1× the
threshold), the winner projected onto the essential manifold, and [R|t]
picked by the cheirality vote over 256 inliers.

Sampling: ``draws`` are the (B, H, S) ranks among each pair's valid
matches that the reference package draws with ``jax.random.randint``; a
caller (a test) may pass JAX's own.  Otherwise they come from the caller's
``torch.Generator`` as ``floor(u · n_valid)``, with no host sync.

Ties resolve as ``lax.top_k`` resolves them (lowest index first), through
stable sorts.  ``SampleSize: 5`` (the five-point solver) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.common.geometry import (
    normalize_points,
    nullvec_jacobi,
    orthonormalize_rotation,
    triangulate_homogeneous,
)
from tpuslam_torch.kernels.pose import build_msac_operand, msac_scores


class PoseResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3) unit norm
    E: torch.Tensor  # (B, 3, 3)
    inliers: torch.Tensor  # (B, M) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor  # (B,) bool


def _W(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=like.dtype, device=like.device
    )


def _eight_point_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Epipolar rows x2ᵀ E x1 = 0 with E row-major: (..., N, 2) → (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Snap (..., 3, 3) onto the essential manifold: singular values → (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.matmul(u * s, vt)


def _solve_e_from_rows(
    rows: torch.Tensor,
    weights: torch.Tensor | None = None,
    project: bool = True,
    sweeps: int = 5,
) -> torch.Tensor:
    """Least-squares essential matrix from (..., N, 9) rows (optional (..., N) weights)."""
    if weights is not None:
        rows = rows * weights[..., None]
    e = nullvec_jacobi(rows, sweeps=sweeps)
    E = e.reshape(*e.shape[:-1], 3, 3)
    return _project_essential(E) if project else E


def sampson_error_sq(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, with_denom: bool = False):
    """Squared Sampson distance: E (B, L, 3, 3), x1/x2 (B, N, 2) → (B, L, N)."""
    ones = torch.ones_like(x1[..., :1])
    x1h = torch.cat([x1, ones], dim=-1)
    x2h = torch.cat([x2, ones], dim=-1)
    Ex1 = torch.einsum("blij,bnj->blni", E, x1h)
    Etx2 = torch.einsum("blji,bnj->blni", E, x2h)
    err = (x2h[:, None] * Ex1).sum(dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    e2 = err**2 / torch.clamp_min(denom, 1e-18)
    return (e2, denom) if with_denom else e2


def decompose_essential(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E (..., 3, 3) → (R1, R2, t): R1 = U W Vᵀ, R2 = U Wᵀ Vᵀ (det-corrected), t = U[:, 2]."""
    u, _, vt = torch.linalg.svd(E)
    W = _W(E)
    R1 = torch.matmul(torch.matmul(u, W), vt)
    R2 = torch.matmul(torch.matmul(u, W.T), vt)
    R1 = torch.where(torch.linalg.det(R1)[..., None, None] < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2)[..., None, None] < 0, -R2, R2)
    R1 = orthonormalize_rotation(R1)
    R2 = orthonormalize_rotation(R2)
    t = u[..., :, 2]
    t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-12)
    return R1, R2, t


def cheirality_votes(
    Rs: torch.Tensor, ts: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """(B, 4) count of points in front of both cameras for each [R|t] candidate."""
    B, C = Rs.shape[:2]
    N = x1.shape[-2]
    P1 = torch.cat(
        [torch.eye(3, dtype=Rs.dtype, device=Rs.device), torch.zeros((3, 1), dtype=Rs.dtype, device=Rs.device)],
        dim=1,
    )
    P2 = torch.cat([Rs, ts[..., :, None]], dim=-1)  # (B, 4, 3, 4)
    Xh = triangulate_homogeneous(
        P1, P2, x1[:, None].expand(B, C, N, 2), x2[:, None].expand(B, C, N, 2), sweeps=4
    )  # (B, 4, N, 4)
    w = Xh[..., 3]
    w_safe = torch.where(w.abs() < 1e-12, 1e-12, w)
    z1 = Xh[..., 2] / w_safe
    X2 = torch.einsum("bcij,bcnj->bcni", P2, Xh / w_safe[..., None])
    front = (z1 > 0) & (X2[..., 2] > 0) & valid[:, None, :]
    return front.sum(dim=-1)


def draw_ranks(
    n_valid: torch.Tensor, num_hypotheses: int, sample_size: int, generator: torch.Generator | None
) -> torch.Tensor:
    """(B, H, S) uniform ranks in [0, max(n_valid, 1)) from ``generator``, on n_valid's device."""
    n = torch.clamp_min(n_valid, 1).to(torch.float32)[:, None, None]
    u = torch.rand(
        (n_valid.shape[0], num_hypotheses, sample_size),
        generator=generator, device=n_valid.device,
    )
    return torch.minimum(torch.floor(u * n), n - 1).to(torch.int64)


def estimate_relative_pose(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    draws: torch.Tensor | None = None,
    num_hypotheses: int = 2048,
    sample_size: int = 8,
    inlier_threshold_px: float = 1.0,
    min_matches: int = 8,
) -> PoseResult:
    """Batched-RANSAC two-view pose from matched pixel points.

    ``pts1``/``pts2``: (B, M, 2) float32; ``valid``: (B, M) bool; ``K``:
    (3, 3).  ``draws``: optional (B, H, S) ranks (see the module docstring).
    """
    if sample_size == 5:
        raise NotImplementedError("SampleSize: 5 (the five-point solver) is not ported yet")
    B, M = valid.shape
    dev = pts1.device
    dtype = torch.float32
    pts1 = pts1.to(dtype)
    pts2 = pts2.to(dtype)
    Kf = K.to(dtype=dtype, device=dev)
    n_valid = valid.sum(dim=-1)
    enough = n_valid >= min_matches
    x1 = normalize_points(Kf, pts1)
    x2 = normalize_points(Kf, pts2)

    # --- hypothesis sampling: ranks among the valid matches → match indices.
    valid_rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    arange_m = torch.arange(M, device=dev).expand(B, M)
    rank_to_idx = torch.zeros((B, M), dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(valid, valid_rank, M - 1), arange_m, "amax", include_self=True
    )
    if draws is None:
        draws = draw_ranks(n_valid, num_hypotheses, sample_size, generator)
    H, S = draws.shape[1:]
    sample_idx = torch.gather(rank_to_idx, 1, draws.to(dev, torch.int64).reshape(B, H * S))

    rows_all = _eight_point_rows(x1, x2)  # (B, M, 9)
    rows = torch.gather(rows_all, 1, sample_idx[..., None].expand(B, H * S, 9)).reshape(B, H, S, 9)
    E_hyp = _solve_e_from_rows(rows, project=False, sweeps=3)  # (B, H, 3, 3)

    # --- MSAC scores of every hypothesis (kernel 4).
    focal = 0.5 * (Kf[0, 0] + Kf[1, 1])
    thr = (inlier_threshold_px / focal) ** 2
    n_invalid = (~valid).sum(dim=-1, keepdim=True)
    P_op = build_msac_operand(x1, x2, valid, thr)
    msac = msac_scores(E_hyp.reshape(B, H, 9), P_op) + n_invalid

    # --- annealed LO-RANSAC from the best L hypotheses.
    L = min(4, H)
    top_h = torch.sort(msac, dim=-1, stable=True).indices[:, :L]
    E_cur = torch.gather(E_hyp, 1, top_h[..., None, None].expand(B, L, 3, 3))
    E_best_l = E_cur
    msac_best_l = torch.gather(msac, 1, top_h)
    rows_b = rows_all[:, None].expand(B, L, M, 9)
    for mult in (16.0, 4.0, 1.0):
        e2, den = sampson_error_sq(E_cur, x1, x2, with_denom=True)  # (B, L, M)
        w = torch.where((e2 < mult * thr) & valid[:, None], 1.0, 0.0)
        w = w / torch.sqrt(torch.clamp_min(den, 1e-18))
        E_new = _solve_e_from_rows(rows_b, w, project=False)
        e2_new = sampson_error_sq(E_new, x1, x2)
        msac_new = torch.where(
            valid[:, None], torch.clamp_max(e2_new / thr, 1.0), 0.0
        ).sum(dim=-1) + n_invalid
        better = msac_new < msac_best_l
        E_best_l = torch.where(better[..., None, None], E_new, E_best_l)
        msac_best_l = torch.where(better, msac_new, msac_best_l)
        E_cur = E_new
    best_l = torch.argmin(msac_best_l, dim=-1)
    batch = torch.arange(B, device=dev)
    E_best = _project_essential(E_best_l[batch, best_l])
    inliers = (sampson_error_sq(E_best[:, None], x1, x2)[:, 0] < thr) & valid

    # --- [R|t] by cheirality vote on (up to) 256 inliers.
    R1, R2, t = decompose_essential(E_best)
    Rs = torch.stack([R1, R2, R1, R2], dim=1)  # (B, 4, 3, 3)
    ts = torch.stack([t, t, -t, -t], dim=1)
    vote_n = min(256, M)
    if vote_n < M:
        vote_idx = torch.sort(inliers.to(torch.int32), dim=-1, descending=True, stable=True).indices
        vote_idx = vote_idx[:, :vote_n]
        xv1 = torch.gather(x1, 1, vote_idx[..., None].expand(B, vote_n, 2))
        xv2 = torch.gather(x2, 1, vote_idx[..., None].expand(B, vote_n, 2))
        vmask = torch.gather(inliers, 1, vote_idx)
    else:
        xv1, xv2, vmask = x1, x2, inliers
    votes = cheirality_votes(Rs, ts, xv1, xv2, vmask)
    best_c = torch.argmax(votes, dim=-1)
    R = Rs[batch, best_c]
    t = ts[batch, best_c]

    n_inl = inliers.sum(dim=-1, dtype=torch.int32)
    success = enough & (n_inl >= min_matches)
    eye = torch.eye(3, dtype=dtype, device=dev)
    return PoseResult(
        R=torch.where(success[:, None, None], R, eye),
        t=torch.where(success[:, None], t, 0.0),
        E=E_best,
        inliers=inliers & success[:, None],
        num_inliers=torch.where(success, n_inl, 0),
        success=success,
    )


def triangulate_matched_points(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> torch.Tensor:
    """Triangulate (B, M) matched pixels against P1 = K[I|0], P2 = K[R|t] → (B, M, 3).

    Solved in normalised coordinates for float32 conditioning (same optimum).
    """
    dtype = torch.float32
    Kf = K.to(dtype=dtype, device=pts1.device)
    x1 = normalize_points(Kf, pts1.to(dtype))
    x2 = normalize_points(Kf, pts2.to(dtype))
    P1 = torch.cat(
        [torch.eye(3, dtype=dtype, device=pts1.device), torch.zeros((3, 1), dtype=dtype, device=pts1.device)],
        dim=1,
    )
    P2 = torch.cat([R.to(dtype), t.to(dtype)[..., :, None]], dim=-1)  # (B, 3, 4)
    Xh = triangulate_homogeneous(P1, P2, x1, x2)
    w = Xh[..., 3:4]
    w_safe = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12), w)
    return Xh[..., :3] / w_safe
