"""Batched projective geometry primitives (port of ``tpuslam/common/geometry.py``).

The nullspace solver is the reference package's batched one-sided Jacobi on
the rows, with the same round-robin (tournament) schedule of disjoint column
pairs, so the sequence of rotations — and the float32 result up to summation
order — matches it.  Everything here is float32 with TF32 off.
"""

from __future__ import annotations

import torch


def _round_robin_schedule(n: int) -> list[list[tuple[int, int]]]:
    """Tournament rounds of disjoint column pairs covering all n(n−1)/2."""
    players: list[int | None] = list(range(n)) + ([None] if n % 2 else [])
    m = len(players)
    rounds = []
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = players[i], players[m - 1 - i]
            if a is not None and b is not None:
                pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def nullvec_jacobi(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Right singular vector of the smallest singular value, batched.

    One-sided Jacobi SVD on ``A`` (..., m, n): each round rotates its
    disjoint column pairs at once (Givens rotations accumulated into V).
    Working on A directly never squares the condition number, so float32
    stays accurate.
    """
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], n, n).clone()
    eps = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    schedule = [
        (
            torch.tensor([p for p, _ in r], device=A.device),
            torch.tensor([q for _, q in r], device=A.device),
        )
        for r in _round_robin_schedule(n)
    ]
    for _ in range(sweeps):
        for ps, qs in schedule:
            cp = A[..., ps]  # (..., m, G)
            cq = A[..., qs]
            app = torch.sum(cp * cp, dim=-2)  # (..., G)
            aqq = torch.sum(cq * cq, dim=-2)
            apq = torch.sum(cp * cq, dim=-2)
            # Jacobi rotations zeroing the (p, q) off-diagonals of AᵀA.
            tau = (aqq - app) / (2.0 * torch.where(apq.abs() < eps, eps, apq))
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(apq.abs() < eps * (app + aqq + eps), 0.0, t)
            c = (1.0 / torch.sqrt(1.0 + t * t)).unsqueeze(-2)
            s = t.unsqueeze(-2) * c
            A[..., ps] = c * cp - s * cq
            A[..., qs] = s * cp + c * cq
            vp = V[..., ps]
            vq = V[..., qs]
            V[..., ps] = c * vp - s * vq
            V[..., qs] = s * vp + c * vq
    norms = torch.linalg.vector_norm(A, dim=-2)  # (..., n) singular values
    idx = torch.argmin(norms, dim=-1)
    return torch.take_along_dim(V, idx[..., None, None], dim=-1)[..., 0]


def _normalize_rows(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    return a / torch.clamp_min(norm, eps)


def triangulate_homogeneous(
    P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
    sweeps: int = 8,
) -> torch.Tensor:
    """Batched two-view DLT triangulation → homogeneous 4-vectors.

    ``P1``/``P2``: (3, 4) or (..., 3, 4); ``pts1``/``pts2``: (..., N, 2).
    Returns (..., N, 4) homogeneous points (unit norm, sign unnormalised).
    """
    x1 = pts1[..., 0:1]
    y1 = pts1[..., 1:2]
    x2 = pts2[..., 0:1]
    y2 = pts2[..., 1:2]

    def rows(P, x, y):
        p0 = P[..., None, 0, :]  # (..., 1, 4)
        p1 = P[..., None, 1, :]
        p2 = P[..., None, 2, :]
        return x * p2 - p0, y * p2 - p1

    r0, r1 = rows(P1, x1, y1)
    r2, r3 = rows(P2, x2, y2)
    shape = torch.broadcast_shapes(r0.shape, r2.shape)
    A = torch.stack([r.expand(shape) for r in (r0, r1, r2, r3)], dim=-2)  # (..., N, 4, 4)
    A = _normalize_rows(A)
    # Column equilibration keeps the rotations balanced; v = S v' unscales.
    col_norm = torch.clamp_min(torch.linalg.vector_norm(A, dim=-2, keepdim=True), 1e-12)
    v = nullvec_jacobi(A / col_norm, sweeps=sweeps)
    v = v / col_norm[..., 0, :]
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-30)


def normalize_points(K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Pixel → normalised camera coordinates: (u-cx)/fx, (v-cy)/fy."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    x = (pts[..., 0] - cx[..., None]) / fx[..., None]
    y = (pts[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y], dim=-1)


def orthonormalize_rotation(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Newton iteration for the orthogonal polar factor: R ← R(3I − RᵀR)/2."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        RtR = torch.matmul(R.transpose(-1, -2), R)
        R = torch.matmul(R, 1.5 * eye - 0.5 * RtR)
    return R
