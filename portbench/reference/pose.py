"""Reference two-view pose: the 8-point RANSAC with MSAC scores, annealed LO, cheirality vote, and
triangulation, in plain float32 torch.

The MSAC scores are the plain sum of truncated Sampson errors (the port
computes them in a CUDA kernel, summing over matches in another order),
so the hypothesis ranking may differ where two scores tie to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pose(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    inliers: torch.Tensor  # (B, M) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor  # (B,) bool


def _round_robin(n: int) -> list[list[tuple[int, int]]]:
    players: list[int | None] = list(range(n)) + ([None] if n % 2 else [])
    m = len(players)
    rounds = []
    for _ in range(m - 1):
        rounds.append([(min(a, b), max(a, b)) for i in range(m // 2)
                       if (a := players[i]) is not None and (b := players[m - 1 - i]) is not None])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def nullvec(A: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Right singular vector of the smallest singular value: one-sided Jacobi on A's columns, each
    round rotating disjoint pairs of a round-robin schedule."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], n, n).clone()
    eps = 1e-30
    schedule = [(torch.tensor([p for p, _ in r], device=A.device), torch.tensor([q for _, q in r], device=A.device))
                for r in _round_robin(n)]
    for _ in range(sweeps):
        for ps, qs in schedule:
            cp = A.index_select(-1, ps)
            cq = A.index_select(-1, qs)
            app = torch.sum(cp * cp, dim=-2)
            aqq = torch.sum(cq * cq, dim=-2)
            apq = torch.sum(cp * cq, dim=-2)
            tau = (aqq - app) / (2.0 * torch.where(apq.abs() < eps, eps, apq))
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
            t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
            t = torch.where(apq.abs() < eps * (app + aqq + eps), 0.0, t)
            c = (1.0 / torch.sqrt(1.0 + t * t)).unsqueeze(-2)
            s = t.unsqueeze(-2) * c
            A.index_copy_(-1, ps, c * cp - s * cq)
            A.index_copy_(-1, qs, s * cp + c * cq)
            vp = V.index_select(-1, ps)
            vq = V.index_select(-1, qs)
            V.index_copy_(-1, ps, c * vp - s * vq)
            V.index_copy_(-1, qs, s * vp + c * vq)
    idx = torch.argmin(torch.linalg.vector_norm(A, dim=-2), dim=-1)
    return torch.take_along_dim(V, idx[..., None, None], dim=-1)[..., 0]


def normalize(K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def triangulate_h(P1, P2, x1, x2, sweeps: int = 8) -> torch.Tensor:
    """Two-view DLT with row normalisation and column equilibration → unit homogeneous (..., N, 4)."""
    def rows(P, p):
        x, y = p[..., 0:1], p[..., 1:2]
        return x * P[..., None, 2, :] - P[..., None, 0, :], y * P[..., None, 2, :] - P[..., None, 1, :]

    r0, r1 = rows(P1, x1)
    r2, r3 = rows(P2, x2)
    shape = torch.broadcast_shapes(r0.shape, r2.shape)
    A = torch.stack([r.expand(shape) for r in (r0, r1, r2, r3)], dim=-2)
    A = A / torch.clamp_min(torch.linalg.vector_norm(A, dim=-1, keepdim=True), 1e-12)
    col = torch.clamp_min(torch.linalg.vector_norm(A, dim=-2, keepdim=True), 1e-12)
    v = nullvec(A / col, sweeps) / col[..., 0, :]
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-30)


def _orthonormalize(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        R = torch.matmul(R, 1.5 * eye - 0.5 * torch.matmul(R.transpose(-1, -2), R))
    return R


def _svd(E: torch.Tensor):
    finite = torch.isfinite(E).all(dim=(-2, -1), keepdim=True)
    u, s, vt = torch.linalg.svd(torch.where(finite, E, torch.eye(3, dtype=E.dtype, device=E.device)))
    return torch.where(finite, u, torch.nan), torch.where(finite[..., 0], s, torch.nan), torch.where(finite, vt, torch.nan)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    u, _, vt = _svd(E)
    return torch.matmul(u * torch.tensor((1.0, 1.0, 0.0), dtype=E.dtype, device=E.device), vt)


def _solve_e(rows: torch.Tensor, weights: torch.Tensor | None, sweeps: int) -> torch.Tensor:
    if weights is not None:
        rows = rows * weights[..., None]
    e = nullvec(rows, sweeps)
    return e.reshape(*e.shape[:-1], 3, 3)


def sampson_sq(E, x1, x2, with_denom: bool = False):
    ones = torch.ones_like(x1[..., :1])
    x1h = torch.cat([x1, ones], dim=-1)
    x2h = torch.cat([x2, ones], dim=-1)
    Ex1 = torch.einsum("blij,bnj->blni", E, x1h)
    Etx2 = torch.einsum("blji,bnj->blni", E, x2h)
    err = (x2h[:, None] * Ex1).sum(dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    e2 = err**2 / torch.clamp_min(denom, 1e-18)
    return (e2, denom) if with_denom else e2


def msac_scores(E_flat: torch.Tensor, x1, x2, valid, thr, operands: torch.dtype | None = None) -> torch.Tensor:
    """(B, H) Σ over valid matches of min(Sampson² / thr, 1), from the five 9-vector dot products of
    vec(E) with each match's terms, the nine products added in index order.  ``operands`` rounds E and
    the match terms to that type first (the products and sums stay float32, as tensor cores keep them):
    the control's lower precision."""
    ones = torch.ones((*x1.shape[:-1], 1), dtype=x1.dtype, device=x1.device)
    v = valid.to(x1.dtype)[..., None]
    x1h = torch.cat([x1, ones], dim=-1) * v
    x2h = torch.cat([x2, ones], dim=-1) * v
    scale = 1.0 / torch.sqrt(torch.as_tensor(thr, dtype=x1.dtype, device=x1.device))
    t9 = (x2h[..., :, None] * x1h[..., None, :]).reshape(*x1.shape[:-1], 9) * scale
    z = torch.zeros_like(x1h)
    a1 = torch.cat([x1h, z, z], dim=-1)
    a2 = torch.cat([z, x1h, z], dim=-1)
    b1 = torch.zeros((*x1.shape[:-1], 9), dtype=x1.dtype, device=x1.device)
    b2 = torch.zeros_like(b1)
    b1[..., 0::3] = x2h
    b2[..., 1::3] = x2h
    P = torch.cat([t9, a1, a2, b1, b2], dim=-2).transpose(-1, -2)  # (B, 9, 5M)
    if operands is not None:
        E_flat, P = E_flat.to(operands).float(), P.to(operands).float()
    m = P.shape[-1] // 5
    big = E_flat[..., 0, None] * P[:, None, 0, :]
    for i in range(1, 9):
        big = big + E_flat[..., i, None] * P[:, None, i, :]
    err, a1, a2, b1, b2 = (big[..., k * m : (k + 1) * m] for k in range(5))
    e2 = (err * err) / torch.clamp_min(a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2, 1e-18)
    return torch.clamp_max(e2, 1.0).sum(dim=-1)


def _decompose(E: torch.Tensor):
    u, _, vt = _svd(E)
    W = torch.tensor(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), dtype=E.dtype, device=E.device)
    R1 = torch.matmul(torch.matmul(u, W), vt)
    R2 = torch.matmul(torch.matmul(u, W.T), vt)
    R1 = _orthonormalize(torch.where(torch.linalg.det(R1)[..., None, None] < 0, -R1, R1))
    R2 = _orthonormalize(torch.where(torch.linalg.det(R2)[..., None, None] < 0, -R2, R2))
    t = u[..., :, 2]
    t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-12)
    return R1, R2, t


def _votes(Rs, ts, x1, x2, valid) -> torch.Tensor:
    B, C = Rs.shape[:2]
    N = x1.shape[-2]
    P1 = torch.cat([torch.eye(3, dtype=Rs.dtype, device=Rs.device), torch.zeros((3, 1), dtype=Rs.dtype, device=Rs.device)], 1)
    P2 = torch.cat([Rs, ts[..., :, None]], dim=-1)
    Xh = triangulate_h(P1, P2, x1[:, None].expand(B, C, N, 2), x2[:, None].expand(B, C, N, 2), sweeps=4)
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    X2 = torch.einsum("bcij,bcnj->bcni", P2, Xh / w[..., None])
    return ((Xh[..., 2] / w > 0) & (X2[..., 2] > 0) & valid[:, None, :]).sum(dim=-1)


def draw_ranks(n_valid: torch.Tensor, H: int, S: int, generator: torch.Generator) -> torch.Tensor:
    """(B, H, S) ranks floor(u · n) among the valid matches, u uniform from ``generator``."""
    n = torch.clamp_min(n_valid, 1).to(torch.float32)[:, None, None]
    u = torch.rand((n_valid.shape[0], H, S), generator=generator, device=n_valid.device)
    return torch.minimum(torch.floor(u * n), n - 1).to(torch.int64)


def relative_pose(pts1, pts2, valid, K, draws, inlier_px: float, min_matches: int,
                  msac_operands: torch.dtype | None = None) -> Pose:
    """The 8-point RANSAC over ``draws`` (B, H, 8), its best four refined by three annealed LO rounds
    (16×, 4×, 1× the threshold), projected onto the essential manifold, [R|t] by cheirality."""
    B, M = valid.shape
    dev = pts1.device
    n_valid = valid.sum(dim=-1)
    x1, x2 = normalize(K, pts1), normalize(K, pts2)
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    rank_to_idx = torch.zeros((B, M), dtype=torch.int64, device=dev).scatter_reduce(
        1, torch.where(valid, rank, M - 1), torch.arange(M, device=dev).expand(B, M), "amax", include_self=True)
    H, S = draws.shape[1:]
    sample = torch.gather(rank_to_idx, 1, draws.reshape(B, H * S))
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    rows_all = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)
    rows = torch.gather(rows_all, 1, sample[..., None].expand(B, H * S, 9)).reshape(B, H, S, 9)
    E_hyp = _solve_e(rows, None, sweeps=3)

    focal = 0.5 * (K[0, 0] + K[1, 1])
    thr = (inlier_px / focal) ** 2
    n_invalid = (~valid).sum(dim=-1, keepdim=True)
    msac = msac_scores(E_hyp.reshape(B, H, 9), x1, x2, valid, thr, msac_operands) + n_invalid
    L = min(4, H)
    top = torch.sort(msac, dim=-1, stable=True).indices[:, :L]
    E_cur = torch.gather(E_hyp, 1, top[..., None, None].expand(B, L, 3, 3))
    E_best, s_best = E_cur, torch.gather(msac, 1, top)
    rows_b = rows_all[:, None].expand(B, L, M, 9)
    for mult in (16.0, 4.0, 1.0):
        e2, den = sampson_sq(E_cur, x1, x2, with_denom=True)
        w = torch.where((e2 < mult * thr) & valid[:, None], 1.0, 0.0) / torch.sqrt(torch.clamp_min(den, 1e-18))
        E_new = _solve_e(rows_b, w, sweeps=5)
        s_new = torch.where(valid[:, None], torch.clamp_max(sampson_sq(E_new, x1, x2) / thr, 1.0), 0.0).sum(-1) + n_invalid
        better = s_new < s_best
        E_best = torch.where(better[..., None, None], E_new, E_best)
        s_best = torch.where(better, s_new, s_best)
        E_cur = E_new
    batch = torch.arange(B, device=dev)
    E = _project_essential(E_best[batch, torch.argmin(s_best, dim=-1)])
    inliers = (sampson_sq(E[:, None], x1, x2)[:, 0] < thr) & valid

    R1, R2, t = _decompose(E)
    Rs, ts = torch.stack([R1, R2, R1, R2], dim=-3), torch.stack([t, t, -t, -t], dim=-2)
    n_vote = min(256, M)
    order = torch.sort(inliers.to(torch.int32), dim=-1, descending=True, stable=True).indices[:, :n_vote]
    votes = _votes(Rs, ts, torch.gather(x1, 1, order[..., None].expand(B, n_vote, 2)),
                   torch.gather(x2, 1, order[..., None].expand(B, n_vote, 2)), torch.gather(inliers, 1, order))
    best = torch.argmax(votes, dim=-1)
    n_inl = inliers.sum(dim=-1, dtype=torch.int32)
    ok = (n_valid >= min_matches) & (n_inl >= min_matches)
    return Pose(
        R=torch.where(ok[:, None, None], Rs[batch, best], torch.eye(3, dtype=x1.dtype, device=dev)),
        t=torch.where(ok[:, None], ts[batch, best], 0.0),
        inliers=inliers & ok[:, None],
        num_inliers=torch.where(ok, n_inl, 0),
        success=ok,
    )


def triangulate(K, R, t, pts1, pts2) -> torch.Tensor:
    """(B, M, 3) points in the first camera: P1 = [I|0], P2 = [R|t] in normalised coordinates."""
    x1, x2 = normalize(K, pts1), normalize(K, pts2)
    P1 = torch.cat([torch.eye(3, dtype=x1.dtype, device=x1.device), torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], 1)
    P2 = torch.cat([R, t[..., :, None]], dim=-1)
    Xh = triangulate_h(P1, P2, x1, x2)
    w = Xh[..., 3:4]
    w = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12), w)
    return Xh[..., :3] / w
