"""Camera pose from 3D↔2D correspondences: batched RANSAC DLT-PnP and motion-model PnP.

Port of ``tpuslam/backend/pnp.py``.  ``ransac_pnp`` solves all hypotheses
at once as one batched 12-column nullspace problem (one-sided Jacobi),
scores every (hypothesis, match) reprojection error in one pass and
refits the best consensus set; ``motion_pnp`` descends from a motion prior
by Huber-reweighted Gauss-Newton.  Float32 throughout, TF32 off.

Two deliberate deviations of the reference from the C++ it follows are
kept: the DLT solution maps *row-major* into P (as its rows are built),
and the translation is rescaled by ``s = ‖R_raw‖_F / √3`` (the mean
singular value) so it has metric scale.

Sampling: ``ransac_pnp`` takes its (H, 6) sample indices, or draws them
as the reference does — Gumbel noise over the valid matches and an
iterated argmax, i.e. six distinct valid matches a hypothesis — from an
explicit ``torch.Generator``.  With fewer than six valid matches the argmax
of an all −inf row picks index 0, as in the reference; such a solve never
succeeds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.common.geometry import hat, nullvec_jacobi, orthonormalize_rotation, so3_exp

_SQRT3 = 3.0 ** 0.5


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (M,) bool
    num_inliers: torch.Tensor  # () int32
    success: torch.Tensor  # () bool


def _dlt_rows(points3d: torch.Tensor, points2d: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) + (..., N, 2) → (..., 2N, 12) DLT rows, p = row-major vec(P).

    Per point: [X Y Z 1  0 0 0 0  −uX −uY −uZ −u] and [0 0 0 0  X Y Z 1  −vX −vY −vZ −v].
    """
    Xh = torch.cat([points3d, torch.ones_like(points3d[..., :1])], dim=-1)  # (..., N, 4)
    u = points2d[..., 0:1]
    v = points2d[..., 1:2]
    zero = torch.zeros_like(Xh)
    row_u = torch.cat([Xh, zero, -u * Xh], dim=-1)
    row_v = torch.cat([zero, Xh, -v * Xh], dim=-1)
    rows = torch.stack([row_u, row_v], dim=-2)  # (..., N, 2, 12)
    return rows.reshape(*rows.shape[:-3], -1, 12)


def solve_pnp_dlt(
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    weights: torch.Tensor | None = None,
    sweeps: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares DLT PnP → (R (..., 3, 3), t (..., 3)).

    ``points2d`` are normalised camera coordinates (the caller applies K⁻¹),
    so the solution is [R|t] itself.
    """
    rows = _dlt_rows(points3d, points2d)
    if weights is not None:
        rows = rows * torch.repeat_interleave(weights, 2, dim=-1)[..., None]
    norm = torch.clamp_min(torch.linalg.vector_norm(rows, dim=-1, keepdim=True), 1e-12)
    p = nullvec_jacobi(rows / norm, sweeps=sweeps)  # (..., 12)
    P = p.reshape(*p.shape[:-1], 3, 4)
    R_raw = P[..., :3]
    t_raw = P[..., 3]
    # The projective sign that gives det(R) > 0.
    sign = torch.sign(torch.linalg.det(R_raw))[..., None, None]
    sign = torch.where(sign == 0, 1.0, sign)
    R_raw = R_raw * sign
    t_raw = t_raw * sign[..., 0]
    s = torch.linalg.vector_norm(R_raw, dim=(-2, -1), keepdim=True) / _SQRT3
    s = torch.clamp_min(s, 1e-12)
    R = orthonormalize_rotation(R_raw / s, iters=4)
    return R, t_raw / s[..., 0]


def reprojection_errors(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, points3d: torch.Tensor, points2d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., M) pixel reprojection error ‖uv − π(K(RX + t))‖ and camera-frame depth."""
    cam = torch.matmul(points3d, R.transpose(-1, -2)) + t[..., None, :]
    z = cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-12, 1e-12, z)
    pix = torch.matmul(cam / z_safe[..., None], K.transpose(-1, -2))
    err = torch.linalg.vector_norm(pix[..., :2] - points2d, dim=-1)
    return err, z


def _gn_system(
    Xc: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, inv_z: torch.Tensor
) -> torch.Tensor:
    """(..., M, 2, 6) Jacobian of the pixel projection under T ← Exp(ξ)·T, ξ = (v, w)."""
    zero = torch.zeros_like(inv_z)
    du = torch.stack([fx[..., None] * inv_z, zero, -fx[..., None] * Xc[..., 0] * inv_z**2], dim=-1)
    dv = torch.stack([zero, fy[..., None] * inv_z, -fy[..., None] * Xc[..., 1] * inv_z**2], dim=-1)
    dpi = torch.stack([du, dv], dim=-2)  # (..., M, 2, 3)
    eye3 = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(*Xc.shape[:-1], 3, 3)
    dXc = torch.cat([eye3, -hat(Xc)], dim=-1)  # (..., M, 3, 6)
    return torch.matmul(dpi, dXc)


def _gn_step(J: torch.Tensor, w: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One damped Gauss-Newton step (..., 6); a non-finite step becomes 0.

    The 6×6 solve skips torch's singularity check (a host sync on the card):
    a singular system gives a non-finite step, which is zeroed as in the
    reference.
    """
    Jw = J * w[..., None, None]
    H = torch.einsum("...mij,...mik->...jk", Jw, J)
    g = torch.einsum("...mij,...mi->...j", Jw, r)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    H = H + (1e-6 * diag + 1e-8)[..., None] * eye6
    step = -torch.linalg.solve_ex(H, g[..., None], check_errors=False)[0][..., 0]
    return torch.where(torch.isfinite(step).all(dim=-1, keepdim=True), step, 0.0)


def _apply_step(R: torch.Tensor, t: torch.Tensor, step: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dR = so3_exp(step[..., 3:])
    return torch.matmul(dR, R), torch.matmul(dR, t[..., None])[..., 0] + step[..., :3]


def refine_pnp_gn(
    K: torch.Tensor,
    R0: torch.Tensor,  # (..., 3, 3) world→cam
    t0: torch.Tensor,  # (..., 3)
    points3d: torch.Tensor,  # (..., M, 3)
    points2d: torch.Tensor,  # (..., M, 2) pixels
    weights: torch.Tensor,  # (..., M)
    iters: int = 3,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton polish of a pose on the weighted pixel reprojection error."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    R, t = R0, t0
    for _ in range(iters):
        Xc = torch.matmul(points3d, R.transpose(-1, -2)) + t[..., None, :]
        z = Xc[..., 2]
        behind = z <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, z)
        w = torch.where(behind, 0.0, weights).to(points3d.dtype)
        pix = torch.matmul(Xc * inv_z[..., None], K.transpose(-1, -2))
        r = pix[..., :2] - points2d
        R, t = _apply_step(R, t, _gn_step(_gn_system(Xc, fx, fy, inv_z), w, r))
    return R, t


def motion_pnp(
    K: torch.Tensor,
    R0: torch.Tensor,  # (3, 3) world→cam seed
    t0: torch.Tensor,  # (3,)
    points3d: torch.Tensor,  # (M, 3) world
    points2d: torch.Tensor,  # (M, 2) pixels
    valid: torch.Tensor,  # (M,) bool
    *,
    iters: int = 4,
    reproj_threshold: float = 2.0,
    min_inliers: int = 5,
    huber_schedule: tuple[float, ...] = (16.0, 8.0, 4.0, 2.0),
) -> PnPResult:
    """Seeded robust pose tracking: Huber-IRLS Gauss-Newton from a motion prior.

    ``iters`` rounds, each one residual/Jacobian pass over the points and a
    6×6 solve, the Huber width annealed along ``huber_schedule``; then the
    inliers at ``reproj_threshold`` and z > 0.  Success needs
    ``min_inliers`` and a finite pose; failure returns the identity.
    """
    X = points3d.float()
    uv = points2d.float()
    Kf = K.float()
    R, t = R0.float(), t0.float()
    vf = valid.float()
    fx, fy = Kf[0, 0], Kf[1, 1]
    for i in range(iters):
        delta = huber_schedule[min(i, len(huber_schedule) - 1)]
        Xc = X @ R.T + t
        z = Xc[:, 2]
        behind = z <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, z)
        pix = (Xc * inv_z[:, None]) @ Kf.T
        r = pix[:, :2] - uv
        err = torch.linalg.vector_norm(r, dim=-1)
        # Huber weight: 1 inside the width, δ/|r| outside; cheirality and validity zero the rest.
        w = vf * torch.where(~behind, torch.clamp_max(delta / torch.clamp_min(err, 1e-9), 1.0), 0.0)
        R, t = _apply_step(R, t, _gn_step(_gn_system(Xc, fx, fy, inv_z), w, r))

    err, z = reprojection_errors(Kf, R, t, X, uv)
    inliers = (err < reproj_threshold) & (z > 0) & valid
    count = inliers.sum(dtype=torch.int32)
    finite = torch.isfinite(R).all() & torch.isfinite(t).all()
    success = (count >= min_inliers) & finite
    return PnPResult(
        R=torch.where(success, R, torch.eye(3, device=R.device)),
        t=torch.where(success, t, 0.0),
        inliers=inliers & success,
        num_inliers=torch.where(success, count, 0),
        success=success,
    )


def gumbel_top_indices(u: torch.Tensor, valid: torch.Tensor, sample_size: int) -> torch.Tensor:
    """(..., H, S) indices from (..., H, M) uniforms: S distinct valid matches a row, by Gumbel top-S.

    The top-S is an iterated argmax (the first index wins a tie, as in the
    reference); ``valid`` is (..., M).
    """
    g = -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    g = torch.where(valid[..., None, :], g, -torch.inf)
    iota = torch.arange(g.shape[-1], device=g.device)
    cols = []
    for _ in range(sample_size):
        i = torch.argmax(g, dim=-1)
        cols.append(i)
        g = torch.where(iota == i[..., None], -torch.inf, g)
    return torch.stack(cols, dim=-1)


def gumbel_sample_indices(
    valid: torch.Tensor, num_hypotheses: int, sample_size: int, generator: torch.Generator | None
) -> torch.Tensor:
    """(H, S) indices: S distinct valid matches a hypothesis, from ``generator``'s noise on ``valid``'s device."""
    u = torch.rand((num_hypotheses, valid.shape[0]), generator=generator, device=valid.device)
    return gumbel_top_indices(u, valid, sample_size)


def ransac_pnp(
    points3d: torch.Tensor,
    points2d: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    sample_idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    *,
    num_hypotheses: int = 128,
    sample_size: int = 6,
    reproj_threshold: float = 2.0,
    min_inliers: int = 5,
    solver_sweeps: int = 8,
    hyp_sweeps: int | None = None,
    lo_rounds: int = 2,
    refine: str = "dlt",
) -> PnPResult:
    """Batched-RANSAC DLT PnP over (M,) correspondences.

    ``points3d``: (M, 3) world; ``points2d``: (M, 2) pixels; ``valid``:
    (M,) bool; ``K``: (3, 3).  ``sample_idx``: optional (H, S) match
    indices, else drawn from ``generator``.  ``hyp_sweeps`` (default
    ``solver_sweeps``) bounds the hypotheses' Jacobi sweeps only.
    ``refine``: the LO refit, ``"dlt"`` (weighted DLT) or ``"gn"``
    (Gauss-Newton on the pixel residual); a refit is kept when it has at
    least as many inliers.
    """
    X = points3d.float()
    uv = points2d.float()
    Kf = K.float()
    fx, fy = Kf[0, 0], Kf[1, 1]
    cx, cy = Kf[0, 2], Kf[1, 2]
    xn = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], dim=-1)

    if sample_idx is None:
        sample_idx = gumbel_sample_indices(valid, num_hypotheses, sample_size, generator)
    sample_idx = sample_idx.to(device=X.device, dtype=torch.int64)
    R_h, t_h = solve_pnp_dlt(
        X[sample_idx], xn[sample_idx], sweeps=solver_sweeps if hyp_sweeps is None else hyp_sweeps
    )  # (H, 3, 3), (H, 3)

    err, z = reprojection_errors(Kf, R_h, t_h, X, uv)  # (H, M)
    inlier_mat = (err < reproj_threshold) & (z > 0) & valid[None, :]
    counts = inlier_mat.sum(dim=-1, dtype=torch.int32)
    best_h = torch.argmax(counts).reshape(1)  # an index tensor: no host sync on the card
    R_best = R_h.index_select(0, best_h)[0]
    t_best = t_h.index_select(0, best_h)[0]
    inliers = inlier_mat.index_select(0, best_h)[0]
    best_count = counts.index_select(0, best_h)[0]
    for _ in range(lo_rounds):
        w = inliers.float()
        if refine == "gn":
            R_ref, t_ref = refine_pnp_gn(Kf, R_best, t_best, X, uv, w, iters=3)
        else:
            R_ref, t_ref = solve_pnp_dlt(X, xn, weights=w, sweeps=solver_sweeps)
        err_r, z_r = reprojection_errors(Kf, R_ref, t_ref, X, uv)
        inl_r = (err_r < reproj_threshold) & (z_r > 0) & valid
        cnt_r = inl_r.sum(dtype=torch.int32)
        better = cnt_r >= best_count
        R_best = torch.where(better, R_ref, R_best)
        t_best = torch.where(better, t_ref, t_best)
        inliers = torch.where(better, inl_r, inliers)
        best_count = torch.where(better, cnt_r, best_count)

    n_valid = valid.sum(dtype=torch.int32)
    success = (best_count >= min_inliers) & (n_valid >= sample_idx.shape[1])
    return PnPResult(
        R=torch.where(success, R_best, torch.eye(3, device=X.device)),
        t=torch.where(success, t_best, 0.0),
        inliers=inliers & success,
        num_inliers=torch.where(success, best_count, 0),
        success=success,
    )
