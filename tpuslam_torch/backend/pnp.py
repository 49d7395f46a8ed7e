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

Both solvers take a leading problem axis V, the reference's ``jax.vmap``
over independent problems (loop-verification and relocalization
candidates): ``ransac_pnp`` solves all V·H hypotheses at once and
``motion_pnp`` all V descents; every reduction, argmax and gate is per
problem.  One body serves both shapes.  On the card an unbatched (M,)
call runs it without the leading axis, so it computes the products it
computed before the axis existed.  On the CPU an unbatched call is the
batch of one (``_cpu_batch_of_one``): torch's CPU ``mm`` and ``bmm`` round
small products (3×3 rotations, a few dozen 3-vectors) differently at the
ulp, and as a batch of one the call equals a batched call problem by
problem, bit for bit.

Sampling: ``ransac_pnp`` takes its ([V,] H, 6) sample indices, or draws them
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
    """One problem's pose, or V of them along a leading axis."""

    R: torch.Tensor  # ([V,] 3, 3)
    t: torch.Tensor  # ([V,] 3)
    inliers: torch.Tensor  # ([V,] M) bool
    num_inliers: torch.Tensor  # ([V],) int32
    success: torch.Tensor  # ([V],) bool


def _cpu_batch_of_one(points3d: torch.Tensor) -> bool:
    """An unbatched call on the CPU, which runs as the batch of one (see the module docstring)."""
    return points3d.dim() == 2 and points3d.device.type == "cpu"


def _first(res: PnPResult) -> PnPResult:
    """The one problem of a batch of one."""
    return PnPResult(*(f[0] for f in res))


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
    R0: torch.Tensor,  # ([V,] 3, 3) world→cam seed
    t0: torch.Tensor,  # ([V,] 3)
    points3d: torch.Tensor,  # ([V,] M, 3) world
    points2d: torch.Tensor,  # ([V,] M, 2) pixels
    valid: torch.Tensor,  # ([V,] M) bool
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
    ``min_inliers`` and a finite pose, each problem its own; failure
    returns the identity.
    """
    if _cpu_batch_of_one(points3d):
        return _first(motion_pnp(K, R0[None], t0[None], points3d[None], points2d[None], valid[None], iters=iters,
                                 reproj_threshold=reproj_threshold, min_inliers=min_inliers,
                                 huber_schedule=huber_schedule))
    X = points3d.float()
    uv = points2d.float()
    Kf = K.float()
    R, t = R0.float(), t0.float()
    vf = valid.float()
    fx, fy = Kf[0, 0], Kf[1, 1]
    for i in range(iters):
        delta = huber_schedule[min(i, len(huber_schedule) - 1)]
        Xc = torch.matmul(X, R.transpose(-1, -2)) + t[..., None, :]
        z = Xc[..., 2]
        behind = z <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, z)
        pix = torch.matmul(Xc * inv_z[..., None], Kf.T)
        r = pix[..., :2] - uv
        err = torch.linalg.vector_norm(r, dim=-1)
        # Huber weight: 1 inside the width, δ/|r| outside; cheirality and validity zero the rest.
        w = vf * torch.where(~behind, torch.clamp_max(delta / torch.clamp_min(err, 1e-9), 1.0), 0.0)
        R, t = _apply_step(R, t, _gn_step(_gn_system(Xc, fx, fy, inv_z), w, r))

    err, z = reprojection_errors(Kf, R, t, X, uv)
    inliers = (err < reproj_threshold) & (z > 0) & valid
    count = inliers.sum(dim=-1, dtype=torch.int32)
    finite = torch.isfinite(R).all(dim=(-2, -1)) & torch.isfinite(t).all(dim=-1)
    success = (count >= min_inliers) & finite
    return PnPResult(
        R=torch.where(success[..., None, None], R, torch.eye(3, device=R.device)),
        t=torch.where(success[..., None], t, 0.0),
        inliers=inliers & success[..., None],
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
    """(..., H, S) indices for (..., M) ``valid``: S distinct valid matches a hypothesis, from
    ``generator``'s noise on ``valid``'s device."""
    u = torch.rand((*valid.shape[:-1], num_hypotheses, valid.shape[-1]), generator=generator, device=valid.device)
    return gumbel_top_indices(u, valid, sample_size)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :]: ([V,] M, C) rows at ([V,] H, S) indices → ([V,] H, S, C)."""
    flat = torch.take_along_dim(x, idx.flatten(-2)[..., None], dim=-2)
    return flat.unflatten(-2, idx.shape[-2:])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, ...] for ([V,] H, ...) ``x`` and a ([V,] 1) device index: no host sync."""
    d = idx.dim() - 1
    return torch.take_along_dim(x, idx.reshape(*idx.shape, *(1,) * (x.dim() - d - 1)), dim=d).squeeze(d)


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
    """Batched-RANSAC DLT PnP over ([V,] M) correspondences.

    ``points3d``: ([V,] M, 3) world; ``points2d``: ([V,] M, 2) pixels;
    ``valid``: ([V,] M) bool; ``K``: (3, 3), shared.  ``sample_idx``:
    optional ([V,] H, S) match indices, else drawn from ``generator``.
    ``hyp_sweeps`` (default ``solver_sweeps``) bounds the hypotheses'
    Jacobi sweeps only.  ``refine``: the LO refit, ``"dlt"`` (weighted DLT)
    or ``"gn"`` (Gauss-Newton on the pixel residual); a refit is kept when
    it has at least as many inliers.  With a leading V every problem is
    solved as it would be alone, and the result has a leading V.
    """
    if _cpu_batch_of_one(points3d):
        return _first(ransac_pnp(
            points3d[None], points2d[None], valid[None], K, None if sample_idx is None else sample_idx[None],
            generator, num_hypotheses=num_hypotheses, sample_size=sample_size, reproj_threshold=reproj_threshold,
            min_inliers=min_inliers, solver_sweeps=solver_sweeps, hyp_sweeps=hyp_sweeps, lo_rounds=lo_rounds,
            refine=refine,
        ))
    X = points3d.float()  # ([V,] M, 3)
    uv = points2d.float()
    Kf = K.float()
    fx, fy = Kf[0, 0], Kf[1, 1]
    cx, cy = Kf[0, 2], Kf[1, 2]
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)

    if sample_idx is None:
        sample_idx = gumbel_sample_indices(valid, num_hypotheses, sample_size, generator)
    sample_idx = sample_idx.to(device=X.device, dtype=torch.int64)  # ([V,] H, S)
    R_h, t_h = solve_pnp_dlt(
        _gather_rows(X, sample_idx), _gather_rows(xn, sample_idx),
        sweeps=solver_sweeps if hyp_sweeps is None else hyp_sweeps,
    )  # ([V,] H, 3, 3), ([V,] H, 3)

    # the hypotheses' axis: an unbatched (M, 3) broadcasts against (H, 3, 3) as it is
    X_h, uv_h = (X, uv) if X.dim() == 2 else (X[:, None], uv[:, None])
    err, z = reprojection_errors(Kf, R_h, t_h, X_h, uv_h)  # ([V,] H, M)
    inlier_mat = (err < reproj_threshold) & (z > 0) & valid[..., None, :]
    counts = inlier_mat.sum(dim=-1, dtype=torch.int32)
    best_h = torch.argmax(counts, dim=-1, keepdim=True)  # ([V,] 1), the first maximum; no host sync
    R_best = _take(R_h, best_h)
    t_best = _take(t_h, best_h)
    inliers = _take(inlier_mat, best_h)
    best_count = _take(counts, best_h)
    for _ in range(lo_rounds):
        w = inliers.float()
        if refine == "gn":
            R_ref, t_ref = refine_pnp_gn(Kf, R_best, t_best, X, uv, w, iters=3)
        else:
            R_ref, t_ref = solve_pnp_dlt(X, xn, weights=w, sweeps=solver_sweeps)
        err_r, z_r = reprojection_errors(Kf, R_ref, t_ref, X, uv)
        inl_r = (err_r < reproj_threshold) & (z_r > 0) & valid
        cnt_r = inl_r.sum(dim=-1, dtype=torch.int32)
        better = cnt_r >= best_count
        R_best = torch.where(better[..., None, None], R_ref, R_best)
        t_best = torch.where(better[..., None], t_ref, t_best)
        inliers = torch.where(better[..., None], inl_r, inliers)
        best_count = torch.where(better, cnt_r, best_count)

    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    success = (best_count >= min_inliers) & (n_valid >= sample_idx.shape[-1])
    return PnPResult(
        R=torch.where(success[..., None, None], R_best, torch.eye(3, device=X.device)),
        t=torch.where(success[..., None], t_best, 0.0),
        inliers=inliers & success[..., None],
        num_inliers=torch.where(success, best_count, 0),
        success=success,
    )
