"""Sliding-window bundle adjustment: Levenberg–Marquardt with a Schur complement.

Port of ``tpuslam/backend/ba.py``.  Per LM step, over the dense (W, P)
observation grid:

* residuals r_ij = π(K(R_i X_j + t_i)) − uv_ij, Huber-weighted;
* closed-form Jacobian blocks A_ij (2×6, pose) and B_ij (2×3, point);
* Hessian blocks U_i = Σ_j AᵀA, V_j = Σ_i BᵀB, W_ij = AᵀB and the gradient;
* the Schur complement S = U − Σ_j W V⁻¹ Wᵀ over the poses, a dense
  (6W, 6W) system (48×48 for 8 keyframes) solved directly, then the points
  by back-substitution through the closed-form 3×3 inverses;
* the gauge: the oldest keyframe is frozen, and every candidate is rescaled
  about it so the baseline to the second oldest keeps its input length;
  a step is accepted when it lowers the cost, and λ adapts.

Everything is float32.  The products are ``torch.einsum`` / ``matmul`` in
full float32: on the card this path runs with
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default), the
counterpart of the reference's ``precision="highest"``.  The fixed-step
path reads nothing back to the host; ``rtol > 0`` reads its stop flag once
a step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.backend.map import MapState, _apply_row_scatter
from tpuslam_torch.common.geometry import hat, so3_exp

_INT32_MAX = 2**31 - 1


class BAResult(NamedTuple):
    map: MapState
    initial_cost: torch.Tensor  # () float32
    final_cost: torch.Tensor  # () float32
    iterations: torch.Tensor  # () int32 — LM steps taken


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``A @ x`` over broadcast leading dims."""
    return (A * x[..., None, :]).sum(dim=-1)


def _project_residual(R, t, X, uv, K) -> torch.Tensor:
    """(..., 2) reprojection residuals; every argument broadcasts over leading dims."""
    cam = _mv(R, X) + t
    z = torch.clamp_min(cam[..., 2], 1e-6)
    pix = _mv(K, cam / z[..., None])
    return pix[..., :2] - uv


def _residual_with_delta(delta_pose, delta_point, R, t, X, uv, K) -> torch.Tensor:
    """The residual after the local updates BA solves for.

    ``delta_pose`` ∈ se(3) as (ω, ν): R ← exp(ω)·R, t ← exp(ω)·t + ν; X ← X + δ.
    """
    dR = so3_exp(delta_pose[..., :3])
    return _project_residual(dR @ R, _mv(dR, t) + delta_pose[..., 3:], X + delta_point, uv, K)


def _huber_weight(r_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel."""
    return torch.where(r_norm <= delta, 1.0, delta / torch.clamp_min(r_norm, 1e-12))


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 3, 3) matrices: adjugate over determinant.

    Kept as the reference writes it (not ``torch.linalg.inv``, a batched LU
    that rounds differently); callers pass LM-damped, invertible blocks.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / torch.where(det.abs() < 1e-30, 1e-30, det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _cost(R, t, points, obs_uv, obs_mask, K, huber: float) -> torch.Tensor:
    """Huber cost over the observed cells of the (W, P) grid."""
    rn = torch.linalg.vector_norm(_project_residual(R[:, None], t[:, None], points[None], obs_uv, K), dim=-1)
    c = torch.where(rn <= huber, 0.5 * rn**2, huber * (rn - 0.5 * huber))
    return torch.where(obs_mask, c, 0.0).sum()


def _blocks(R, t, X, uv, K) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form Jacobian blocks of the residual at δ = 0: (A (..., 2, 6), B (..., 2, 3), r (..., 2)).

    The chain rule of ``_residual_with_delta``: ∂π/∂cam = [[fx/z, 0, −fx·x/z²],
    [0, fy/z, −fy·y/z²]], ∂cam/∂ω = −[cam]ₓ, ∂cam/∂ν = I, ∂cam/∂X = R.
    """
    cam = _mv(R, X) + t
    inv_z = 1.0 / torch.clamp_min(cam[..., 2], 1e-6)
    fx, fy = K[0, 0], K[1, 1]
    zero = torch.zeros_like(inv_z)
    j_pi = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * cam[..., 0] * inv_z * inv_z], dim=-1),
            torch.stack([zero, fy * inv_z, -fy * cam[..., 1] * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    A = torch.cat([-(j_pi @ hat(cam)), j_pi], dim=-1)
    return A, j_pi @ R, _project_residual(R, t, X, uv, K)


def bundle_adjust(
    m: MapState,
    K: torch.Tensor,
    *,
    iterations: int = 10,
    huber_px: float = 2.0,
    init_lambda: float = 1e-3,
    fix_first_pose: bool = True,
    active_points: int | None = 1024,
    rtol: float = 0.0,
) -> BAResult:
    """Optimise the window's keyframe poses and observed points (functional).

    ``active_points``: gather up to this many *observed* points (ascending
    slot order) into a dense block for the LM loop and scatter them back
    once after; observed points beyond the budget keep their values.
    ``None`` optimises the full capacity grid.

    ``rtol``: 0 runs exactly ``iterations`` LM steps.  Above 0 the loop
    stops once an accepted step improves the cost by less than ``rtol``
    relative, or λ reaches its ceiling (its flag is read on the host).
    """
    K = K.to(torch.float32)
    W = m.window
    dev = m.points.device
    full_mask = m.obs_mask & m.kf_valid[:, None] & m.point_valid[None, :]
    m_in = m

    if active_points is not None and active_points < m.capacity:
        seen_full = full_mask.any(dim=0)
        # the observed slots first, in ascending order: a stable sort, since
        # a top-k of the 0/1 mask promises no order among its ties
        act_idx = torch.argsort((~seen_full).to(torch.uint8), stable=True)[:active_points]
        act_valid = seen_full[act_idx]
        m = m._replace(
            points=m.points[act_idx],
            point_valid=m.point_valid[act_idx] & act_valid,
            point_birth=m.point_birth[act_idx],
            obs_uv=m.obs_uv[:, act_idx],
            obs_mask=m.obs_mask[:, act_idx] & act_valid[None, :],
        )
        mask = full_mask[:, act_idx] & act_valid[None, :]
    else:
        act_idx = None
        mask = full_mask

    # The scale gauge: freeze the oldest valid keyframe g0, and rescale each
    # candidate about it so the baseline g0-g1 keeps its input length (a
    # pure gauge transform; the cost is unchanged).
    order = torch.argsort(torch.where(m.kf_valid, m.kf_id, _INT32_MAX), stable=True)
    g0, g1 = order[:1], order[1:2]
    arange_w = torch.arange(W, device=dev)
    pose_free = torch.where(arange_w == g0, 0.0, 1.0) if fix_first_pose else torch.ones(W, device=dev)

    def centers(R, t):
        return -torch.einsum("wji,wj->wi", R, t)

    def baseline(R, t):
        C = centers(R, t)
        return torch.linalg.vector_norm(C.index_select(0, g1)[0] - C.index_select(0, g0)[0])

    b0 = baseline(m.kf_R, m.kf_t)
    gauge_ok = (m.kf_valid.sum() >= 2) & (b0 > 1e-6) & fix_first_pose
    seen = mask.any(dim=0)  # the points an LM step moves

    def renorm_scale(R, t, X):
        s = torch.where(gauge_ok, b0 / torch.clamp_min(baseline(R, t), 1e-9), 1.0)
        C = centers(R, t)
        C0 = C.index_select(0, g0)[0]
        t_new = -torch.einsum("wij,wj->wi", R, C0 + s * (C - C0))
        # only the observed points: the others already sit at the input scale
        return t_new, torch.where(seen[:, None], C0 + s * (X - C0), X)

    eye6 = torch.eye(6, device=dev)
    eye3 = torch.eye(3, device=dev)
    eye_w = torch.eye(W, device=dev)[:, None, :, None]  # S[w, :, w, :] selector
    free = pose_free[:, None]
    frozen_diag = eye_w * ((1.0 - pose_free)[:, None, None] * eye6)[:, :, None, :]
    damp = 1e-8 * torch.eye(6 * W, device=dev)

    def lm_step(R, t, X, lam, cost):
        A, Bj, r = _blocks(R[:, None], t[:, None], X[None], m.obs_uv, K)  # (W,P,2,6), (W,P,2,3), (W,P,2)
        w = torch.where(mask, _huber_weight(torch.linalg.vector_norm(r, dim=-1), huber_px), 0.0)
        J = torch.cat([A, Bj], dim=-1)  # (W, P, 2, 9)
        Jw = J * w[..., None, None]
        H9 = torch.einsum("wpri,wprj->wpij", Jw, J)  # (W, P, 9, 9)
        g9 = -torch.einsum("wpri,wpr->wpi", Jw, r)  # (W, P, 9)
        U = H9[..., :6, :6].sum(dim=1)  # (W, 6, 6)
        V = H9[..., 6:, 6:].sum(dim=0)  # (P, 3, 3)
        Wb = H9[..., :6, 6:]  # (W, P, 6, 3)
        ga = g9[..., :6].sum(dim=1)  # (W, 6)
        gb = g9[..., 6:].sum(dim=0)  # (P, 3)

        U_d = U + lam * eye6
        V_inv = _inv3x3(V + lam * eye3 + 1e-8 * eye3)  # unobserved points: λI, harmless
        WVinv = torch.einsum("wpij,pjk->wpik", Wb, V_inv)  # (W, P, 6, 3)
        S = -torch.einsum("wpik,vpjk->wivj", WVinv, Wb) + eye_w * U_d[:, :, None, :]  # (W, 6, W, 6)
        rhs = ga - torch.einsum("wpik,pk->wi", WVinv, gb)
        # the frozen pose: rows and columns zeroed, identity on its diagonal
        S = S * free[:, :, None, None] * free[None, None, :, :] + frozen_diag
        rhs = rhs * free
        # solve_ex: no error check, so no host sync
        delta_a = torch.linalg.solve_ex(S.reshape(6 * W, 6 * W) + damp, rhs.reshape(6 * W, 1),
                                        check_errors=False).result.reshape(W, 6) * free
        delta_b = torch.einsum("pij,pj->pi", V_inv, gb - torch.einsum("wpij,wi->pj", Wb, delta_a))
        delta_b = torch.where(seen[:, None], delta_b, 0.0)

        dRs = so3_exp(delta_a[:, :3])
        R_new = dRs @ R
        t_new, X_new = renorm_scale(R_new, torch.einsum("wij,wj->wi", dRs, t) + delta_a[:, 3:], X + delta_b)
        new_cost = _cost(R_new, t_new, X_new, m.obs_uv, mask, K, huber_px)
        accept = new_cost < cost
        return (
            torch.where(accept, R_new, R),
            torch.where(accept, t_new, t),
            torch.where(accept, X_new, X),
            torch.where(accept, torch.clamp_min(lam * 0.3, 1e-9), torch.clamp_max(lam * 4.0, 1e6)),
            torch.where(accept, new_cost, cost),
        )

    init_cost = _cost(m.kf_R, m.kf_t, m.points, m.obs_uv, mask, K, huber_px)
    carry = (m.kf_R, m.kf_t, m.points, torch.full((), init_lambda, device=dev), init_cost)
    n_iter = iterations
    if rtol > 0.0:
        for i in range(iterations):
            prev_cost = carry[4]
            carry = lm_step(*carry)
            new_lam, new_cost = carry[3], carry[4]
            rel = (prev_cost - new_cost) / torch.clamp_min(prev_cost, 1e-12)
            if bool(((new_cost < prev_cost) & (rel < rtol)) | (new_lam >= 1e6)):
                n_iter = i + 1
                break
    else:
        for _ in range(iterations):
            carry = lm_step(*carry)
    R, t, X, _, final_cost = carry

    if act_idx is not None:
        points = _apply_row_scatter(m_in.points, X, act_idx, act_valid)
    else:
        points = X
    return BAResult(
        map=m_in._replace(kf_R=R, kf_t=t, points=points),
        initial_cost=init_cost,
        final_cost=final_cost,
        iterations=torch.full((), n_iter, dtype=torch.int32, device=dev),
    )
