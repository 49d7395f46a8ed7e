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

With ``sample_size=5`` each sample gives up to ten candidates from the
five-point solver (``frontend/fivepoint.py``); all 10·H of them are scored
by kernel 4, and the masked ones (complex roots, degenerate samples, which
may hold NaN) are set to M + 1 after the kernel, so they rank last.

Ties resolve as ``lax.top_k`` resolves them (lowest index first), through
stable sorts.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpuslam_torch.common.geometry import (
    normalize_points,
    nullvec_jacobi,
    orthonormalize_rotation,
    triangulate_homogeneous,
    triangulate_points,
)
from tpuslam_torch.config.schema import PoseConfig
from tpuslam_torch.kernels.pose import build_msac_operand, msac_scores
from tpuslam_torch.utils import profiling


class PoseResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3) unit norm
    E: torch.Tensor  # (B, 3, 3)
    inliers: torch.Tensor  # (B, M) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor  # (B,) bool


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, built once per (dtype, device): no host-to-device copy per call."""
    return torch.tensor(values, dtype=dtype, device=device)


def _W(like: torch.Tensor) -> torch.Tensor:
    return _constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), like.dtype, like.device)


def _eight_point_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Epipolar rows x2ᵀ E x1 = 0 with E row-major: (..., N, 2) → (..., N, 9)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def _svd(E: torch.Tensor):
    """SVD of (..., 3, 3); a matrix with a non-finite entry gives NaN factors, as ``jnp.linalg.svd``
    does (torch raises on the CPU).  Only a five-point sample with every candidate masked has one."""
    finite = torch.isfinite(E).all(dim=(-2, -1), keepdim=True)
    u, s, vt = torch.linalg.svd(torch.where(finite, E, torch.eye(3, dtype=E.dtype, device=E.device)))
    return torch.where(finite, u, torch.nan), torch.where(finite[..., 0], s, torch.nan), torch.where(finite, vt, torch.nan)


def _project_essential(E: torch.Tensor) -> torch.Tensor:
    """Snap (..., 3, 3) onto the essential manifold: singular values → (1, 1, 0)."""
    u, _, vt = _svd(E)
    return torch.matmul(u * _constant((1.0, 1.0, 0.0), E.dtype, E.device), vt)


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
    u, _, vt = _svd(E)
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


def _candidate_poses(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The four [R|±t] candidates of (..., 3, 3) essential matrices: (..., 4, 3, 3), (..., 4, 3)."""
    R1, R2, t = decompose_essential(E)
    return torch.stack([R1, R2, R1, R2], dim=-3), torch.stack([t, t, -t, -t], dim=-2)


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
    Spans (``utils/profiling.py``): ``pose.hypotheses``, ``pose.msac``,
    ``pose.lo``, ``pose.cheirality``.
    """
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
    with profiling.span("pose.hypotheses"):
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
        hyp_ok = None
        if S == 5:
            from tpuslam_torch.frontend.fivepoint import fivepoint_essential

            idx2 = sample_idx[..., None].expand(B, H * S, 2)
            s1 = torch.gather(x1, 1, idx2).reshape(B, H, S, 2)
            s2 = torch.gather(x2, 1, idx2).reshape(B, H, S, 2)
            E_cand, cand_ok = fivepoint_essential(s1, s2)  # (B, H, 10, 3, 3), (B, H, 10)
            E_hyp = E_cand.reshape(B, H * 10, 3, 3)
            hyp_ok = cand_ok.reshape(B, H * 10)
        else:
            rows = torch.gather(rows_all, 1, sample_idx[..., None].expand(B, H * S, 9)).reshape(B, H, S, 9)
            E_hyp = _solve_e_from_rows(rows, project=False, sweeps=3)  # (B, H, 3, 3)
        n_models = E_hyp.shape[1]

    # --- MSAC scores of every hypothesis (kernel 4).
    with profiling.span("pose.msac"):
        focal = 0.5 * (Kf[0, 0] + Kf[1, 1])
        thr = (inlier_threshold_px / focal) ** 2
        n_invalid = (~valid).sum(dim=-1, keepdim=True)
        P_op = build_msac_operand(x1, x2, valid, thr)
        msac = msac_scores(E_hyp.reshape(B, n_models, 9), P_op) + n_invalid
        if hyp_ok is not None:  # masked five-point candidates rank last, set after the kernel
            msac = torch.where(hyp_ok, msac, float(M + 1))

    # --- annealed LO-RANSAC from the best L hypotheses.
    with profiling.span("pose.lo"):
        L = min(4, n_models)
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
    with profiling.span("pose.cheirality"):
        Rs, ts = _candidate_poses(E_best)  # (B, 4, 3, 3), (B, 4, 3)
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
    return triangulate_points(P1, P2, x1, x2)


class PoseEstimator:
    """Config-bound single-pair facade mirroring the reference's ``PoseEstimator``, on ``device``
    (the card by default)."""

    def __init__(self, camera, config: PoseConfig | None = None, device: torch.device | str = "cuda"):
        self.camera = camera
        self.config = config or PoseConfig()
        self.device = torch.device(device)
        self.K = torch.as_tensor(camera.K, dtype=torch.float32).to(self.device)

    def estimate(
        self,
        pts1: torch.Tensor,
        pts2: torch.Tensor,
        valid: torch.Tensor,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ) -> PoseResult:
        """Relative pose of one pair: (M, 2) pixel points and their (M,) mask → unbatched PoseResult.

        The samples are ``draws`` ((H, S) ranks among the valid matches, for
        example the reference's ``randint``) if given, else drawn from
        ``generator``, by default a ``torch.Generator`` seeded with the
        config's seed (the reference's ``PRNGKey(seed)``).
        """
        c = self.config
        if draws is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(c.seed)
        res = estimate_relative_pose(
            pts1.to(self.device)[None], pts2.to(self.device)[None], valid.to(self.device)[None], self.K,
            generator, draws=None if draws is None else draws[None],
            num_hypotheses=c.num_hypotheses, sample_size=c.sample_size,
            inlier_threshold_px=c.inlier_threshold_px, min_matches=c.min_matches,
        )
        return PoseResult(*(f[0] for f in res))

    def triangulate_points(self, R: torch.Tensor, t: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor):
        """(M, 3) points of one pair's (M, 2) matches against P1 = K[I|0], P2 = K[R|t]."""
        dev = self.device
        return triangulate_matched_points(
            self.K, R.to(dev)[None], t.to(dev)[None], pts1.to(dev)[None], pts2.to(dev)[None]
        )[0]
