"""Batched projective geometry primitives (port of ``tpuslam/common/geometry.py``).

The nullspace solver is the reference package's batched one-sided Jacobi on
the rows, with the same round-robin (tournament) schedule of disjoint column
pairs, so the sequence of rotations — and the float32 result up to summation
order — matches it.  Everything here is float32 with TF32 off.
"""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def _schedule_indices(n: int, device: torch.device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The round-robin schedule as (p, q) index tensors on ``device``, built once per (n, device)."""
    return [
        (
            torch.tensor([p for p, _ in r], device=device),
            torch.tensor([q for _, q in r], device=device),
        )
        for r in _round_robin_schedule(n)
    ]


def nullvec_jacobi(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Right singular vector of the smallest singular value, batched.

    One-sided Jacobi SVD on ``A`` (..., m, n): each round rotates its
    disjoint column pairs at once (Givens rotations accumulated into V).
    Working on A directly never squares the condition number, so float32
    stays accurate.  A CUDA tensor goes to kernel 6
    (``kernels/jacobi.py::jacobi_nullvec``: one launch; float32 rows of 4, 9
    or 12 columns, ``ValueError`` otherwise); a CPU tensor runs
    :func:`nullvec_jacobi_twin`.
    """
    if A.device.type == "cuda":
        from tpuslam_torch.kernels.jacobi import jacobi_nullvec  # that module imports this one

        return jacobi_nullvec(A, sweeps)
    return nullvec_jacobi_twin(A, sweeps)


def nullvec_jacobi_twin(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """:func:`nullvec_jacobi` as eager torch operations, a round of column pairs at a time: kernel
    6's plain twin."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(*A.shape[:-2], n, n).clone()
    eps = 1e-30  # a Python scalar: a device constant would be a host-to-device copy each call
    schedule = _schedule_indices(n, A.device)
    for _ in range(sweeps):
        for ps, qs in schedule:
            cp = A.index_select(-1, ps)  # (..., m, G)
            cq = A.index_select(-1, qs)
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
            A.index_copy_(-1, ps, c * cp - s * cq)
            A.index_copy_(-1, qs, s * cp + c * cq)
            vp = V.index_select(-1, ps)
            vq = V.index_select(-1, qs)
            V.index_copy_(-1, ps, c * vp - s * vq)
            V.index_copy_(-1, qs, s * vp + c * vq)
    norms = torch.linalg.vector_norm(A, dim=-2)  # (..., n) singular values
    idx = torch.argmin(norms, dim=-1)
    return torch.take_along_dim(V, idx[..., None, None], dim=-1)[..., 0]


def nullvec_minimal(A: torch.Tensor) -> torch.Tensor:
    """Exact nullvector of a *minimal* system (m = n − 1 rows), batched.

    Modified Gram-Schmidt orthonormalises the rows in order, then two fixed
    probe vectors (sin(0.7 + 1.3i), cos(0.3 + 2.1i)) are orthogonalised
    against the row space, twice; the one with the larger residual is the
    nullvector (both lying in the row space is measure-zero).
    """
    m, n = A.shape[-2:]
    if m >= n:
        raise ValueError("nullvec_minimal needs an underdetermined system")
    Q = A / torch.clamp_min(torch.linalg.vector_norm(A, dim=-1, keepdim=True), 1e-30)
    arange_m = torch.arange(m, device=A.device)
    for k in range(m):
        qk = Q[..., k, :]
        qk = qk / torch.clamp_min(torch.linalg.vector_norm(qk, dim=-1, keepdim=True), 1e-30)
        proj = torch.einsum("...mn,...n->...m", Q, qk)
        Q = torch.where((arange_m > k)[:, None], Q - proj[..., :, None] * qk[..., None, :], Q)
        Q = torch.cat([Q[..., :k, :], qk[..., None, :], Q[..., k + 1 :, :]], dim=-2)
    i = torch.arange(n, dtype=A.dtype, device=A.device)
    residuals = []
    for probe in (torch.sin(0.7 + 1.3 * i), torch.cos(0.3 + 2.1 * i)):
        b = probe.expand(*A.shape[:-2], n)
        r = b - torch.einsum("...m,...mn->...n", torch.einsum("...mn,...n->...m", Q, b), Q)
        # a second pass for float32 orthogonality
        residuals.append(r - torch.einsum("...m,...mn->...n", torch.einsum("...mn,...n->...m", Q, r), Q))
    r1, r2 = residuals
    n1 = torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    n2 = torch.linalg.vector_norm(r2, dim=-1, keepdim=True)
    v = torch.where(n1 >= n2, r1, r2)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-30)


def smallest_eigvec(ata: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., n, n) matrices.

    ``eigh`` sorts eigenvalues ascending, so it is column 0; its sign is the
    decomposition's free choice.
    """
    return torch.linalg.eigh(ata)[1][..., :, 0]


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


def dehomogenize(points_h: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(..., 4) homogeneous → (..., 3) Euclidean, guarding |w| < eps by ±eps."""
    w = points_h[..., 3:4]
    w_safe = torch.where(w.abs() < eps, torch.where(w < 0, -eps, eps), w)
    return points_h[..., :3] / w_safe


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Batched DLT triangulation → (..., N, 3) Euclidean points."""
    return dehomogenize(triangulate_homogeneous(P1, P2, pts1, pts2))


def project(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, points3d: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project (..., N, 3) world points by x = K (R X + t) → ((..., N, 2) pixels, (..., N) depths)."""
    cam = points3d @ R.transpose(-1, -2) + t[..., None, :]
    pix = cam @ K.transpose(-1, -2)
    z = pix[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-12, 1e-12, z)
    return pix[..., :2] / z_safe, cam[..., 2]


def normalize_points(K: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Pixel → normalised camera coordinates: (u-cx)/fx, (v-cy)/fy."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    x = (pts[..., 0] - cx[..., None]) / fx[..., None]
    y = (pts[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y], dim=-1)


def closest_rotation(M: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices onto SO(3) (Procrustes: U diag(1, 1, det UVᵀ) Vᵀ)."""
    u, _, vt = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vt)
    one = torch.ones_like(det)
    return (u * torch.stack([one, one, det], dim=-1)[..., None, :]) @ vt


def orthonormalize_rotation(R: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Newton iteration for the orthogonal polar factor: R ← R(3I − RᵀR)/2."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        RtR = torch.matmul(R.transpose(-1, -2), R)
        R = torch.matmul(R, 1.5 * eye - 0.5 * RtR)
    return R


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors: hat(v) @ x = v × x."""
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map (..., 3) → (..., 3, 3), Taylor-switched below θ² = 1e-8."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    Kx = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * Kx + b * (Kx @ Kx)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) → (..., 3) rotation vectors (principal branch).

    Differentiable at the identity (where the pose graph linearises): the
    small-angle branch switches on the input, before ``arccos`` sees a value
    near 1.  Angles near π are clamped.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0)
    small = cos_theta > 1.0 - 1e-6
    cos_safe = torch.where(small, torch.zeros_like(cos_theta), cos_theta)  # a tensor: forward-mode AD keeps the dtype
    theta = torch.arccos(cos_safe)
    sin_safe = torch.sqrt(torch.clamp_min(1.0 - cos_safe * cos_safe, 1e-12))
    w = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    scale = torch.where(small, 0.5 + (1.0 - cos_theta) / 6.0, theta / (2.0 * sin_safe))
    return w * scale[..., None]


def compose_se3(
    R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor, t2: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(R1, t1) ∘ (R2, t2): apply 2, then 1."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def pose_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack (..., 3, 3) and (..., 3) into (..., 4, 4) homogeneous transforms (bottom row [0 0 0 1])."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=top.dtype, device=top.device)[3:].expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def nullspace_basis(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the nullspace of a wide matrix, batched.

    ``A``: (..., m, n) with m < n; returns (..., n, n − m).  Householder QR
    of Aᵀ (m reflections, each a batched rank-1 update): the last n − m
    columns of Q span null(A).  Rank-deficient inputs give a subspace that
    is orthogonal but not exactly null.
    """
    m, n = A.shape[-2:]
    if m >= n:
        raise ValueError("nullspace_basis needs an underdetermined system")
    B = A.transpose(-1, -2)  # (..., n, m)
    rows = torch.arange(n, device=A.device)
    vs = []
    for k in range(m):
        x = torch.where(rows >= k, B[..., :, k], 0.0)  # column k below the diagonal
        xnorm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x0 = x[..., k : k + 1]
        alpha = -torch.where(x0 >= 0, 1.0, -1.0) * xnorm  # no cancellation in x − αe_k
        v = x - alpha * (rows == k).to(A.dtype)
        v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-30)
        B = B - 2.0 * v[..., :, None] * torch.einsum("...n,...nm->...m", v, B)[..., None, :]
        vs.append(v)
    Q = torch.eye(n, dtype=A.dtype, device=A.device)[:, m:].expand(*A.shape[:-2], n, n - m)
    for v in reversed(vs):  # q_j = H_0 ··· H_{m−1} e_j
        Q = Q - 2.0 * v[..., :, None] * torch.einsum("...n,...nk->...k", v, Q)[..., None, :]
    return Q
