"""Batched Nistér five-point minimal solver for the essential matrix.

Port of ``tpuslam/frontend/fivepoint.py``, batched over any leading dims:

* the 4-dimensional nullspace of each 5×9 epipolar system by Householder
  QR (``geometry.nullspace_basis``);
* the ten cubic constraints (det E = 0 and 2EEᵀE − tr(EEᵀ)E = 0) expanded
  over the 20 monomials of degree ≤ 3 with integer multiplication tables;
* the 10×20 system reduced by ten unrolled, partially pivoted Gauss-Jordan
  steps; Nistér's B(z) and its degree-10 determinant;
* all ten roots by 48 fixed Durand-Kerner iterations in complex64 on the
  Fujiwara-balanced polynomial;
* each real root back-substituted through the best-conditioned 2×2 of B,
  polished by four Gauss-Newton steps against the ten cubics, and gated on
  their residual.

Up to ten candidates a sample come out with a validity mask; degenerate
samples or complex roots are masked, never branched on.  3×3 solves use
``solve_ex`` without its error check (no host sync on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpuslam_torch.common.geometry import nullspace_basis

# Degree-1 basis [x, y, z, 1]; degree-2; degree-3 in Nistér's elimination order
# (the first ten are solved by Gauss-Jordan, the last ten survive into B(z)).
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_DEG2 = [
    (2, 0, 0), (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1),
    (0, 1, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_DEG3 = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]


def _mul_table(a_basis, b_basis, out_basis) -> np.ndarray:
    out_index = {m: k for k, m in enumerate(out_basis)}
    T = np.zeros((len(a_basis), len(b_basis), len(out_basis)), np.float32)
    for i, ma in enumerate(a_basis):
        for j, mb in enumerate(b_basis):
            T[i, j, out_index[tuple(ea + eb for ea, eb in zip(ma, mb))]] = 1.0
    return T


_T11_NP = _mul_table(_DEG1, _DEG1, _DEG2)  # (4, 4, 10)
_T21_NP = _mul_table(_DEG2, _DEG1, _DEG3)  # (10, 4, 20)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.from_numpy(_T11_NP).to(device, dtype), torch.from_numpy(_T21_NP).to(device, dtype)


def _p11(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, 4) × (…, 4) degree-1 polynomials → (…, 10) degree-2."""
    return torch.einsum("...i,...j,ijk->...k", a, b, _tables(a.device, a.dtype)[0])


def _p21(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, 10) × (…, 4) → (…, 20) degree-3."""
    return torch.einsum("...i,...j,ijk->...k", a, b, _tables(a.device, a.dtype)[1])


def _constraint_matrix(basis: torch.Tensor) -> torch.Tensor:
    """(…, 9, 4) nullspace basis (columns X, Y, Z, W, row-major 3×3) → (…, 10, 20) cubic constraints."""
    T11, T21 = _tables(basis.device, basis.dtype)
    E = basis.reshape(*basis.shape[:-2], 3, 3, 4)

    def e(i, j):
        return E[..., i, j, :]

    def det2(i1, j1, i2, j2, i3, j3, i4, j4):
        return _p11(e(i1, j1), e(i2, j2)) - _p11(e(i3, j3), e(i4, j4))

    det = (
        _p21(det2(1, 1, 2, 2, 1, 2, 2, 1), e(0, 0))
        + _p21(det2(1, 2, 2, 0, 1, 0, 2, 2), e(0, 1))
        + _p21(det2(1, 0, 2, 1, 1, 1, 2, 0), e(0, 2))
    )  # (…, 20)
    EEt = torch.einsum("...ika,...jkb,abc->...ijc", E, E, T11)  # (…, 3, 3, 10)
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    M = 2.0 * EEt - tr[..., None, None, :] * torch.eye(3, dtype=basis.dtype, device=basis.device)[:, :, None]
    C = torch.einsum("...ika,...kjb,abc->...ijc", M, E, T21)  # (…, 3, 3, 20)
    return torch.cat([det[..., None, :], C.reshape(*C.shape[:-3], 9, 20)], dim=-2)


def _gauss_jordan(A: torch.Tensor) -> torch.Tensor:
    """Reduced row echelon form of (…, 10, 20), partial pivoting; returns the right 10×10 block."""
    m = A.shape[-2]
    rows = torch.arange(m, device=A.device)
    for k in range(m):
        col = torch.where(rows >= k, A[..., :, k].abs(), -1.0)
        p = torch.argmax(col, dim=-1)  # (…,) the first maximum
        perm = torch.where(rows == k, p[..., None], torch.where(rows == p[..., None], k, rows))
        A = torch.take_along_dim(A, perm[..., :, None], dim=-2)
        piv = A[..., k, k][..., None]
        piv = torch.where(piv.abs() < 1e-20, 1e-20, piv)
        rk = A[..., k, :] / piv
        factors = torch.where(rows == k, 0.0, A[..., :, k])
        A = A - factors[..., :, None] * rk[..., None, :]
        A = torch.cat([A[..., :k, :], rk[..., None, :], A[..., k + 1 :, :]], dim=-2)
    return A[..., :, m:]


def _polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of batched z-polynomials, coefficients highest degree first."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros((*a.shape[:-1], la + lb - 1), dtype=a.dtype, device=a.device)
    for i in range(la):
        out[..., i : i + lb] += a[..., i : i + 1] * b
    return out


def _b_rows(R: torch.Tensor):
    """Nistér's B(z) rows from the reduced system: (Px (…, 3, 4), Py (…, 3, 4), Pc (…, 3, 5))."""
    ra = R[..., 4::2, :]  # rows of x²z, y²z, xyz
    rb = R[..., 5::2, :]  # rows of x², y², xy
    Px = torch.stack([-rb[..., 0], ra[..., 0] - rb[..., 1], ra[..., 1] - rb[..., 2], ra[..., 2]], dim=-1)
    Py = torch.stack([-rb[..., 3], ra[..., 3] - rb[..., 4], ra[..., 4] - rb[..., 5], ra[..., 5]], dim=-1)
    Pc = torch.stack(
        [-rb[..., 6], ra[..., 6] - rb[..., 7], ra[..., 7] - rb[..., 8], ra[..., 8] - rb[..., 9], ra[..., 9]],
        dim=-1,
    )
    return Px, Py, Pc


def _det_b(Px: torch.Tensor, Py: torch.Tensor, Pc: torch.Tensor) -> torch.Tensor:
    """det B(z): the degree-10 polynomial, (…, 11) highest degree first."""
    m1 = _polymul(Py[..., 1, :], Pc[..., 2, :]) - _polymul(Pc[..., 1, :], Py[..., 2, :])
    m2 = _polymul(Px[..., 1, :], Pc[..., 2, :]) - _polymul(Pc[..., 1, :], Px[..., 2, :])
    m3 = _polymul(Px[..., 1, :], Py[..., 2, :]) - _polymul(Py[..., 1, :], Px[..., 2, :])
    return _polymul(Px[..., 0, :], m1) - _polymul(Py[..., 0, :], m2) + _polymul(Pc[..., 0, :], m3)


def _mon_and_jac(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """The 20 degree-3 monomials (…, 20) and their Jacobian (…, 20, 3) at (x, y, z)."""
    pows = {}
    for var, v in (("x", x), ("y", y), ("z", z)):
        pows[var] = [torch.ones_like(v), v, v * v, v * v * v]
    zero = torch.zeros_like(x)
    mon_cols, jac_cols = [], []
    for ex, ey, ez in _DEG3:
        px, py, pz = pows["x"][ex], pows["y"][ey], pows["z"][ez]
        mon_cols.append(px * py * pz)
        dx = ex * pows["x"][ex - 1] * py * pz if ex else zero
        dy = ey * px * pows["y"][ey - 1] * pz if ey else zero
        dz = ez * px * py * pows["z"][ez - 1] if ez else zero
        jac_cols.append(torch.stack([dx, dy, dz], dim=-1))
    return torch.stack(mon_cols, dim=-1), torch.stack(jac_cols, dim=-2)


def _gauss_newton_polish(A: torch.Tensor, x, y, z, iters: int = 4):
    """Refine roots of A·mon(x, y, z) = 0 by damped Gauss-Newton (3×3 normal equations)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        mon, jac = _mon_and_jac(x, y, z)
        r = torch.einsum("...ck,...nk->...nc", A, mon)  # (…, 10 roots, 10 constraints)
        J = torch.einsum("...ck,...nkv->...ncv", A, jac)
        JtJ = torch.einsum("...ncv,...ncw->...nvw", J, J)
        Jtr = torch.einsum("...ncv,...nc->...nv", J, r)
        trace = JtJ[..., 0, 0] + JtJ[..., 1, 1] + JtJ[..., 2, 2]
        JtJ = JtJ + (1e-6 * trace + 1e-12)[..., None, None] * eye
        step = torch.linalg.solve_ex(JtJ, Jtr[..., None], check_errors=False)[0][..., 0]
        step = torch.clamp(step, -1.0, 1.0)
        x = x - step[..., 0]
        y = y - step[..., 1]
        z = z - step[..., 2]
    return x, y, z


# 1.2·(0.4 + 0.9i)^k, k = 1..10, as the reference computes them in complex64 (re, im pairs)
_DK_SEED10 = np.array([
    0.47999996, 1.08, -0.7800001, 0.8639999, -1.0896, -0.35639995, -0.11507983, -1.1231999,
    0.96484804, -0.5528517, 0.8835058, 0.6472223, -0.22909836, 1.054044, -1.0402789, 0.21542941,
    -0.6099982, -0.850079, 0.5210724, -0.88902974,
], np.float32)


@functools.lru_cache(maxsize=None)
def _dk_seed(d: int, device: torch.device) -> torch.Tensor:
    """The d starting points on ``device``, built once (no host-to-device copy per call)."""
    seed = _DK_SEED10.view(np.complex64) if d == 10 else (1.2 * (0.4 + 0.9j) ** np.arange(1, d + 1)).astype(np.complex64)
    return torch.from_numpy(seed).to(device)


def durand_kerner_roots(coeffs: torch.Tensor, iters: int = 48) -> tuple[torch.Tensor, torch.Tensor]:
    """All complex roots of batched real polynomials (…, d+1), highest degree first.

    Returns ``(roots (…, d) complex64, ok (…,))``; ``ok`` is False where the
    leading coefficient vanishes.  Balanced by the substitution z = s·w with
    Fujiwara's bound s = 2·maxᵢ |mᵢ|^(1/i), in log space.
    """
    d = coeffs.shape[-1] - 1
    lead = coeffs[..., 0:1]
    ok = lead[..., 0].abs() > 1e-12 * coeffs.abs().amax(dim=-1)
    monic = coeffs / torch.where(lead.abs() < 1e-30, 1e-30, lead)
    i_pow = torch.arange(1, d + 1, dtype=monic.dtype, device=monic.device)
    log_m = torch.log(torch.clamp_min(monic[..., 1:].abs(), 1e-30))
    log_s = np.log(2.0) + torch.amax(log_m / i_pow, dim=-1, keepdim=True)
    log_s = torch.clamp_min(log_s, float(np.log(1e-3)))  # keeps 1/s finite too
    scaled = torch.sign(monic[..., 1:]) * torch.exp(log_m - i_pow * log_s)
    monic_c = torch.cat([torch.ones_like(scaled[..., :1]), scaled], dim=-1).to(torch.complex64)
    s = torch.exp(log_s)

    # the scaled roots lie in |w| <= 1: start just outside, at the reference's complex64 seeds
    r = _dk_seed(d, coeffs.device).expand(*monic.shape[:-1], d).clone()
    eye = torch.eye(d, dtype=torch.complex64, device=coeffs.device)

    def horner(zz):
        acc = monic_c[..., 0:1].expand(zz.shape)
        for i in range(1, d + 1):
            acc = acc * zz + monic_c[..., i : i + 1]
        return acc

    for _ in range(iters):
        diff = r[..., :, None] - r[..., None, :] + eye
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        r = r - horner(r) / denom
    return s.to(torch.complex64) * r, ok


def fivepoint_essential(x1: torch.Tensor, x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Essential-matrix candidates from (…, 5, 2) normalised samples → (E (…, 10, 3, 3), valid (…, 10))."""
    u1, v1 = x1[..., 0].float(), x1[..., 1].float()
    u2, v2 = x2[..., 0].float(), x2[..., 1].float()
    one = torch.ones_like(u1)
    rows = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)  # (…, 5, 9)

    basis = nullspace_basis(rows)  # (…, 9, 4)
    A = _constraint_matrix(basis)  # (…, 10, 20)
    R = _gauss_jordan(A)
    Px, Py, Pc = _b_rows(R)
    roots, lead_ok = durand_kerner_roots(_det_b(Px, Py, Pc))
    z_re, z_im = roots.real, roots.imag
    real = z_im.abs() < 5e-2 * (1.0 + z_re.abs())
    # roots beyond ~1e3 carry no float32 information: clipped, the residual gate masks them
    z_re = torch.clamp(torch.nan_to_num(z_re), -1e3, 1e3)

    def evalp(P, zz):  # P (…, 3, L), zz (…, 10) → (…, 3, 10)
        acc = P[..., :, 0:1].expand(*zz.shape[:-1], 3, zz.shape[-1])
        for i in range(1, P.shape[-1]):
            acc = acc * zz[..., None, :] + P[..., :, i : i + 1]
        return acc

    bx, by, bc = evalp(Px, z_re), evalp(Py, z_re), evalp(Pc, z_re)
    dets, xs, ys = [], [], []
    for i, j in ((0, 1), (0, 2), (1, 2)):  # the row pair with the largest |determinant|
        dets.append(bx[..., i, :] * by[..., j, :] - by[..., i, :] * bx[..., j, :])
        xs.append(-bc[..., i, :] * by[..., j, :] + by[..., i, :] * bc[..., j, :])
        ys.append(-bx[..., i, :] * bc[..., j, :] + bc[..., i, :] * bx[..., j, :])
    Ds, Xs, Ys = torch.stack(dets, dim=-1), torch.stack(xs, dim=-1), torch.stack(ys, dim=-1)
    best = torch.argmax(Ds.abs(), dim=-1, keepdim=True)
    D = torch.take_along_dim(Ds, best, dim=-1)[..., 0]
    Dx = torch.take_along_dim(Xs, best, dim=-1)[..., 0]
    Dy = torch.take_along_dim(Ys, best, dim=-1)[..., 0]
    cond_ok = D.abs() > 1e-12
    D_safe = torch.where(cond_ok, D, 1.0)
    x = torch.clamp(torch.nan_to_num(Dx / D_safe), -1e3, 1e3)
    y = torch.clamp(torch.nan_to_num(Dy / D_safe), -1e3, 1e3)
    x, y, z_re = _gauss_newton_polish(A, x, y, z_re)
    mon, _ = _mon_and_jac(x, y, z_re)
    resid = torch.linalg.vector_norm(torch.einsum("...ck,...nk->...nc", A, mon), dim=-1)
    scale = torch.maximum(torch.maximum(x.abs(), y.abs()), torch.clamp_min(z_re.abs(), 1.0)) ** 3
    converged = resid < 1e-4 * scale

    coeff = torch.stack([x, y, z_re, torch.ones_like(z_re)], dim=-1)  # (…, 10, 4)
    Evec = torch.einsum("...nc,...ec->...ne", coeff, basis)  # (…, 10, 9)
    valid = real & converged & lead_ok[..., None] & torch.isfinite(Evec).all(dim=-1)
    norm = torch.linalg.vector_norm(Evec, dim=-1)[..., None, None]
    E = Evec.reshape(*Evec.shape[:-1], 3, 3) / torch.where(norm < 1e-12, 1.0, norm)
    return E, valid
