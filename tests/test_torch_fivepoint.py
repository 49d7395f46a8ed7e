"""The five-point solver and ``estimate_relative_pose(sample_size=5)``: tpuslam_torch against tpuslam.

Stage by stage on the reference's 128 synthetic scenes (``test_fivepoint.py``):
the nullspace basis, the cubic constraint matrix, the Gauss-Jordan
reduction and the degree-10 polynomial agree given the same inputs; the
Durand-Kerner roots agree on polynomials with separated real roots.

Finding (candidates).  48 fixed Durand-Kerner iterations in complex64 do
not converge every root of every sample, and an unconverged root lands
where the rounding of the complex products and divisions leads it: XLA's
complex division (Smith's algorithm) and torch's round differently, so on
the same polynomial a few roots end up far apart (0.44 relative).  On the
128 scenes the candidate sets (valid, sign-normalised, within 1e-4) are the
same on 89.8% of samples; the true essential matrix is among the valid
candidates (within 1e-3) on 91.4% for the reference and 93.0% for the
port.  So candidates are held by the reference's own bars (``test_fivepoint.py``:
>= 85% recover the true E, median error < 1e-4, >= 95% with a candidate),
at least 85% of samples with the same candidate set, and, wherever both
recover the true E, that candidate equal to 1e-3 (measured: at most 1.6e-4,
the median below 1e-5; a polished root of an ill-conditioned sample is
float32-limited).  End to end, given the same ranks, RANSAC
picks the same model: R within 1e-4, t within 1e-3, inliers ±2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fivepoint import K, _scene
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.common.geometry import nullspace_basis as j_nullspace, so3_exp
from tpuslam.frontend import fivepoint as jfp
from tpuslam.frontend.pose import estimate_relative_pose as j_estimate
from tpuslam_torch.frontend import fivepoint as tfp
from tpuslam_torch.frontend.pose import estimate_relative_pose as t_estimate
from tpuslam_torch.kernels.pose import build_msac_operand, msac_scores


@pytest.fixture(scope="module")
def scenes():
    x1, x2, Es = zip(*[_scene(s)[:3] for s in range(128)])
    return np.stack(x1).astype(np.float32), np.stack(x2).astype(np.float32), np.stack(Es)


@pytest.fixture(scope="module")
def candidates(scenes):
    x1, x2, _ = scenes
    Ej, vj = jax.jit(jfp.fivepoint_essential)(jnp.asarray(x1), jnp.asarray(x2))
    Et, vt = tfp.fivepoint_essential(torch.from_numpy(x1), torch.from_numpy(x2))
    return np.asarray(Ej), np.asarray(vj), Et.numpy(), vt.numpy()


def _rows(x1, x2):
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    return np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, np.ones_like(u1)], -1)


def test_stages_match_reference(scenes):
    x1, x2, _ = scenes
    basis = np.asarray(j_nullspace(jnp.asarray(_rows(x1, x2))))
    np.testing.assert_allclose(tfp.nullspace_basis(torch.from_numpy(_rows(x1, x2))).numpy(), basis, atol=2e-5)
    A = np.asarray(jfp._constraint_matrix(jnp.asarray(basis)))
    np.testing.assert_allclose(tfp._constraint_matrix(torch.from_numpy(basis)).numpy(), A, rtol=1e-5, atol=1e-6)
    R = np.asarray(jfp._gauss_jordan(jnp.asarray(A)))
    np.testing.assert_allclose(tfp._gauss_jordan(torch.from_numpy(A)).numpy(), R, rtol=1e-5, atol=1e-5)
    want = np.asarray(jfp._det_b(*jfp._b_rows(jnp.asarray(R))))
    got = tfp._det_b(*tfp._b_rows(torch.from_numpy(R))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_durand_kerner_on_separated_roots():
    rng = np.random.default_rng(2)
    roots = np.sort(rng.uniform(-1, 1, (64, 10)), axis=1) + 0.4 * np.arange(10)  # at least 0.4 apart
    roots = (roots - roots.mean(1, keepdims=True)) / np.ptp(roots, axis=1, keepdims=True) * 4.0  # span [-2, 2]
    lead = rng.uniform(0.5, 2.0, (64, 1))
    coeffs = (lead * np.stack([np.poly(r) for r in roots])).astype(np.float32)
    rj, okj = jfp.durand_kerner_roots(jnp.asarray(coeffs))
    rt, okt = tfp.durand_kerner_roots(torch.from_numpy(coeffs))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    got = np.sort(rt.numpy().real, axis=1)
    np.testing.assert_allclose(got, np.sort(np.asarray(rj).real, axis=1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, roots, rtol=1e-2, atol=1e-2)
    # a vanishing leading coefficient is not ok
    flat = coeffs[:2].copy()
    flat[:, 0] = 0.0
    assert not tfp.durand_kerner_roots(torch.from_numpy(flat))[1].any()


def _canon(E):
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.argmax(np.abs(E))])


def _gap_to(cands, E):
    return min((np.abs(_canon(c) - _canon(E)).max() for c in cands), default=np.inf)


def test_candidates_against_reference(scenes, candidates):
    _, _, Es = scenes
    Ej, vj, Et, vt = candidates
    assert Et.shape == (128, 10, 3, 3) and vt.shape == (128, 10)
    err_t = np.array([_gap_to(Et[b][vt[b]], Es[b]) for b in range(128)])
    err_j = np.array([_gap_to(Ej[b][vj[b]], Es[b]) for b in range(128)])
    assert np.mean(err_t < 1e-2) >= 0.85 and np.median(err_t) < 1e-4 and vt.any(axis=1).mean() >= 0.95
    same = []
    for b in range(128):
        a, c = Ej[b][vj[b]], Et[b][vt[b]]
        same.append(len(a) == len(c) and all(_gap_to(a, x) < 1e-4 for x in c))
    assert np.mean(same) >= 0.85
    both = (err_t < 1e-3) & (err_j < 1e-3)
    gaps = []
    for b in np.nonzero(both)[0]:
        near_t = min(Et[b][vt[b]], key=lambda c: np.abs(_canon(c) - _canon(Es[b])).max())
        gaps.append(_gap_to(Ej[b][vj[b]], near_t))
    assert max(gaps) < 1e-3 and np.median(gaps) < 1e-5
    assert np.isfinite(Et[vt]).all()


def test_masked_candidates_rank_last_after_kernel4():
    """Masked candidates may hold NaN: kernel 4 (its twin here) scores each row alone, so the
    unmasked rows stay finite, and the mask is applied to its output."""
    rng = np.random.default_rng(3)
    x1 = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 64, 2)).astype(np.float32))
    x2 = x1 + 0.01
    valid = torch.ones(2, 64, dtype=torch.bool)
    E = torch.from_numpy(rng.normal(size=(2, 30, 9)).astype(np.float32))
    E[:, ::3] = torch.nan
    E[1, 1] = torch.inf
    scores = msac_scores(E, build_msac_operand(x1, x2, valid, 1e-4))
    bad = ~torch.isfinite(E).all(dim=-1)
    assert torch.isfinite(scores[~bad]).all() and not torch.isfinite(scores[bad]).any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_estimate_relative_pose_five_point_matches_reference(seed):
    """A contaminated scene (40% outliers, 0.3 px noise, 20 invalid matches) given the reference's ranks."""
    rng = np.random.default_rng(seed)
    n = 256
    w = rng.normal(size=3)
    R = np.asarray(so3_exp(jnp.asarray(w / np.linalg.norm(w) * 0.2)))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-3, -2, 4], [3, 2, 15], size=(n, 3))
    p1, p2 = X @ K.T, (X @ R.T + t) @ K.T
    uv1 = (p1[:, :2] / p1[:, 2:]).astype(np.float32)
    uv2 = (p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    out = rng.choice(n, int(0.4 * n), replace=False)
    uv2[out] = rng.uniform([0, 0], [640, 480], size=(len(out), 2)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-20:] = False
    key = jax.random.PRNGKey(seed)
    kw = dict(num_hypotheses=256, sample_size=5, inlier_threshold_px=1.5)
    want = j_estimate(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), jnp.asarray(K), key, **kw)
    ranks = np.array(jax.random.randint(key, (256, 5), 0, int(valid.sum())))
    got = t_estimate(torch.from_numpy(uv1)[None], torch.from_numpy(uv2)[None], torch.from_numpy(valid)[None],
                     torch.from_numpy(K.astype(np.float32)), draws=torch.from_numpy(ranks)[None], **kw)
    assert bool(got.success[0]) == bool(want.success) and bool(want.success)
    np.testing.assert_allclose(got.R[0].numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t[0].numpy(), np.asarray(want.t), atol=1e-3)
    assert abs(int(got.num_inliers[0]) - int(want.num_inliers)) <= 2
    c = (np.trace(got.R[0].numpy().T @ R) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 1.0  # and it is the true motion
