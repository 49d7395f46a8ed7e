"""tpuslam_torch.backend.pnp (and the SO(3) helpers it uses) against tpuslam's on the CPU.

The same seeded numpy inputs go through both packages.  Tolerances: the
closed-form helpers to 1e-6; the DLT and Gauss-Newton solvers to float32
rounding of their solves (R 1e-5, t 1e-4 absolute, and 1e-4 relative for
six-point DLT solves, whose conditioning amplifies rounding); ``ransac_pnp``, given
the reference's own sample indices (its Gumbel noise recomputed from the
same key and mask), identical inliers, inlier count and success, R and t
to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.backend import pnp as jpnp
from tpuslam.common import geometry as jgeo
from tpuslam_torch.backend import pnp as tpnp
from tpuslam_torch.common import geometry as tgeo

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def jax_gumbel_samples(key, valid: np.ndarray, H: int, S: int = 6) -> np.ndarray:
    """The reference's RANSAC-PnP sample indices: Gumbel noise, masked, iterated argmax."""
    g = np.asarray(jax.random.gumbel(key, (H, valid.shape[0]), jnp.float32))
    g = np.where(valid[None, :], g, -np.inf)
    cols = []
    for _ in range(S):
        i = np.argmax(g, axis=1)  # the first maximum, as jnp.argmax
        cols.append(i)
        g[np.arange(H), i] = -np.inf
    return np.stack(cols, axis=1)


def synthetic(n, rng, outlier_frac=0.0, noise_px=0.0):
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * 0.4
    R = np.asarray(jgeo.so3_exp(jnp.asarray(w, jnp.float32)), np.float64)
    t = np.array([0.3, -0.2, 0.5])
    X = rng.uniform([-3, -2, 4], [3, 2, 12], size=(n, 3))
    pix = (X @ R.T + t) @ K.T
    uv = pix[:, :2] / pix[:, 2:] + rng.normal(size=(n, 2)) * noise_px
    n_out = int(n * outlier_frac)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] = rng.uniform([0, 0], [640, 480], (n_out, 2))
    return X.astype(np.float32), uv.astype(np.float32), R.astype(np.float32), t.astype(np.float32)


def perturbed(R, t, deg, t_off, rng):
    w = rng.normal(size=3)
    w = (w / np.linalg.norm(w) * np.radians(deg)).astype(np.float32)
    dR = np.asarray(jgeo.so3_exp(jnp.asarray(w)))
    return (dR @ R).astype(np.float32), (t + t_off).astype(np.float32)


def T(x):
    return torch.from_numpy(np.asarray(x))


def test_hat_and_so3_exp_match_reference():
    """Both Rodrigues branches (θ² below and above 1e-8) to 1e-6."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:8] *= 1e-5  # the Taylor branch
    w[8] = 0.0
    np.testing.assert_array_equal(tgeo.hat(T(w)).numpy(), np.asarray(jgeo.hat(jnp.asarray(w))))
    np.testing.assert_allclose(
        tgeo.so3_exp(T(w)).numpy(), np.asarray(jgeo.so3_exp(jnp.asarray(w))), atol=1e-6
    )


def test_nullvec_jacobi_caches_its_schedule():
    A = torch.from_numpy(np.random.default_rng(1).normal(size=(5, 12, 12)).astype(np.float32))
    first = tgeo.nullvec_jacobi(A, sweeps=2)
    cached = tgeo._schedule_indices(12, A.device)
    assert tgeo._schedule_indices(12, A.device) is cached
    assert torch.equal(tgeo.nullvec_jacobi(A, sweeps=2), first)


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_pnp_dlt_matches_reference(weighted):
    """Batched over 32 six-point samples, and the weighted refit over all 80 points."""
    rng = np.random.default_rng(2)
    X, uv, _, _ = synthetic(80, rng, noise_px=0.3)
    xn = ((uv - K[:2, 2]) / np.diag(K)[:2]).astype(np.float32)
    if weighted:
        w = (rng.random(80) > 0.2).astype(np.float32)
        want = jpnp.solve_pnp_dlt(jnp.asarray(X), jnp.asarray(xn), jnp.asarray(w))
        got = tpnp.solve_pnp_dlt(T(X), T(xn), T(w))
    else:
        idx = np.stack([rng.choice(80, 6, replace=False) for _ in range(32)])
        want = jpnp.solve_pnp_dlt(jnp.asarray(X[idx]), jnp.asarray(xn[idx]), sweeps=6)
        got = tpnp.solve_pnp_dlt(T(X[idx]), T(xn[idx]), sweeps=6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    # a six-point solve amplifies rounding: one sample's t of 5.85 differs by 1.7e-4
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-4)


def test_reprojection_errors_match_reference():
    """Errors to 1e-4 px, depths to 1e-5, over 16 poses x 60 points."""
    rng = np.random.default_rng(3)
    X, uv, R, t = synthetic(60, rng, outlier_frac=0.2)
    Rs = np.stack([perturbed(R, t, 5.0, rng.normal(size=3) * 0.1, rng)[0] for _ in range(16)])
    ts = (t + rng.normal(size=(16, 3)) * 0.1).astype(np.float32)
    err_w, z_w = jpnp.reprojection_errors(jnp.asarray(K), jnp.asarray(Rs), jnp.asarray(ts), jnp.asarray(X),
                                          jnp.asarray(uv))
    err_g, z_g = tpnp.reprojection_errors(T(K), T(Rs), T(ts), T(X), T(uv))
    np.testing.assert_allclose(err_g.numpy(), np.asarray(err_w), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z_g.numpy(), np.asarray(z_w), rtol=1e-5, atol=1e-5)


def test_refine_pnp_gn_matches_reference():
    """Gauss-Newton polish from a 2-degree seed with 0/1 weights: R 1e-5, t 1e-4."""
    rng = np.random.default_rng(4)
    X, uv, R, t = synthetic(70, rng, outlier_frac=0.2, noise_px=0.5)
    R0, t0 = perturbed(R, t, 2.0, np.array([0.03, -0.02, 0.05]), rng)
    w = (rng.random(70) > 0.3).astype(np.float32)
    want = jpnp.refine_pnp_gn(jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                              jnp.asarray(uv), jnp.asarray(w))
    got = tpnp.refine_pnp_gn(T(K), T(R0), T(t0), T(X), T(uv), T(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)


@pytest.mark.parametrize(
    "case",
    ["converges", "outliers", "teleport", "no_valid"],
)
def test_motion_pnp_matches_reference(case):
    """Success and inliers identical; R 1e-5, t 1e-4 (all gates of the tracker's use)."""
    rng = np.random.default_rng({"converges": 21, "outliers": 23, "teleport": 26, "no_valid": 25}[case])
    frac, noise = (0.3, 0.5) if case == "outliers" else (0.0, 0.0)
    X, uv, R, t = synthetic(100, rng, outlier_frac=frac, noise_px=noise)
    if case == "teleport":
        R0, t0 = perturbed(R, t, 60.0, np.array([3.0, -2.0, 1.5]), rng)
    else:
        R0, t0 = perturbed(R, t, 2.0, np.array([-0.04, 0.02, 0.06]), rng)
    valid = np.zeros(100, bool) if case == "no_valid" else rng.random(100) > 0.1
    kw = dict(iters=3, min_inliers=12, huber_schedule=(16.0, 8.0, 2.0))
    want = jpnp.motion_pnp(jnp.asarray(K), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X), jnp.asarray(uv),
                           jnp.asarray(valid), **kw)
    got = tpnp.motion_pnp(T(K), T(R0), T(t0), T(X), T(uv), T(valid), **kw)
    assert bool(got.success) == bool(want.success)
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-5)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    if case == "converges":
        assert bool(got.success) and int(got.num_inliers) > 80


@pytest.mark.parametrize(
    "refine,lo_rounds,hyp_sweeps",
    [("dlt", 2, None), ("gn", 1, 6)],  # the default, and the tracker's fallback
)
def test_ransac_pnp_given_reference_samples(refine, lo_rounds, hyp_sweeps):
    """Identical inliers, count and success; R, t to 1e-4."""
    rng = np.random.default_rng(7)
    X, uv, R, t = synthetic(120, rng, outlier_frac=0.25, noise_px=0.2)
    valid = rng.random(120) > 0.15
    key = jax.random.PRNGKey(11)
    kw = dict(num_hypotheses=64, min_inliers=12, refine=refine, lo_rounds=lo_rounds, hyp_sweeps=hyp_sweeps)
    want = jpnp.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K), key, **kw)
    idx = jax_gumbel_samples(key, valid, 64)
    assert valid[idx].all() and all(len(set(r)) == 6 for r in idx.tolist())
    got = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(K), T(idx), **kw)
    assert bool(got.success) and bool(want.success)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), R, atol=5e-3)


def test_ransac_pnp_with_fewer_than_six_valid():
    """Four valid matches: every pick after them is index 0 in both packages; no success."""
    rng = np.random.default_rng(8)
    X, uv, _, _ = synthetic(40, rng)
    valid = np.zeros(40, bool)
    valid[[3, 9, 17, 30]] = True
    key = jax.random.PRNGKey(3)
    idx = jax_gumbel_samples(key, valid, 16)
    assert (idx[:, 4:] == 0).all()
    gen = torch.Generator().manual_seed(0)
    own = tpnp.gumbel_sample_indices(T(valid), 16, 6, gen)
    assert (own[:, 4:] == 0).all() and valid[own[:, :4].numpy()].all()
    want = jpnp.ransac_pnp(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K), key,
                           num_hypotheses=16)
    got = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(K), T(idx), num_hypotheses=16)
    assert not bool(got.success) and not bool(want.success)
    np.testing.assert_array_equal(got.R.numpy(), np.eye(3, dtype=np.float32))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))


def test_own_draws_are_distinct_valid_and_seeded():
    """Without sample indices: six distinct valid matches a hypothesis, the same for the same seed."""
    valid = torch.from_numpy(np.random.default_rng(9).random(200) > 0.5)
    draw = lambda s: tpnp.gumbel_sample_indices(valid, 64, 6, torch.Generator().manual_seed(s))  # noqa: E731
    a = draw(5)
    assert torch.equal(a, draw(5)) and not torch.equal(a, draw(6))
    assert valid[a].all() and all(len(set(r)) == 6 for r in a.tolist())
