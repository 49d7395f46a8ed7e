"""tpuslam_torch.backend.ba against tpuslam's bundle adjustment on the CPU.

Windows are built with the reference's own map functions and crossed over by
``map_state_from_numpy``: synthetic ones from a numpy seed (the construction
of the reference's ``tests/test_ba.py``, copied), and the reference's own map
after the 10 KITTI fixture frames.  The closed-form Jacobian blocks are held
to ``jax.jacfwd`` of the reference's delta parameterisation.

Both packages optimise the same window twice: in float32, as they run, and
in float64 (the reference under ``jax.enable_x64``).  In float64 every case
agrees to 1e-11 or better at every LM step, so the tests hold the algorithm
there tightly: costs rtol 1e-9, poses 1e-8, points 1e-8 and rtol 1e-7 (the
reference writes the compacted points back through a one-hot float32
matmul, which rounds them to float32 even under x64).  In float32 the
well-conditioned windows agree to the stated tolerances (costs rtol 1e-4,
poses and points 1e-4, the step counts exactly).

Finding (float32 on poorly conditioned windows).  The Schur system's scale
direction is held only by λ, so float32 rounding in the Hessian sums and the
48×48 solve moves the step by far more than an ulp, in both packages, by
different amounts since they sum in different orders.  Against the float64
optimum after the same steps, measured on the CPU (the port on one thread):
the reference's own float32 poses are up to 2.1e-2 off on the fixture map
(LM step 3) and 1.9e-3 on the outlier window, the port's 1.2e-2 and 6.9e-5.
On the fixture map the port's float32 step 3 raises the cost and is rejected
(19.344494 kept) where the reference's is accepted (19.143042); after 4
steps the final costs are 19.184000 and 19.084230 (5.2e-3 apart; float64:
19.076569428 both) and the poses 4.7e-3 apart.  Those windows are held in
float32 to: initial costs rtol 1e-5, final costs 1%, poses 1e-2
(``ILL_CONDITIONED``; the spread window of the stable-selection test is one
too).  The port runs on one CPU thread here (``one_torch_thread``) so that
its sums, and so these float32 numbers, do not depend on the machine's
core count (``test_torch_system.py`` measures what eight threads change).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_map import reference_fixture_chunks
from tpuslam.backend import ba as jba
from tpuslam.backend import map as jmap
from tpuslam.common.geometry import so3_exp
from tpuslam_torch.backend import ba as tba
from tpuslam_torch.utils.convert import map_state_from_numpy

K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread: its float32 sums then run in one order on any machine,
    which the float32 LM steps are sensitive to (the finding above)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_map(seed=9, n_frames=4, n_points=200, noise_px=0.5, pose_noise=0.02, point_noise=0.05,
                  window=8, capacity=512, spread=False, outliers=0):
    """A ground-truth scene observed by ``n_frames`` keyframes, perturbed, in a reference MapState.

    With ``spread`` the points go to scattered slots (every other one is
    allocated and left unobserved), so that the observed slots are not a
    prefix of the capacity; ``outliers`` observations of keyframe 1 are
    moved 50-200 px.
    """
    rng = np.random.default_rng(seed)
    X_gt = rng.uniform([-4, -3, 6], [4, 3, 18], size=(n_points, 3))
    Rs = [np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * 0.05))) for _ in range(n_frames)]
    ts = [np.array([0.8 * i, 0.0, 0.0]) + rng.normal(size=3) * 0.05 for i in range(n_frames)]
    m = jmap.empty_map(window=window, max_points=capacity)
    slots = []
    for i in range(n_frames):
        R_init, t_init = Rs[i], ts[i]
        if i:  # pose 0 exact: the gauge anchor
            R_init = np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * pose_noise))) @ Rs[i]
            t_init = ts[i] + rng.normal(size=3) * pose_noise * 5
        m, s = jmap.insert_keyframe(m, i, jnp.asarray(R_init, jnp.float32), jnp.asarray(t_init, jnp.float32))
        slots.append(s)
    X_init = X_gt + rng.normal(size=X_gt.shape) * point_noise
    if spread:
        both = np.repeat(X_init, 2, axis=0)
        m, pslots = jmap.insert_points(m, jnp.asarray(both, jnp.float32), jnp.ones(2 * n_points, bool))
        pslots = pslots[::2]
    else:
        m, pslots = jmap.insert_points(m, jnp.asarray(X_init, jnp.float32), jnp.ones(n_points, bool))
    for i, s in enumerate(slots):
        cam = X_gt @ Rs[i].T + ts[i]
        pix = cam @ K.T
        uv = pix[:, :2] / pix[:, 2:] + rng.normal(size=(n_points, 2)) * noise_px
        if i == 1 and outliers:
            uv[rng.choice(n_points, outliers, replace=False)] += rng.uniform(50, 200, (outliers, 2))
        m = jmap.add_observations(m, s, pslots, jnp.asarray(uv, jnp.float32), jnp.ones(n_points, bool))
    return m


FLOATS = ("kf_R", "kf_t", "points", "obs_uv")


def run_both(jm, K_, x64=False, **kw):
    """The same window through both packages' bundle_adjust, in float32 or float64."""
    tm = map_state_from_numpy(jm)
    Kt = torch.from_numpy(np.array(K_, np.float32))
    if not x64:
        return tba.bundle_adjust(tm, Kt, **kw), jba.bundle_adjust(jm, jnp.asarray(K_, jnp.float32), **kw)
    tm = tm._replace(**{k: torch.from_numpy(np.asarray(getattr(jm, k), np.float64)) for k in FLOATS})
    with jax.enable_x64(True):
        jm = jm._replace(**{k: jnp.asarray(np.asarray(getattr(jm, k)), jnp.float64) for k in FLOATS})
        want = jax.tree.map(np.asarray, jba.bundle_adjust(jm, jnp.asarray(K_, jnp.float32), **kw))
    return tba.bundle_adjust(tm, Kt, **kw), want


def assert_ba_close(got, want, x64=False, ill_conditioned=False):
    """Costs rtol 1e-4, poses and points 1e-4 (float64: 1e-9 and 1e-8); integer fields identical."""
    tol = 1e-8 if x64 else 1e-4
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost), rtol=1e-9 if x64 else 1e-5)
    if ill_conditioned and not x64:  # the finding in the module docstring
        np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-2)
        np.testing.assert_allclose(got.map.kf_R.numpy(), np.asarray(want.map.kf_R), atol=1e-2)
        np.testing.assert_allclose(got.map.kf_t.numpy(), np.asarray(want.map.kf_t), atol=1e-2)
    else:
        np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-9 if x64 else 1e-4)
        np.testing.assert_allclose(got.map.kf_R.numpy(), np.asarray(want.map.kf_R), atol=tol)
        np.testing.assert_allclose(got.map.kf_t.numpy(), np.asarray(want.map.kf_t), atol=tol)
        np.testing.assert_allclose(got.map.points.numpy(), np.asarray(want.map.points), rtol=1e-7 if x64 else tol,
                                   atol=tol)
    for name in ("kf_id", "kf_valid", "point_valid", "point_birth", "obs_mask", "obs_uv"):
        np.testing.assert_array_equal(getattr(got.map, name).numpy(), np.asarray(getattr(want.map, name)))


def test_inv3x3_matches_reference():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(300, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3, dtype=np.float32)  # damped normal blocks
    want = np.asarray(jba._inv3x3(jnp.asarray(A)))
    got = tba._inv3x3(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got @ A, np.broadcast_to(np.eye(3), A.shape), atol=2e-2)


def test_closed_form_blocks_match_reference_jacfwd():
    """The port's blocks against forward-mode autodiff of the reference's residual."""
    Kj = jnp.asarray([[700.0, 0, 600.0], [0, 700.0, 180.0], [0, 0, 1.0]])
    R = so3_exp(jnp.asarray([0.02, -0.1, 0.03]))
    t = jnp.asarray([0.4, -0.2, 1.5])
    uv = jnp.asarray([300.0, 200.0])
    key = jax.random.PRNGKey(3)
    tt = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    jac = jax.jit(jax.jacfwd(jba._residual_with_delta, argnums=(0, 1)))
    for i in range(5):
        X = jax.random.uniform(jax.random.fold_in(key, i), (3,), minval=-3.0, maxval=3.0) + jnp.asarray([0, 0, 8.0])
        Ja, Jb = jac(jnp.zeros(6), jnp.zeros(3), R, t, X, uv, Kj)
        A, B, r = tba._blocks(tt(R), tt(t), tt(X), tt(uv), tt(Kj))
        np.testing.assert_allclose(A.numpy(), np.asarray(Ja), atol=1e-4)
        np.testing.assert_allclose(B.numpy(), np.asarray(Jb), atol=1e-4)
        np.testing.assert_allclose(r.numpy(), np.asarray(jba._project_residual(R, t, X, uv, Kj)), atol=1e-4)
        d_pose = jnp.asarray([0.01, -0.02, 0.005, 0.1, 0.0, -0.05])
        d_pt = jnp.asarray([0.05, 0.0, -0.1])
        np.testing.assert_allclose(
            tba._residual_with_delta(tt(d_pose), tt(d_pt), tt(R), tt(t), tt(X), tt(uv), tt(Kj)).numpy(),
            np.asarray(jba._residual_with_delta(d_pose, d_pt, R, t, X, uv, Kj)), atol=1e-4)


def test_cost_matches_reference():
    jm = synthetic_map(noise_px=2.0)
    tm = map_state_from_numpy(jm)
    mask = jm.obs_mask & jm.kf_valid[:, None] & jm.point_valid[None, :]
    want = float(jba._cost(jm.kf_R, jm.kf_t, jm.points, jm.obs_uv, mask, jnp.asarray(K), jnp.float32(2.0)))
    got = float(tba._cost(tm.kf_R, tm.kf_t, tm.points, tm.obs_uv, torch.from_numpy(np.asarray(mask)),
                          torch.from_numpy(K), 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(float(tba._huber_weight(torch.tensor(3.0), 2.0)), 2.0 / 3.0)


# case → (synthetic_map arguments, bundle_adjust arguments)
BA_CASES = {
    "compacted": (dict(), dict(iterations=6, active_points=256)),
    "full_grid": (dict(), dict(iterations=6, active_points=None)),
    "rtol_early_exit": (dict(), dict(iterations=20, rtol=1e-3)),
    "budget_overflow": (dict(n_points=200), dict(iterations=4, active_points=128)),
    "outliers": (dict(n_points=150, outliers=15), dict(iterations=8)),
}
ILL_CONDITIONED = {"outliers", "gauge", "fixture_map"}


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(BA_CASES))
def test_bundle_adjust_matches_reference(case, x64):
    map_kw, ba_kw = BA_CASES[case]
    jm = synthetic_map(**map_kw)
    got, want = run_both(jm, K, x64=x64, **ba_kw)
    assert_ba_close(got, want, x64, case in ILL_CONDITIONED)
    assert float(got.final_cost) < float(got.initial_cost)
    if case == "rtol_early_exit":
        assert int(got.iterations) < 20
    if case == "budget_overflow":  # the leftovers keep their exact values
        moved = (got.map.points != map_state_from_numpy(jm).points).any(dim=1)
        assert 64 < int(moved.sum()) <= 128


def test_stable_selection_pins_the_lowest_observed_slots():
    """200 observed points spread over 400 allocated slots, a budget of 64: the first 64
    observed slots in ascending order move, as in the reference, and nothing else does.
    A top-k of the 0/1 mask, which promises no order among ties, could pick any 64."""
    jm = synthetic_map(seed=4, n_points=200, spread=True)
    for x64 in (False, True):
        got, want = run_both(jm, K, x64=x64, iterations=4, active_points=64)
        assert_ba_close(got, want, x64, ill_conditioned=True)
    observed = np.flatnonzero(np.asarray(jm.obs_mask).any(axis=0))
    moved = np.flatnonzero((got.map.points != map_state_from_numpy(jm).points).any(dim=1).numpy())
    np.testing.assert_array_equal(moved, observed[:64])


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_gauge_oldest_keyframe_fixed_and_baseline_kept(x64):
    """The oldest keyframe (by frame id, here not in slot 0) stays put, and the baseline
    between the two oldest keeps its input length."""
    jm = synthetic_map(n_frames=5, seed=12)
    jm = jm._replace(kf_id=jnp.asarray([7, 9, 3, 5, 8, -1, -1, -1], jnp.int32))  # oldest in slot 2, then 3
    got, want = run_both(jm, K, x64=x64, iterations=5)
    assert_ba_close(got, want, x64, ill_conditioned=True)
    R0, t0 = np.asarray(jm.kf_R), np.asarray(jm.kf_t)
    np.testing.assert_array_equal(got.map.kf_R[2].numpy(), R0[2])
    # t is rebuilt from the rescaled centre, so it moves by rounding (the reference's own test: 1e-6)
    np.testing.assert_allclose(got.map.kf_t[2].numpy(), t0[2], atol=1e-6)
    assert not np.allclose(got.map.kf_t[0].numpy(), t0[0], atol=1e-6)  # slot 0 is free

    def centre(R, t):
        return -R.T @ t

    b_in = np.linalg.norm(centre(R0[3], t0[3]) - centre(R0[2], t0[2]))
    Rg, tg = got.map.kf_R.numpy(), got.map.kf_t.numpy()
    b_out = np.linalg.norm(centre(Rg[3], tg[3]) - centre(Rg[2], tg[2]))
    np.testing.assert_allclose(b_out, b_in, rtol=1e-5)


@pytest.fixture(scope="module")
def fixture_map(data_dir):
    chunks, Kf = reference_fixture_chunks(data_dir)
    jm, ja = jmap.empty_map(8, 4096), jmap.empty_assoc(512)
    for ch in chunks:
        jm, ja = jmap.update_map_chunk_batched(jm, ja, jnp.asarray(Kf), **{k: jnp.asarray(v) for k, v in ch.items()})
    return jm, Kf


@pytest.mark.parametrize("x64", [False, True], ids=["float32", "float64"])
def test_bundle_adjust_on_the_reference_fixture_map(fixture_map, x64):
    """The reference's own map after the 10 fixture frames (window 8, 4096 points), at
    SlamSystem's BA settings (4 LM steps, 512 active points)."""
    jm, Kf = fixture_map
    assert int(np.asarray(jm.obs_mask).any(axis=0).sum()) > 100
    got, want = run_both(jm, Kf, x64=x64, iterations=4, active_points=512)
    assert_ba_close(got, want, x64, ill_conditioned=True)
    assert float(got.final_cost) < 0.9 * float(got.initial_cost)
