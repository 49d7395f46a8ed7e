"""tpuslam_torch's two-view pose against tpuslam on the CPU.

Kernel 4's plain twin against ``msac_scores_pallas`` in interpret mode, the
matcher against the reference's, and ``estimate_relative_pose`` fed the
reference's own RANSAC draws on KITTI fixture pairs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.frontend import matcher as jm
from tpuslam.frontend import pose as jpose
from tpuslam.kernels.pose_pallas import build_msac_operand as j_build_operand
from tpuslam.kernels.pose_pallas import msac_scores_pallas
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import DetectorConfig
from tpuslam_torch.frontend import matcher as tm
from tpuslam_torch.frontend import pose as tpose
from tpuslam_torch.frontend.detector import FeatureDetector
from tpuslam_torch.kernels.pose import build_msac_operand, msac_scores, msac_scores_reference, msac_work

H_HYP, K_CAP = 256, 512


@pytest.fixture(scope="module")
def pairs(kitti_frames, data_dir):
    """Matched pixel points of fixture pairs (0,1), (3,4), (7,8) from the port's frontend."""
    cfg_dir = data_dir.parent.parent / "configs"
    det = FeatureDetector(
        dataclasses.replace(DetectorConfig.from_yaml(cfg_dir / "feature_detector.yml"), max_keypoints=K_CAP),
        device="cpu",
    )
    idx = [(0, 1), (3, 4), (7, 8)]
    frames = torch.from_numpy(np.stack([kitti_frames[i] for p in idx for i in p]))
    kps, desc = det.detect_and_compute_batch(frames)
    q, t = slice(0, None, 2), slice(1, None, 2)
    m = tm.match_descriptors(
        desc[q], desc[t], kps.valid[q], kps.valid[t], kps.xy[q], kps.xy[t], filter_matches=False
    )
    pts1 = torch.gather(kps.xy[q], 1, m.query_idx.clamp_min(0)[..., None].expand(-1, -1, 2))
    pts2 = torch.gather(kps.xy[t], 1, m.train_idx.clamp_min(0)[..., None].expand(-1, -1, 2))
    K = Camera.from_yaml(cfg_dir / "camera.yml").K.astype(np.float32)
    return dict(
        pts1=pts1.numpy(), pts2=pts2.numpy(), valid=m.valid.numpy(), K=K,
        kps=kps, desc=desc, match=m,
    )


def test_matcher_matches_reference(pairs):
    kps, desc, m = pairs["kps"], pairs["desc"], pairs["match"]
    for i in range(3):
        a, b = 2 * i, 2 * i + 1
        want = jm.match_descriptors(
            jnp.asarray(desc[a].numpy()), jnp.asarray(desc[b].numpy()),
            jnp.asarray(kps.valid[a].numpy()), jnp.asarray(kps.valid[b].numpy()),
            jnp.asarray(kps.xy[a].numpy()), jnp.asarray(kps.xy[b].numpy()),
            filter_matches=False,
        )
        np.testing.assert_array_equal(m.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(m.train_idx[i].numpy(), np.asarray(want.train_idx))
        np.testing.assert_array_equal(m.distance[i].numpy(), np.asarray(want.distance))
    assert int(m.valid.sum()) > 60
    # the filtered (global top-k) form
    want = jm.match_descriptors(
        jnp.asarray(desc[0].numpy()), jnp.asarray(desc[1].numpy()),
        jnp.asarray(kps.valid[0].numpy()), jnp.asarray(kps.valid[1].numpy()),
        good_matches_count=20,
    )
    got = tm.match_descriptors(desc[0], desc[1], kps.valid[0], kps.valid[1], good_matches_count=20)
    np.testing.assert_array_equal(got.query_idx.numpy(), np.asarray(want.query_idx))
    np.testing.assert_array_equal(got.train_idx.numpy(), np.asarray(want.train_idx))


def test_kernel4_twin_matches_pallas(pairs):
    """Twin vs the Pallas kernel in interpret mode, rtol 1e-5 (float32 summation order)."""
    rng = np.random.default_rng(11)
    K = jnp.asarray(pairs["K"])
    x1 = np.array(jpose.normalize_points(K, jnp.asarray(pairs["pts1"][0])))
    x2 = np.array(jpose.normalize_points(K, jnp.asarray(pairs["pts2"][0])))
    valid = pairs["valid"][0]
    thr = np.float32((1.0 / 982.5) ** 2)
    E = (rng.normal(size=(H_HYP, 9)) * 0.3).astype(np.float32)
    P_j = j_build_operand(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jnp.asarray(thr))
    want = np.asarray(msac_scores_pallas(jnp.asarray(E), P_j, interpret=True))
    P_t = build_msac_operand(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_j))
    got = msac_scores(torch.from_numpy(E)[None], P_t[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert torch.equal(
        msac_scores(torch.from_numpy(E)[None], P_t[None]),
        msac_scores_reference(torch.from_numpy(E)[None], P_t[None]),
    )


def test_kernel4_twin_matches_pallas_two_grid_steps_and_invalid_pair():
    """A second (H, M): H 512 is two steps of the Pallas grid (block_h 256), M 384;
    the batch lifted with vmap, its last pair without a valid match scoring exactly 0."""
    rng = np.random.default_rng(12)
    B, H, M = 3, 512, 384
    x1 = rng.uniform(-0.6, 0.6, (B, M, 2)).astype(np.float32)
    x2 = x1 + rng.normal(0, 2e-3, (B, M, 2)).astype(np.float32)
    valid = rng.random((B, M)) > 0.15
    valid[2] = False
    thr = np.float32(1e-6)
    E = (rng.normal(size=(B, H, 9)) * 0.3).astype(np.float32)
    P_j = j_build_operand(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jnp.asarray(thr))
    want = np.asarray(jax.vmap(lambda e, p: msac_scores_pallas(e, p, interpret=True))(jnp.asarray(E), P_j))
    P_t = build_msac_operand(torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid), thr)
    np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_j))
    got = msac_scores(torch.from_numpy(E), P_t).numpy()
    assert got.shape == (B, H)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not got[2].any() and not want[2].any()
    assert (got[:2] > 0).all()


def test_kernel4_bound_at_main_path_shapes():
    """The yardstick a redesign is held to: 97 float32 operations per (hypothesis, match)."""
    work = msac_work(16, 1024, 1024)
    assert work.ops == 97 * 16 * 1024 * 1024 and work.bytes == 4 * (16 * 1024 * 9 + 16 * 45 * 1024 + 16 * 1024)
    assert work.bound_by() == "operations"
    assert round(work.bound_us(), 2) == 24.29


def test_estimate_relative_pose_matches_with_reference_draws(pairs):
    B = pairs["valid"].shape[0]
    K = jnp.asarray(pairs["K"])
    keys = jax.vmap(lambda f: jax.random.fold_in(jax.random.PRNGKey(0), f))(jnp.arange(B))
    n_valid = pairs["valid"].sum(axis=-1)
    draws = np.stack([
        np.asarray(jax.random.randint(keys[i], (H_HYP, 8), 0, jnp.maximum(jnp.int32(n_valid[i]), 1)))
        for i in range(B)
    ])
    want = jax.vmap(
        lambda p1, p2, v, k: jpose.estimate_relative_pose(p1, p2, v, K, k, num_hypotheses=H_HYP)
    )(jnp.asarray(pairs["pts1"]), jnp.asarray(pairs["pts2"]), jnp.asarray(pairs["valid"]), keys)
    got = tpose.estimate_relative_pose(
        torch.from_numpy(pairs["pts1"]), torch.from_numpy(pairs["pts2"]),
        torch.from_numpy(pairs["valid"]), torch.from_numpy(pairs["K"]),
        draws=torch.from_numpy(draws), num_hypotheses=H_HYP,
    )
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert got.success.all()
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    assert np.all(np.abs(got.num_inliers.numpy() - np.asarray(want.num_inliers)) <= 2)
    # triangulation of the matched points with the recovered pose
    Xw = jax.vmap(lambda R, t, a, b: jpose.triangulate_matched_points(K, R, t, a, b))(
        want.R, want.t, jnp.asarray(pairs["pts1"]), jnp.asarray(pairs["pts2"])
    )
    Xt = tpose.triangulate_matched_points(
        torch.from_numpy(pairs["K"]), torch.from_numpy(np.array(want.R)),
        torch.from_numpy(np.array(want.t)), torch.from_numpy(pairs["pts1"]),
        torch.from_numpy(pairs["pts2"]),
    )
    inl = np.asarray(want.inliers)
    np.testing.assert_allclose(Xt.numpy()[inl], np.asarray(Xw)[inl], rtol=1e-3, atol=1e-3)


def test_estimate_relative_pose_generator_draws(pairs):
    """The default draws come from a torch.Generator: deterministic per seed, in range."""
    args = [torch.from_numpy(pairs[k]) for k in ("pts1", "pts2", "valid", "K")]
    g = torch.Generator().manual_seed(3)
    a = tpose.estimate_relative_pose(*args, g, num_hypotheses=H_HYP)
    b = tpose.estimate_relative_pose(*args, torch.Generator().manual_seed(3), num_hypotheses=H_HYP)
    assert torch.equal(a.R, b.R) and a.success.all()
    n = torch.tensor([0, 1, 7])
    r = tpose.draw_ranks(n, 64, 8, torch.Generator().manual_seed(0))
    assert int(r[0].max()) == 0 and int(r[1].max()) == 0 and 0 <= int(r[2].min()) and int(r[2].max()) <= 6


def test_decompose_essential_svd_signs_absorbed(pairs):
    """torch's 3×3 SVD may flip singular-vector signs against JAX's: the candidate
    set {R1, R2} × {±t} is the same either way."""
    rng = np.random.default_rng(2)
    for _ in range(5):
        E = np.array(jpose._solve_e_from_rows(jnp.asarray(rng.normal(size=(9, 9)).astype(np.float32))))
        jR1, jR2, jt = (np.asarray(x) for x in jpose.decompose_essential(jnp.asarray(E)))
        tR1, tR2, tt = (x.numpy() for x in tpose.decompose_essential(torch.from_numpy(E)))
        want = sorted([jR1.round(4).tolist(), jR2.round(4).tolist()])
        got = sorted([tR1.round(4).tolist(), tR2.round(4).tolist()])
        np.testing.assert_allclose(np.array(got), np.array(want), atol=2e-4)
        assert min(np.abs(tt - jt).max(), np.abs(tt + jt).max()) < 1e-4


def test_five_point_not_ported(pairs):
    """The five-point path (ported since; its parity with the reference is ``test_torch_fivepoint.py``):
    on the fixture pairs, from the port's own draws, it finds the pose the eight-point path finds."""
    args = [torch.from_numpy(pairs[k]) for k in ("pts1", "pts2", "valid", "K")]
    gen = torch.Generator().manual_seed(0)
    five = tpose.estimate_relative_pose(*args, gen, num_hypotheses=64, sample_size=5, inlier_threshold_px=2.0)
    eight = tpose.estimate_relative_pose(*args, gen, num_hypotheses=H_HYP, inlier_threshold_px=2.0)
    assert five.success.all() and eight.success.all()
    cos = (torch.einsum("bij,bij->b", five.R, eight.R) - 1) / 2
    assert (torch.rad2deg(torch.arccos(cos.clamp(-1, 1))) < 1.0).all()
    assert ((five.t * eight.t).sum(-1) > 0.99).all()
