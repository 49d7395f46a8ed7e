"""The single-pair facades and small entry points: tpuslam_torch against tpuslam on the CPU.

``PoseEstimator`` given the reference's draws (``randint(PRNGKey(seed),
…)``, which its ``key=None`` uses), ``FeatureMatcher`` (and its refusal of
L2), ``FrameStream.__iter__`` with ``frame_skip``, ``python -m
tpuslam_torch.evaluate`` against ``tools/evaluate.py``'s JSON line on the
same files (both run in-process through ``main(argv)``), the CLI's
``--debug``, and the device every public constructor and loader of the
port defaults to.  Inputs are numpy draws from fixed seeds or the KITTI
fixtures; tolerances are stated in each test.
"""

import importlib.util
import inspect
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import MatcherConfig as JMatcherConfig
from tpuslam.config.schema import PoseConfig as JPoseConfig
from tpuslam.frontend import fast as jfast
from tpuslam.frontend import matcher as jmatcher
from tpuslam.frontend import pose as jpose
from tpuslam.pre.stream import FrameStream as JFrameStream
from tpuslam_torch import cli, evaluate
from tpuslam_torch.backend.loop_closure import LoopClosure
from tpuslam_torch.backend.vocabulary import Vocabulary
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import MatcherConfig as TMatcherConfig
from tpuslam_torch.config.schema import PoseConfig as TPoseConfig
from tpuslam_torch.frontend import matcher as tmatcher
from tpuslam_torch.frontend import pose as tpose
from tpuslam_torch.frontend.detector import FeatureDetector
from tpuslam_torch.frontend.fast import KeypointSet
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.model.system import SlamSystem
from tpuslam_torch.post.trajectory import save_kitti_trajectory
from tpuslam_torch.pre.stream import FrameStream as TFrameStream


def test_public_entry_points_default_to_the_card():
    """Every public constructor and loader of the port runs on ``cuda`` unless told otherwise."""
    for fn in (SlamPipeline, SlamSystem, FeatureDetector, LoopClosure, Vocabulary.load, Vocabulary.fit,
               tpose.PoseEstimator):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


@pytest.fixture(scope="module")
def camera(data_dir):
    return data_dir.parent.parent / "configs" / "camera.yml"


@pytest.fixture(scope="module")
def matches(camera):
    K = JCamera.from_yaml(camera).K
    rng = np.random.default_rng(3)
    M = 300
    X = np.stack([rng.uniform(-8, 8, M), rng.uniform(-3, 3, M), rng.uniform(6, 40, M)], -1)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.1, 0.0, -1.0])

    def proj(P):
        x = P @ K.T
        return x[:, :2] / x[:, 2:]

    pts1 = proj(X) + rng.normal(0, 0.3, (M, 2))
    pts2 = proj(X @ R.T + t) + rng.normal(0, 0.3, (M, 2))
    out = rng.random(M) < 0.2
    pts2[out] = rng.uniform([0, 0], [1392, 512], (int(out.sum()), 2))
    valid = rng.random(M) > 0.1
    return pts1.astype(np.float32), pts2.astype(np.float32), valid


def test_pose_estimator_given_reference_draws(camera, matches):
    """Integer fields identical, R 1e-4, t 1e-3 (the VO slice's bars); triangulated inliers 1e-3."""
    pts1, pts2, valid = matches
    cfg = JPoseConfig(num_hypotheses=512)
    want = jpose.PoseEstimator(JCamera.from_yaml(camera), cfg).estimate(
        jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(valid))
    n_valid = int(valid.sum())
    draws = np.array(jax.random.randint(jax.random.PRNGKey(cfg.seed), (512, 8), 0, n_valid))
    est = tpose.PoseEstimator(TCamera.from_yaml(camera), TPoseConfig(num_hypotheses=512), device="cpu")
    got = est.estimate(torch.from_numpy(pts1), torch.from_numpy(pts2), torch.from_numpy(valid),
                       draws=torch.from_numpy(draws))
    assert bool(got.success) and bool(want.success)
    assert int(got.num_inliers) == int(want.num_inliers) > 150
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-3)
    # seeded from the config by default: the same result twice
    again = est.estimate(torch.from_numpy(pts1), torch.from_numpy(pts2), torch.from_numpy(valid))
    assert torch.equal(again.R, est.estimate(torch.from_numpy(pts1), torch.from_numpy(pts2),
                                             torch.from_numpy(valid)).R)
    X_want = np.asarray(jpose.PoseEstimator(JCamera.from_yaml(camera), cfg).triangulate_points(
        want.R, want.t, jnp.asarray(pts1), jnp.asarray(pts2)))
    X_got = est.triangulate_points(torch.from_numpy(np.array(want.R)), torch.from_numpy(np.array(want.t)),
                                   torch.from_numpy(pts1), torch.from_numpy(pts2)).numpy()
    inl = np.asarray(want.inliers)
    np.testing.assert_allclose(X_got[inl], X_want[inl], rtol=1e-3, atol=1e-3)


def test_candidate_poses_match():
    """The four [R|±t] of an essential matrix: R 1e-5 and t 1e-5, stacked on the reference's axis."""
    rng = np.random.default_rng(4)
    for _ in range(3):
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
        E = (u @ np.diag([1.0, 1.0, 0.0]) @ vt).astype(np.float32)
        jR, jt = jpose._candidate_poses(jnp.asarray(E))
        tR, tt = tpose._candidate_poses(torch.from_numpy(E))
        assert tR.shape == (4, 3, 3) and tt.shape == (4, 3)
        # the SVD's sign freedom can flip U[:, 2], so t up to one shared sign; the rotations do not move
        sign = np.sign(np.dot(tt[0].numpy(), np.asarray(jt[0])))
        np.testing.assert_allclose(tt.numpy() * sign, np.asarray(jt), atol=1e-5)
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)


def test_feature_matcher_matches_reference(data_dir):
    """``FeatureMatcher.match`` == the reference's, with and without keypoints; L2 refused."""
    cfg_path = data_dir.parent.parent / "configs" / "feature_matcher.yml"
    rng = np.random.default_rng(6)
    d1 = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    d2 = d1 ^ (rng.random((200, 32)) < 0.04).astype(np.uint8) * rng.integers(1, 256, (200, 32), dtype=np.uint8)
    d2 = d2[rng.permutation(200)].astype(np.uint8)
    xy1 = rng.uniform(0, 1392, (200, 2)).astype(np.float32)
    xy2 = (xy1 + rng.normal(0, 300, (200, 2))).astype(np.float32)
    v1 = rng.random(200) > 0.1
    v2 = rng.random(200) > 0.1
    jm = jmatcher.FeatureMatcher(cfg_path)
    tm = tmatcher.FeatureMatcher(cfg_path)

    def jk(xy, v):
        return jfast.KeypointSet(jnp.asarray(xy), jnp.zeros(200), jnp.zeros(200), jnp.asarray(v))

    def tk(xy, v):
        return KeypointSet(torch.from_numpy(xy), torch.zeros(200), torch.zeros(200), torch.from_numpy(v))

    for j_args, t_args in (((), ()), ((jk(xy1, v1), jk(xy2, v2)), (tk(xy1, v1), tk(xy2, v2)))):
        want = jm.match(jnp.asarray(d1), jnp.asarray(d2), *j_args)
        got = tm.match(torch.from_numpy(d1), torch.from_numpy(d2), *t_args)
        for f in ("query_idx", "train_idx", "distance", "valid"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert int(got.count()) == int(want.count()) > 0
    with pytest.raises(ValueError, match="L2"):
        tmatcher.FeatureMatcher(TMatcherConfig(distance_type="L2"))
    with pytest.raises(ValueError, match="L2"):
        jmatcher.FeatureMatcher(JMatcherConfig(distance_type="L2"))


@pytest.mark.parametrize("skip", [0, 2])
def test_frame_stream_iter_matches_reference(data_dir, skip):
    got = list(TFrameStream(data_dir / "images", frame_skip=skip))
    want = list(JFrameStream(data_dir / "images", frame_skip=skip))
    assert len(got) == len(want) == len(range(0, 10, 1 + skip))
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gt == wt


def _reference_evaluate():
    spec = importlib.util.spec_from_file_location(
        "reference_evaluate", __import__("pathlib").Path(__file__).parent.parent / "tools" / "evaluate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--no-scale"], ["--rpe-delta", "3"]])
def test_evaluate_matches_tools_evaluate(tmp_path, capsys, extra):
    """The port's JSON line equals ``tools/evaluate.py``'s on the same files (identical numbers)."""
    rng = np.random.default_rng(7)
    n = 12
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 2, 3] = np.cumsum(rng.uniform(0.8, 1.2, n))
    est = gt.copy()
    est[:, :3, 3] = 0.5 * gt[:, :3, 3] + rng.normal(0, 0.05, (n, 3))
    save_kitti_trajectory(est, tmp_path / "est.txt")
    save_kitti_trajectory(gt[:10], tmp_path / "gt.txt")
    argv = [str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"), *extra]
    assert _reference_evaluate().main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert evaluate.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["frames"] == 10 and got["ate_rmse"] > 0


def test_cli_debug_sets_the_debug_level(monkeypatch, data_dir):
    """``--debug`` logs at DEBUG, as ``tools/cli.py:83-87`` sets it; INFO without it."""
    levels = []

    class Stop(Exception):
        pass

    def record(**kw):
        levels.append(kw["level"])
        raise Stop

    monkeypatch.setattr(logging, "basicConfig", record)
    base = ["-c", str(data_dir.parent.parent / "configs"), "-v", str(data_dir / "images"), "--device", "cpu"]
    for extra in (["--debug"], []):
        with pytest.raises(Stop):
            cli.main(base + extra)
    assert levels == [logging.DEBUG, logging.INFO]
