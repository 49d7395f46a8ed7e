"""The VO and PnP slices end to end: tpuslam_torch's SlamPipeline against tpuslam's on the CPU.

Both run the 10 KITTI fixture frames at MaxKeypoints 512, 256 RANSAC
hypotheses and batch 4 (three chunks, so the carry crosses two chunk
boundaries); the port's ``draw_fn`` supplies the reference's own per-frame
draws, ``randint(fold_in(PRNGKey(0), frame), …)``.  In PnP mode the
reference splits the key into a two-view stream and a RANSAC-PnP stream,
``split(PRNGKey(0))``; ``draw_fn`` and ``pnp_draw_fn`` replay both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pnp import jax_gumbel_samples
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.cli import main as cli_main
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.frontend.pose import estimate_relative_pose
from tpuslam_torch.model import slam as tslam
from tpuslam_torch.pre.stream import FrameStream

K_CAP, H_HYP, BATCH = 512, 256, 4


def _small(cfg):
    return dataclasses.replace(
        cfg,
        detector=dataclasses.replace(cfg.detector, max_keypoints=K_CAP),
        pose=dataclasses.replace(cfg.pose, num_hypotheses=H_HYP),
    )


def _jax_draws(frame_idx, n_valid, H, S, key=jax.random.PRNGKey(0)):
    key = jax.random.fold_in(key, frame_idx)
    return np.array(jax.random.randint(key, (H, S), 0, jnp.maximum(jnp.int32(int(n_valid)), 1)))


KEY_VO, KEY_PNP = jax.random.split(jax.random.PRNGKey(0))


def _jax_pnp_draws(frame_idx, valid):
    """The reference tracker's RANSAC-PnP samples of one frame: Gumbel top-6 over the valid matches."""
    return jax_gumbel_samples(jax.random.fold_in(KEY_PNP, frame_idx), valid.cpu().numpy(), 64)


@pytest.fixture(scope="module")
def runs(data_dir):
    cfg_dir = data_dir.parent.parent / "configs"
    batches = list(FrameStream(data_dir / "images").batches(BATCH))
    assert len(batches) == 3
    jp = JPipeline(
        JCamera.from_yaml(cfg_dir / "camera.yml"),
        _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
    )
    want = jp.run(iter(batches), seed=0)
    tp = tslam.SlamPipeline(
        TCamera.from_yaml(cfg_dir / "camera.yml"),
        _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
        device="cpu",
        draw_fn=_jax_draws,
    )
    got = tp.run(iter(batches), seed=0)
    return want, got, tp, batches


def test_vo_slice_matches_reference(runs):
    want, got, _, _ = runs
    np.testing.assert_array_equal(got["num_matches"], want["num_matches"])
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    assert got["pose_ok"][1:].all()
    assert np.all(np.abs(got["num_inliers"].astype(int) - want["num_inliers"].astype(int)) <= 2)
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], atol=1e-3)
    assert got["poses"][-1, 2, 3] > 5.0  # forward motion along +z
    assert got["state"].frame_idx == 10


def test_process_sequence_matches_run(runs):
    _, got, tp, batches = runs
    chunks = torch.from_numpy(np.stack([b[0] for b in batches]))
    valid = torch.from_numpy(np.stack([b[2] for b in batches]))
    res, state = tp.process_sequence(chunks, valid, tp.initial_state(), seed=0)
    assert res.poses.shape == (3, BATCH, 4, 4)
    flat = res.poses.reshape(-1, 4, 4)[valid.reshape(-1)]
    np.testing.assert_array_equal(flat.numpy(), got["poses"])
    assert state.frame_idx == 10


def test_nanmedian_interpolates_like_jnp():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 2.0, (6, 31)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = np.nan
    x[0] = np.nan  # all-NaN row
    x[1, 1:] = np.nan  # one value
    x[2, 2:] = np.nan  # two values: their mean, not the lower one
    got = tslam._nanmedian(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(got, want)


def test_prefix_products_and_scatter_max():
    rng = np.random.default_rng(1)
    T = torch.from_numpy(rng.normal(size=(7, 4, 4)).astype(np.float32))
    seq = [T[0]]
    for i in range(1, 7):
        seq.append(seq[-1] @ T[i])
    np.testing.assert_allclose(tslam._prefix_products(T).numpy(), torch.stack(seq).numpy(), rtol=1e-4, atol=1e-4)
    idx = torch.tensor([[0, 2, 2, 3], [3, 3, 1, 0]])
    val = torch.tensor([[1.0, 5.0, 4.0, 9.0], [2.0, 3.0, 7.0, 6.0]])
    out = tslam._scatter_max(idx, val, 3)  # index 3 is dropped
    assert out.tolist() == [[1.0, 0.0, 5.0], [6.0, 7.0, 0.0]]


def test_unported_modes_raise(data_dir):
    """PnP tracking and with_features construct; the five-point solver and exact BRIEF still raise."""
    cfg_dir = data_dir.parent.parent / "configs"
    cam = TCamera.from_yaml(cfg_dir / "camera.yml")
    cfg = TSlamConfig.from_yaml_dir(cfg_dir)
    tp = tslam.SlamPipeline(cam, cfg, tracking="pnp", with_features=True, device="cpu")
    assert tp.tracking == "pnp" and tp.with_features
    with pytest.raises(ValueError):
        tslam.SlamPipeline(cam, cfg, tracking="slam", device="cpu")
    with pytest.raises(NotImplementedError):  # SampleSize: 5
        estimate_relative_pose(torch.zeros(1, 8, 2), torch.zeros(1, 8, 2), torch.ones(1, 8, dtype=torch.bool),
                               torch.eye(3), sample_size=5)
    exact = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, brief_quantized_bins=0))
    with pytest.raises(NotImplementedError):
        tslam.SlamPipeline(cam, exact, device="cpu")


def test_cli_writes_kitti_trajectory(tmp_path, data_dir, capsys):
    out = tmp_path / "traj.txt"
    rc = cli_main([
        "-c", str(data_dir.parent.parent / "configs"), "-v", str(data_dir / "images"),
        "-o", str(out), "--batch-size", "2", "--max-frames", "2", "--device", "cpu", "--stats",
    ])
    assert rc == 0
    rows = np.loadtxt(out)
    assert rows.shape == (2, 12)
    np.testing.assert_array_equal(rows[0], np.eye(4)[:3].reshape(-1))
    assert '"frames": 2' in capsys.readouterr().out


def test_cli_pnp_tracking(tmp_path, data_dir, capsys):
    """``--tracking pnp`` runs run_pnp: a trajectory with the first frame at the origin."""
    out = tmp_path / "traj.txt"
    rc = cli_main([
        "-c", str(data_dir.parent.parent / "configs"), "-v", str(data_dir / "images"), "-o", str(out),
        "--tracking", "pnp", "--batch-size", "2", "--max-frames", "2", "--device", "cpu", "--stats",
    ])
    assert rc == 0
    rows = np.loadtxt(out)
    assert rows.shape == (2, 12) and np.isfinite(rows).all()
    np.testing.assert_array_equal(rows[0], np.eye(4)[:3].reshape(-1))
    assert rows[1, 11] > 0.5  # forward along +z
    stats = capsys.readouterr().out
    assert '"tracking": "pnp"' in stats and '"pose_ok": 1' in stats


def test_entry_points_default_to_cuda(data_dir):
    """SlamPipeline and FeatureDetector built without ``device`` run on the card, or raise."""
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg_dir = data_dir.parent.parent / "configs"
    cam = TCamera.from_yaml(cfg_dir / "camera.yml")
    cfg = TSlamConfig.from_yaml_dir(cfg_dir)
    builders = (lambda: tslam.SlamPipeline(cam, cfg), lambda: FeatureDetector(cfg.detector))
    for build in builders:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:  # torch's own error: no silent CPU run
            with pytest.raises((AssertionError, RuntimeError)):
                build()


def test_cli_without_device_does_not_fall_back(tmp_path, data_dir, capsys):
    args = [
        "-c", str(data_dir.parent.parent / "configs"), "-v", str(data_dir / "images"),
        "-o", str(tmp_path / "traj.txt"), "--batch-size", "2", "--max-frames", "2", "--stats",
    ]
    if torch.cuda.is_available():
        assert cli_main(args) == 0 and '"device": "cuda' in capsys.readouterr().out
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            cli_main(args)
        assert not (tmp_path / "traj.txt").exists()


# --- PnP tracking: run_pnp of both packages -----------------------------------


@pytest.fixture(scope="module")
def pnp_runs(data_dir):
    """The reference's PnP chunk program once (with features), and the port's run_pnp."""
    cfg_dir = data_dir.parent.parent / "configs"
    batches = list(FrameStream(data_dir / "images").batches(BATCH))
    jp = JPipeline(
        JCamera.from_yaml(cfg_dir / "camera.yml"),
        _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
        tracking="pnp",
    )
    state = jp.initial_pnp_state()
    want = []
    for frames, _, valid in batches:
        res, state = jp._chunk_pnp_full_fn(jnp.asarray(frames), jnp.asarray(valid), state, jax.random.PRNGKey(0))
        want.append(jax.tree.map(np.asarray, res))
    want = type(want[0])(*(None if f[0] is None else np.stack(f) for f in zip(*want)))
    tp = tslam.SlamPipeline(
        TCamera.from_yaml(cfg_dir / "camera.yml"),
        _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
        tracking="pnp",
        device="cpu",
        draw_fn=lambda f, n, H, S: _jax_draws(f, n, H, S, key=KEY_VO),
        pnp_draw_fn=_jax_pnp_draws,
        with_features=True,
    )
    got = tp.run_pnp(iter(batches), seed=0)
    return want, jax.tree.map(np.asarray, state), got, tp, batches


def test_pnp_slice_matches_reference(pnp_runs):
    """Integer fields identical; inliers ±2; rotations 1e-4; positions 1e-3 plus 3e-4 relative.

    The relative part is a finding, not slack: every frame here takes the
    two-view fallback at map-anchored scale, a median of depth ratios of
    single-pair triangulations.  Those differ between the packages by up to
    1.2e-3 relative on far points (float32 rounding in the 4×4 Jacobi
    nullvector, frame 6), and the scale picks it up through the map: frame
    9's z is 9.036222 here and 9.034286 in the reference (1.94e-3 apart,
    2.1e-4 of the distance travelled).  Given the same inputs the trackers
    agree to 1e-4 / 1e-3 (``test_torch_tracking.py``).
    """
    want, jstate, got, _, batches = pnp_runs
    valid = np.stack([b[2] for b in batches]).reshape(-1)
    flat = lambda x: x.reshape(-1, *x.shape[2:])[valid]  # noqa: E731
    np.testing.assert_array_equal(got["num_matches"], flat(want.num_matches))
    np.testing.assert_array_equal(got["pose_ok"], flat(want.pose_ok))
    assert got["pose_ok"][1:].all()
    inl = np.abs(got["num_inliers"].astype(int) - flat(want.num_inliers).astype(int))
    assert inl.max() <= 2
    np.testing.assert_allclose(got["poses"][:, :3, :3], flat(want.poses)[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], flat(want.poses)[:, :3, 3], rtol=3e-4, atol=1e-3)
    assert got["poses"][-1, 2, 3] > 5.0  # forward motion along +z
    assert int(got["map"].point_count) == int(jstate.map.point_count)
    assert got["state"].vo.frame_idx == 10


def test_pnp_process_sequence_matches_run_and_reference(pnp_runs):
    """process_sequence_pnp equals run_pnp; its PnP fields and features equal the reference's.

    Integer and boolean fields exact; keypoints, descriptors and matches
    exact; the metric-scale triangulations to 2e-3 relative: the product
    of a single-pair triangulation and the applied scale, each of which
    carries the finding of ``test_pnp_slice_matches_reference`` (scales
    1.26e-3 apart at frames 8-9, measured 1.55e-3 here at most).
    """
    want, jstate, got, tp, batches = pnp_runs
    chunks = torch.from_numpy(np.stack([b[0] for b in batches]))
    valid = torch.from_numpy(np.stack([b[2] for b in batches]))
    res, state = tp.process_sequence_pnp(chunks, valid, tp.initial_pnp_state(), seed=0)
    flat = res.poses.reshape(-1, 4, 4)[valid.reshape(-1)]
    np.testing.assert_array_equal(flat.numpy(), got["poses"])
    assert torch.equal(state.map.points, got["map"].points)
    v = valid.numpy()
    for name in ("pnp_absolute_ok", "pnp_used_ransac", "pnp_point_count0", "pnp_kp_to_point",
                 "pnp_kp_birth", "kps_valid", "desc", "m_query", "m_train", "m_valid", "point_ok"):
        np.testing.assert_array_equal(getattr(res, name).numpy()[v], getattr(want, name)[v], err_msg=name)
    np.testing.assert_array_equal(res.kps_xy.numpy(), want.kps_xy)
    ok = res.point_ok.numpy()
    np.testing.assert_allclose(res.points3d.numpy()[ok], want.points3d[ok], rtol=2e-3, atol=1e-3)
    np.testing.assert_array_equal(state.map.obs_mask.numpy(), jstate.map.obs_mask)
    np.testing.assert_array_equal(state.map.point_birth.numpy(), jstate.map.point_birth)
    np.testing.assert_array_equal(state.assoc.kp_to_point.numpy(), jstate.assoc.kp_to_point)
