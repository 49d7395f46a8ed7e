"""The VO slice end to end: tpuslam_torch's SlamPipeline against tpuslam's on the CPU.

Both run the 10 KITTI fixture frames at MaxKeypoints 512, 256 RANSAC
hypotheses and batch 4 (three chunks, so the carry crosses two chunk
boundaries); the port's ``draw_fn`` supplies the reference's own per-frame
draws, ``randint(fold_in(PRNGKey(0), frame), …)``.  The PnP slice is in
``test_torch_slam_pnp.py`` (a file of its own, so a parallel run takes the
two on two workers).  The port runs on one CPU thread (``one_torch_thread``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
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
    """PnP tracking and with_features construct, the five-point solver runs, and exact BRIEF (bins 0)
    constructs and runs a 4-frame chunk: every pair posed, forward along +z."""
    cfg_dir = data_dir.parent.parent / "configs"
    cam = TCamera.from_yaml(cfg_dir / "camera.yml")
    cfg = TSlamConfig.from_yaml_dir(cfg_dir)
    tp = tslam.SlamPipeline(cam, cfg, tracking="pnp", with_features=True, device="cpu")
    assert tp.tracking == "pnp" and tp.with_features
    with pytest.raises(ValueError):
        tslam.SlamPipeline(cam, cfg, tracking="slam", device="cpu")
    degenerate = estimate_relative_pose(torch.zeros(1, 8, 2), torch.zeros(1, 8, 2), torch.ones(1, 8, dtype=torch.bool),
                                        torch.eye(3), sample_size=5, num_hypotheses=16)  # SampleSize: 5
    assert degenerate.R.shape == (1, 3, 3) and torch.isfinite(degenerate.R).all()
    exact = _small(dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, brief_quantized_bins=0), batch_size=BATCH))
    tp_exact = tslam.SlamPipeline(cam, exact, device="cpu", draw_fn=_jax_draws)
    assert tp_exact.detector.bin_weights is None
    frames, _, valid = next(FrameStream(data_dir / "images").batches(BATCH))
    res, state = tp_exact.process_chunk(torch.from_numpy(frames), torch.from_numpy(valid), tp_exact.initial_state())
    assert res.pose_ok[1:].all() and torch.isfinite(res.poses).all() and state.frame_idx == BATCH
    assert (res.num_matches[1:] > 20).all() and res.poses[-1, 2, 3] > 1.0


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
