"""The PnP slice end to end: tpuslam_torch's SlamPipeline (``tracking="pnp"``) against tpuslam's on the CPU.

The setting of ``test_torch_slam.py`` (10 KITTI fixture frames, MaxKeypoints
512, 256 RANSAC hypotheses, batch 4).  In PnP mode the reference splits the
key into a two-view stream and a RANSAC-PnP stream, ``split(PRNGKey(0))``;
``draw_fn`` and ``pnp_draw_fn`` replay both.  The port runs on one CPU
thread (``one_torch_thread``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_slam import BATCH, KEY_VO, _jax_draws, _jax_pnp_draws, _small
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.cli import main as cli_main
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model import slam as tslam
from tpuslam_torch.pre.stream import FrameStream


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
