"""Full SLAM with loop closure: tpuslam_torch's SlamSystem.run_sequence against tpuslam's on the CPU.

One run of each package (one compile of the reference's sequence
program), the port replaying the reference's draws in all four streams:
``draw_fn`` (the two-view ranks, ``test_torch_system.py``), ``lc_draw_fn``
(verification: ``split(key2, B)[b]``) and ``reloc_draw_fn``
(relocalization: ``split(fold_in(key2, 777), B)[b]``, split once more into
the five-point and the PnP key), where chunk c's ``key2`` is
``split(fold_in(PRNGKey(0), c))[1]``.  At K 512, 256 two-view hypotheses,
batch 5 and ``ba_iterations`` 0 (BA runs, writes back and folds but moves
nothing), so the wiring is held at the VO slice's tolerances.

The run: the out-and-back 19 frames (fixtures 0..9 then 8..0) with frames
4 and 5 replaced by noise, the tree vocabulary, ``configs/loop_closure.yml``
and the reference's relocalization settings (``test_system.py``: ratio test
0.8, inliers at 2 px), the pose graph on.  Both cases hold ``pose_ok``,
``num_matches`` and ``reloc_ok`` identical, ``loops`` identical in
``frame_id`` and ``matched_keyframe_id`` with ``num_inliers`` within ±2,
``pose_graph_applied`` the same, the database's integer fields identical,
and the corrected trajectory's rotations within 1e-4 and positions within
1e-3; then

* ``loop``: loops fire late against early keyframes and the pose graph
  folds them in;
* ``blind``: relocalization rescues frame 6, the first clean frame after
  the blind span, and no other.

A run of the port alone in PnP mode on the blinded fixtures rescues a
frame and keeps its map in the trajectory's world frame (the reference's
own check, ``test_system.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest

import tpuslam.frontend.pose  # noqa: F401 (imported before any trace: it builds a module constant)
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_pnp import jax_gumbel_samples
from test_torch_system import BATCH, _small, draw_fn
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.convert import sequence_result_to_numpy

DB_INTS = ("kp_valid", "descriptors", "mp_valid", "ids", "count", "last_id")


def _key2(frame_idx: int):
    return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), frame_idx // BATCH))[1]


def lc_draws(frame_idx, valid):
    return jax_gumbel_samples(jax.random.split(_key2(frame_idx), BATCH)[frame_idx % BATCH], valid.numpy(), 512)


def reloc_draws(frame_idx, pnp_valid, n_valid):
    k_b = jax.random.split(jax.random.fold_in(_key2(frame_idx), 777), BATCH)[frame_idx % BATCH]
    k, k_pnp = jax.random.split(k_b)
    return (jax_gumbel_samples(k_pnp, pnp_valid.numpy(), 512),
            np.array(jax.random.randint(k, (1024, 5), 0, max(n_valid, 1))))


def _blind_config(cfg):
    """The reference's relocalization scenario at the small shapes."""
    cfg = _small(cfg)
    return dataclasses.replace(cfg, matcher=dataclasses.replace(cfg.matcher, ratio_test_threshold=0.8),
                               pose=dataclasses.replace(cfg.pose, inlier_threshold_px=2.0))


@pytest.fixture(scope="module")
def fixture_frames(data_dir):
    stream = FrameStream(data_dir / "images")
    return np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])


def blinded(frames):
    out = frames.copy()
    rng = np.random.default_rng(0)
    out[4] = rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
    out[5] = rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
    return out


@pytest.fixture(scope="module")
def runs(data_dir, fixture_frames):
    frames = blinded(fixture_frames[list(range(10)) + list(range(8, -1, -1))])
    cfg_dir = data_dir.parent.parent / "configs"
    voc = cfg_dir / "vocabulary_tree.npz"
    jsys = JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), vocabulary=voc,
                   ba_iterations=0)
    want = sequence_result_to_numpy(jsys.run_sequence(frames, seed=0))
    tsys = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), vocabulary=voc,
                   device="cpu", draw_fn=draw_fn(False), lc_draw_fn=lc_draws, reloc_draw_fn=reloc_draws,
                   ba_iterations=0)
    got = sequence_result_to_numpy(tsys.run_sequence(frames, seed=0))
    return want, got


@pytest.mark.parametrize("case", ["loop", "blind"])
def test_loop_closure_run_matches_reference(case, runs):
    want, got = runs
    assert got["poses"].shape == (19, 4, 4)
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    np.testing.assert_array_equal(got["num_matches"], want["num_matches"])
    np.testing.assert_array_equal(got["reloc_ok"], want["reloc_ok"])
    assert [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in got["loops"]] == \
        [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in want["loops"]]
    for g, w in zip(got["loops"], want["loops"]):
        assert abs(g["num_inliers"] - w["num_inliers"]) <= 2
    assert got["pose_graph_applied"] == want["pose_graph_applied"]
    for name in DB_INTS:
        np.testing.assert_array_equal(got["db"][name], want["db"][name], err_msg=name)
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], atol=1e-3)
    if case == "loop":  # loops fire late against early keyframes, and the pose graph folds them in
        assert len(got["loops"]) >= 1 and got["pose_graph_applied"]
        assert got["loops"][-1]["frame_id"] >= 12 and got["loops"][-1]["matched_keyframe_id"] <= 6
    else:  # the first clean frame after the blind span is rescued, and only it
        assert np.flatnonzero(got["reloc_ok"]).tolist() == [6]


def test_pnp_relocalization_keeps_the_map_in_the_trajectory_frame(data_dir, fixture_frames):
    """The port alone, PnP mode, BA and the pose graph off: frames rescued, and every keyframe row of
    the final window agrees with the corrected trajectory (the reference's check, to 1e-3)."""
    cfg_dir = data_dir.parent.parent / "configs"
    tsys = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
                   vocabulary=cfg_dir / "vocabulary.npz", tracking="pnp", enable_ba=False, enable_pose_graph=False,
                   device="cpu")
    out = sequence_result_to_numpy(tsys.run_sequence(blinded(fixture_frames), seed=0))
    assert out["reloc_ok"].any()
    m = out["map"]
    for s in np.nonzero(m["kf_valid"])[0]:
        fid = int(m["kf_id"][s])
        R, t = m["kf_R"][s], m["kf_t"][s]
        np.testing.assert_allclose(-R.T @ t, out["poses"][fid, :3, 3], atol=1e-3)
