"""The streaming SLAM driver: tpuslam_torch's SlamSystem.run() against tpuslam's, resume and the CLI, on the CPU.

At the shapes of ``test_torch_system_lc.py`` (K 512, 256 two-view
hypotheses), the port on one CPU thread:

* the port's ``run()`` against the reference's ``run()`` (one compile of
  the reference) on the ten fixtures in PnP mode with loop closure (the
  tree vocabulary), batch 5, ``ba_iterations`` 0, the port replaying the
  reference's draws: integer fields, loops and BA event frames identical,
  rotations 1e-4, and every integer leaf of the checkpoint
  identical (loop inlier counts within ±2, the finding of that file);
  positions at the PnP slice's 1e-3 + 3e-4 relative (``test_torch_slam_pnp.py``);
* the port alone: a run split through ``save_state`` / ``load_state`` and
  ``run(resume=...)`` equals the uninterrupted run bit for bit (trajectory,
  stats, loops, BA events and every checkpoint leaf) in PnP-SLAM (the run
  above, split after frame 5), and in VO-SLAM (batch 4, split after frame
  8) through the CLI in-process (``cli.main``: ``--slam --save-state``,
  then ``--slam --resume``); ``run()`` equals ``run_sequence()`` where no
  frame fails.  The plain VO pipeline's CLI case is in
  ``test_torch_checkpoint.py``, which runs no SLAM, and the split through a
  relocalization event in ``test_torch_resume_reloc.py`` (the files split
  so that xdist runs them on separate workers).
"""

import numpy as np
import pytest

import tpuslam.frontend.pose  # noqa: F401 (imported before any trace: it builds a module constant)
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_checkpoint import check_split_trajectories, cli_args, small_config_dir
from test_torch_system import BATCH, _small, draw_fn, pnp_draws
from test_torch_system_lc import lc_draws, reloc_draws
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam_torch import cli
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.post.trajectory import save_kitti_trajectory
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.checkpoint import load_state, save_state
from tpuslam_torch.utils.convert import checkpoint_to_numpy

SPLIT_BATCH, SPLIT_AT = 4, 8


def batches(frames, B, start=0):
    """``FrameStream.batches``-shaped chunks of a frame array from ``start``: the last padded, ``valid`` marking."""
    for s in range(start, len(frames), B):
        blk = frames[s:s + B]
        nb = len(blk)
        if nb < B:
            blk = np.concatenate([blk, np.repeat(blk[-1:], B - nb, 0)])
        yield blk, np.zeros(B), np.arange(B) < nb


def flat_leaves(tree, prefix=""):
    """(path, array) of every leaf of ``checkpoint_to_numpy``'s nested dicts."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [leaf for i, x in enumerate(tree) for leaf in flat_leaves(x, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]


@pytest.fixture(scope="module")
def fixture_frames(data_dir):
    stream = FrameStream(data_dir / "images")
    return np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])


@pytest.fixture(scope="module")
def cfg_dir(data_dir):
    return data_dir.parent.parent / "configs"


@pytest.fixture(scope="module")
def reference_runs(cfg_dir, fixture_frames):
    """The reference's and the port's run() in PnP mode at batch 5: (port system, want, got)."""
    kw = dict(vocabulary=cfg_dir / "vocabulary_tree.npz", tracking="pnp", ba_iterations=0)
    jsys = JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), **kw)
    want = jsys.run(batches(fixture_frames, BATCH), seed=0)
    tsys = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), device="cpu",
                   draw_fn=draw_fn(True), pnp_draw_fn=pnp_draws, lc_draw_fn=lc_draws, reloc_draw_fn=reloc_draws, **kw)
    return tsys, want, tsys.run(batches(fixture_frames, BATCH), seed=0)


def test_run_matches_reference(reference_runs):
    _, want, got = reference_runs

    assert got["poses"].shape == (10, 4, 4)
    for k in ("pose_ok", "reloc_ok", "num_matches"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["pose_ok"][1:].all()
    assert [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in got["loops"]] == \
        [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in want["loops"]]
    assert [e["frame_id"] for e in got["ba_events"]] == [e["frame_id"] for e in want["ba_events"]] == [4, 9]
    assert got["pose_graph_applied"] == want["pose_graph_applied"]
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    # positions at the PnP slice's tolerance, 1e-3 + 3e-4 relative (test_torch_slam_pnp.py: the fallback
    # scale is a median of depth ratios that differ by up to 1.2e-3 between the packages)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], rtol=3e-4, atol=1e-3)

    g_leaves = flat_leaves(checkpoint_to_numpy(got["checkpoint"]))
    w_leaves = flat_leaves(checkpoint_to_numpy(want["checkpoint"]))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    n_int = 0
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.shape == w.shape, path
        if w.dtype.kind in "biu":
            n_int += 1
            if path == "/loops_ninl":
                assert np.abs(g.astype(np.int64) - w).max(initial=0) <= 2
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)
    assert n_int >= 30


def split_run(system, frames, split_at: int, tmp_path) -> dict:
    """``system.run`` over ``frames[:split_at]``, its checkpoint through a file, then resumed over the rest."""
    B = system.config.batch_size
    first = system.run(batches(frames[:split_at], B), seed=0)
    save_state(tmp_path / "ckpt.npz", slam=first["checkpoint"])
    resume = load_state(tmp_path / "ckpt.npz", device="cpu", slam=system.checkpoint_template())["slam"]
    assert int(resume["counters"][0]) == split_at
    return system.run(batches(frames, B, start=split_at), seed=0, resume=resume)


def check_checkpoints_equal(got: dict, want: dict):
    """Every leaf of two checkpoint payloads equal, dtype and bits."""
    g_leaves = flat_leaves(checkpoint_to_numpy(got))
    w_leaves = flat_leaves(checkpoint_to_numpy(want))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def check_split(split: dict, single: dict):
    """A split run equals the uninterrupted one bit for bit: trajectories, stats, loops, BA events, checkpoint."""
    np.testing.assert_array_equal(split["checkpoint"]["raw_poses"], single["checkpoint"]["raw_poses"])
    np.testing.assert_array_equal(split["poses"], single["poses"])
    for k in ("pose_ok", "reloc_ok", "num_matches", "num_inliers"):
        np.testing.assert_array_equal(split[k], single[k], err_msg=k)
    assert [(lp["frame_id"], lp["matched_keyframe_id"], lp["num_inliers"]) for lp in split["loops"]] == \
        [(lp["frame_id"], lp["matched_keyframe_id"], lp["num_inliers"]) for lp in single["loops"]]
    assert split["ba_events"] == single["ba_events"] and len(single["ba_events"]) == 2
    assert split["pose_graph_applied"] == single["pose_graph_applied"]
    check_checkpoints_equal(split["checkpoint"], single["checkpoint"])


@pytest.fixture(scope="module")
def vo_single(cfg_dir, fixture_frames):
    """VO-SLAM at batch 4 with the tree vocabulary, uninterrupted: (system, result)."""
    system = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                     _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=SPLIT_BATCH)),
                     vocabulary=cfg_dir / "vocabulary_tree.npz", device="cpu")
    return system, system.run(batches(fixture_frames, SPLIT_BATCH), seed=0)


def test_pnp_split_run_equals_single_run(tmp_path, fixture_frames, reference_runs):
    """PnP-SLAM: the run replaying the reference's draws (a function of the frame alone), split after 5."""
    system, _, single = reference_runs
    check_split(split_run(system, fixture_frames, BATCH, tmp_path), single)


def test_run_equals_run_sequence(vo_single, fixture_frames):
    system, single = vo_single
    assert single["pose_ok"][1:].all() and not single["reloc_ok"].any()
    seq = system.run_sequence(fixture_frames, seed=0)
    np.testing.assert_array_equal(single["poses"], seq["poses"])
    assert [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in single["loops"]] == \
        [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in seq["loops"]]
    assert single["ba_events"] == seq["ba_events"]


def test_resume_and_warm_start_exclusive(vo_single):
    system, single = vo_single
    with pytest.raises(ValueError, match="mutually exclusive"):
        system.run(iter([]), resume=single["checkpoint"], warm_start={"map": single["map"]})


def test_cli_slam_split_run_equals_single_run(tmp_path, data_dir, cfg_dir, vo_single):
    """VO-SLAM split after frame 8 through the CLI (``--slam --save-state``, then ``--slam --resume
    --save-state``): its trajectory file and every leaf of its final checkpoint equal the uninterrupted
    run's, at the same shapes."""
    system, single = vo_single
    full, part1, part2, ckpt, final = (tmp_path / n for n in ("full.txt", "part1.txt", "part2.txt", "ckpt.npz",
                                                                "final.npz"))
    save_kitti_trajectory(single["poses"], full)
    base = cli_args(small_config_dir(tmp_path, cfg_dir), data_dir, SPLIT_BATCH) + ["--slam"]
    assert cli.main(base + ["-o", str(part1), "--max-frames", "6", "--save-state", str(ckpt)]) == 0
    assert cli.main(base + ["-o", str(part2), "--resume", str(ckpt), "--save-state", str(final)]) == 0
    check_split_trajectories(full, part1, part2, SPLIT_AT)
    resumed = load_state(final, device="cpu", slam=system.checkpoint_template())["slam"]
    check_checkpoints_equal(resumed, single["checkpoint"])
    assert len(single["ba_events"]) == 2 and single["pose_ok"][1:].all()
