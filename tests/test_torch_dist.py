"""tpuslam_torch.dist.mesh and the CLI's --timeshard on the CPU.

The mesh is a list of devices and sequence d runs on ``devices[d % len]``:
``initialize_multihost`` falls back to a single process (False) as the
reference's does; ``make_device_mesh`` raises when more devices are asked
for than exist; ``shard_sequence_program`` over ``[cpu, cpu]`` equals a
``run_sequence`` of each sequence bit for bit, its fold included, and
``shard_batched_pipeline`` equals each sequence's ``process_chunk``; where
shards run (one device, or two entries of it) does not change a bit of a
time-sharded run.  These run at small shapes: the fixtures at half
resolution (696×256, the intrinsics halved, no distortion), 256 keypoints,
64 hypotheses, batch 2, the reference's small back end
(``tests/test_dist.py``: window 4, BA every 2 keyframes, 2 LM steps, 256
points).  Then ``--timeshard`` through the CLI at
K 512 (VO, and full SLAM with PnP tracking) writes the trajectory, and the
reference's refusals hold.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_checkpoint import cli_args, small_config_dir
from tpuslam_torch import cli
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import DetectorConfig, PoseConfig, SlamConfig
from tpuslam_torch.dist import mesh, timeshard
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.model.system import SlamSystem
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.convert import sequence_result_to_numpy

REPO = Path(__file__).resolve().parent.parent
TINY_B = 2


def tiny_camera() -> Camera:
    """``configs/camera.yml`` at half resolution (696×256), without distortion."""
    full = Camera.from_yaml(REPO / "configs" / "camera.yml")
    K = full.K.copy()
    K[:2] /= 2
    return Camera(K=K, D=np.zeros(5), width=full.width // 2, height=full.height // 2)


def tiny_config() -> SlamConfig:
    return SlamConfig(detector=DetectorConfig(max_keypoints=256, brief_quantized_bins=16),
                      pose=PoseConfig(num_hypotheses=64), batch_size=TINY_B)


def tiny_frames(n: int, start: int = 0) -> np.ndarray:
    """The fixture frames at half resolution, ping-pong tiled (period 18), from ``start``."""
    stream = FrameStream(REPO / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0][::2, ::2] for i in range(stream.total_frames)]
    return np.stack([base[min((i + start) % 18, 18 - (i + start) % 18)] for i in range(n)])


def tiny_pipeline() -> SlamPipeline:
    return SlamPipeline(tiny_camera(), tiny_config(), device="cpu")


def tiny_system(tracking: str = "pnp") -> SlamSystem:
    return SlamSystem(tiny_camera(), tiny_config(), vocabulary=REPO / "configs" / "vocabulary.npz",
                      tracking=tracking, ba_window=4, ba_interval=2, ba_iterations=2, max_map_points=256,
                      device="cpu")


def test_initialize_multihost_single_process_fallback(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.initialize_multihost() is False
    assert mesh.initialize_multihost(num_processes=1, process_id=0) is False
    assert mesh.make_device_mesh(device_type="cpu") == [torch.device("cpu")]


def test_make_device_mesh_raises_past_the_devices():
    with pytest.raises(ValueError, match="Requested 2 devices but only 1"):
        mesh.make_device_mesh(2, device_type="cpu")
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"Requested {n_cards + 1} devices"):
        mesh.make_device_mesh(n_cards + 1)
    if n_cards:
        assert mesh.make_device_mesh() == [torch.device("cuda", i) for i in range(n_cards)]
    else:  # no card: the default mesh is empty, which is an error
        with pytest.raises(ValueError):
            mesh.make_device_mesh()
    assert [mesh.device_for(["cpu", "meta"], d).type for d in range(4)] == ["cpu", "meta", "cpu", "meta"]


@pytest.mark.parametrize("tracking", ["pnp", "vo"])
def test_shard_sequence_program_equals_run_sequence(tracking):
    """Two sequences over [cpu, cpu], each its own carry and seed: each equals ``run_sequence`` with its
    seed and frames, raw outputs and the fold, bit for bit."""
    system = tiny_system(tracking)
    C, S = 2, 2
    chunks = np.stack([tiny_frames(C * TINY_B, start=7 * s) for s in range(S)]).reshape(S, C, TINY_B, 256, 696)
    valid = np.ones((S, C, TINY_B), bool)
    seeds = [7, 8]
    step = mesh.shard_sequence_program(system, ["cpu", "cpu"])
    carries, outs = step(chunks, valid, seeds)
    for s in range(S):
        want = sequence_result_to_numpy(system.run_sequence(chunks[s].reshape(-1, 256, 696), seed=seeds[s]))
        got = sequence_result_to_numpy(system._fold_sequence(outs[s], C * TINY_B, carries[s]))
        assert outs[s]["poses"].shape == (C, TINY_B, 4, 4)
        np.testing.assert_array_equal(got["poses"], want["poses"])
        for k in ("pose_ok", "num_matches", "num_inliers", "reloc_ok"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for name, v in want["map"].items():
            np.testing.assert_array_equal(got["map"][name], v, err_msg=name)
        assert [e["frame_id"] for e in got["ba_events"]] == [e["frame_id"] for e in want["ba_events"]]
        assert got["pose_ok"][1:].any()


def test_shard_batched_pipeline_equals_process_chunk():
    pipe = tiny_pipeline()
    frames = np.stack([tiny_frames(TINY_B, start=5 * s) for s in range(3)])
    valid = np.ones((3, TINY_B), bool)
    with mesh.shard_batched_pipeline(pipe, ["cpu", "cpu"]) as step:
        results, states = step(frames, valid, [pipe.initial_state()] * 3, [0, 1, 2])
        states = [step.fetch(h) for h in states]  # the states stay in the workers until fetched
    for s in range(3):
        want, want_state = pipe.process_chunk(torch.from_numpy(frames[s]), torch.ones(TINY_B, dtype=torch.bool),
                                              pipe.initial_state(), seed=s)
        assert torch.equal(results[s].poses, want.poses) and torch.equal(results[s].pose_ok, want.pose_ok)
        assert torch.equal(states[s].pose, want_state.pose) and states[s].frame_idx == want_state.frame_idx


def test_placement_does_not_change_a_result():
    """Time-sharded full SLAM with every shard on one device, and over two entries of it: the same bits."""
    frames = tiny_frames(5)
    system = tiny_system("vo")
    one = timeshard.run_timesharded_system(system, frames, 2, seed=1, devices=["cpu"])
    two = timeshard.run_timesharded_system(system, frames, 2, seed=1, devices=["cpu", "cpu"])
    assert (one["S"], one["V"]) == (4, 2)
    for k in ("poses", "segments", "segments_ok", "pose_ok"):
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)
    assert [e["frame_id"] for e in two["ba_events"]] == [e["frame_id"] for e in one["ba_events"]]
    assert np.isfinite(one["poses"]).all() and one["poses"].shape == (5, 4, 4)
    for d, db in enumerate(one["dbs"]):
        assert torch.equal(db.ids, two["dbs"][d].ids)


@pytest.mark.parametrize("mode", [["--tracking", "vo"], ["--slam", "--tracking", "pnp"]])
def test_cli_timeshard_writes_the_trajectory(tmp_path, data_dir, capsys, monkeypatch, mode):
    """``--timeshard 2`` over 4 frames at batch 2 (S 2, V 2) through ``frames_to_memmap``, whose file in
    the temporary directory is removed afterwards."""
    out = tmp_path / "traj.txt"
    cfg = small_config_dir(tmp_path, data_dir.parent.parent / "configs")
    args = cli_args(cfg, data_dir, 2) + ["-o", str(out), "--max-frames", "4", "--timeshard", "2", "--stats", *mode]
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    assert cli.main(args) == 0
    assert not list(scratch.iterdir())
    rows = np.loadtxt(out)
    assert rows.shape == (4, 12) and np.isfinite(rows).all()
    np.testing.assert_array_equal(rows[0], np.eye(4)[:3].reshape(-1))
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 4 and stats["segments"] == 2 and stats["pose_ok"] == 3
    assert ("loops" in stats and "ba_events" in stats) == ("--slam" in mode)


@pytest.mark.parametrize("extra, message", [
    (["--resume", "x.npz"], "does not support --resume"),
    (["--save-state", "x.npz"], "does not checkpoint"),
    (["--tracking", "pnp"], "requires --slam"),
    (["--localize", "x.npz"], "its own mode"),
])
def test_cli_timeshard_refusals(tmp_path, data_dir, capsys, extra, message):
    args = cli_args(data_dir.parent.parent / "configs", data_dir, 2) + ["--timeshard", "2", *extra]
    with pytest.raises(SystemExit):
        cli.main(args)
    assert message in capsys.readouterr().err
