"""Time-sharded tracking: tpuslam_torch.dist.timeshard against tpuslam.dist.timeshard on the CPU.

The host helpers are copies: the shard plan, the windows and their
staging identical to the reference's on its own cases and on a hypothesis
sweep of (n, D, B, V); the Sim(3) fit, its application and the stitch to
1e-12 on the reference's cases (collinear centres, a dropout inside an
overlap).  Then ``run_timesharded`` at 2 shards over 40 tiled fixture
frames (K 512, 256 two-view hypotheses, batch 5: S = 20, V = 5) against the
reference's on a 2-device CPU mesh, the port replaying the reference's
draws: shard d's chunk c draws from ``split(PRNGKey(d), C)[c]`` folded with
the local frame index.  Per shard ``pose_ok`` identical, rotations within
1e-4 and positions 1e-3; the stitched positions within 2e-3 of the path
length and the stitch's Sim(3) scale within 1e-3 relative.  The same run
with the two shards in two worker processes at once (``devices=["cpu",
"cpu"]``), each replaying the reference's draws it answered in the
in-process run (``torch_worker_jobs.RecordedDraws``, picklable): the
in-process run's bits, so the same holds against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from test_timeshard import _smooth_trajectory
from torch_worker_jobs import RecordedDraws
from test_torch_dist import tiny_frames, tiny_pipeline
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_system import _small
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.dist import timeshard as jts
from tpuslam.dist.mesh import make_device_mesh as jmesh
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.dist import timeshard as tts
from tpuslam_torch.model.slam import SlamPipeline as TPipeline
from tpuslam_torch.pre.stream import FrameStream

BATCH, N_FRAMES, SHARDS = 5, 40, 2


def frame_stack(n: int) -> np.ndarray:
    """(n, 4, 4) uint8 frames whose pixels are their index."""
    return np.arange(n, dtype=np.uint8)[:, None, None] * np.ones((1, 4, 4), np.uint8)


def plan(fn, *args):
    try:
        return fn(*args)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("n, D, B, V", [(37, 3, 4, None), (40, 2, 5, None), (40, 4, 5, 10), (10, 1, 4, None),
                                        (5, 3, 4, None), (9, 2, 3, 6), (12, 0, 4, None), (12, 2, 4, 3)])
def test_plan_and_windows_match_reference(n, D, B, V):
    want = plan(jts.plan_time_shards, n, D, B, V)
    assert plan(tts.plan_time_shards, n, D, B, V) == want
    if isinstance(want[0], str):
        return
    frames = frame_stack(n)
    for w, g in zip(jts.shard_frames_in_time(frames, D, B, V), tts.shard_frames_in_time(frames, D, B, V)):
        np.testing.assert_array_equal(g, w)


@settings(max_examples=80, deadline=None)
@given(n=st.integers(1, 90), D=st.integers(1, 6), B=st.integers(1, 8), k=st.one_of(st.none(), st.integers(0, 3)))
def test_plan_and_windows_sweep(n, D, B, k):
    V = None if k is None else k * B
    test_plan_and_windows_match_reference(n, D, B, V)


@pytest.mark.parametrize("n, D, B", [(37, 3, 4), (40, 2, 5), (23, 3, 2)])
def test_stage_shard_matches_reference_staging(tmp_path, n, D, B):
    """Shard by shard from a disk-backed memmap, as the CLI stages: the reference's per-device staging."""
    mm = np.memmap(tmp_path / "frames.u8", dtype=np.uint8, mode="w+", shape=(n, 4, 4))
    mm[:] = frame_stack(n)
    mm.flush()
    want_chunks, want_valid, S, V = jts.stage_shards_to_mesh(mm, D, B, jmesh(D))
    for d in range(D):
        chunks, valid = tts.stage_shard(mm, d, S, V, B, "cpu")
        np.testing.assert_array_equal(chunks.numpy(), np.asarray(want_chunks)[d])
        np.testing.assert_array_equal(valid.numpy(), want_valid[d])


def random_rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def test_sim3_matches_reference():
    rng = np.random.default_rng(0)
    T = _smooth_trajectory(12)
    R, t, s = random_rotation(rng), rng.normal(size=3), 1.7
    T_dst = jts.apply_sim3(R, t, s, T) + rng.normal(scale=1e-3, size=(12, 4, 4)) * (np.arange(4) < 3)[None, :, None]
    np.testing.assert_allclose(tts.apply_sim3(R, t, s, T), jts.apply_sim3(R, t, s, T), rtol=0, atol=1e-12)
    for g, w in zip(tts.sim3_from_pose_pairs(T, T_dst), jts.sim3_from_pose_pairs(T, T_dst)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    Rg, tg, sg = tts.sim3_from_pose_pairs(T, jts.apply_sim3(R, t, s, T))
    np.testing.assert_allclose(Rg, R, atol=1e-9)
    np.testing.assert_allclose(tg, t, atol=1e-9)
    assert sg == pytest.approx(s, abs=1e-9)


def test_sim3_collinear_centres_match_reference():
    """Forward motion on a straight line: the polar-mean rotation still recovers a roll about z."""
    T = np.tile(np.eye(4), (8, 1, 1))
    T[:, 2, 3] = np.arange(8, dtype=float)
    c, s_ = np.cos(0.5), np.sin(0.5)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    T_dst = tts.apply_sim3(R, np.zeros(3), 1.0, T)
    got, want = tts.sim3_from_pose_pairs(T, T_dst), jts.sim3_from_pose_pairs(T, T_dst)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[0], R, atol=1e-9)
    assert got[2] == pytest.approx(1.0, abs=1e-9)


def corrupted_segments(seed: int, D: int, S: int = 20, V: int = 5) -> np.ndarray:
    """A ground-truth trajectory cut into overlapping segments, each but the first under a random Sim(3)."""
    gt = _smooth_trajectory(D * S + V)
    rng = np.random.default_rng(seed)
    segs = []
    for d in range(D):
        start = 0 if d == 0 else d * S - V
        seg = gt[start : start + S + V]
        if d:
            seg = jts.apply_sim3(random_rotation(rng), rng.normal(size=3), rng.uniform(0.5, 2.0), seg)
        segs.append(seg)
    return gt, np.stack(segs)


@pytest.mark.parametrize("gated", [False, True])
def test_stitch_segments_matches_reference(gated):
    """Clean segments (the stitch recovers the ground truth) and a dropout re-tracked wrongly inside an
    overlap, with ``pose_ok`` gating it out and without; also fewer than 2 good pairs (all pairs)."""
    S, V, D = 20, 5, 4
    gt, segs = corrupted_segments(1, D, S, V)
    n = D * S - 3  # the last shard padded
    pose_ok = None
    if gated:
        segs = segs.copy()
        segs[1, 2, :3, 3] += np.array([5.0, -3.0, 4.0])
        pose_ok = np.ones((D, S + V), bool)
        pose_ok[1, 2] = False
        pose_ok[2, :4] = False  # one usable pair: the stitch falls back to all five
    got = tts.stitch_segments(segs, S, V, n, pose_ok=pose_ok)
    want = jts.stitch_segments(segs, S, V, n, pose_ok=pose_ok)
    assert got.dtype == np.float32 and got.shape == (n, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if not gated:
        assert np.abs(got[:, :3, 3] - gt[:n, :3, 3]).max() < 1e-3


def reference_vo_draws(d: int, n_chunks: int):
    """Shard d's two-view ranks as the reference's ``run_timesharded`` draws them."""
    keys = jax.random.split(jax.random.PRNGKey(d), n_chunks)

    def draws(frame_idx, n_valid, H, S):
        key = jax.random.fold_in(keys[frame_idx // BATCH], frame_idx)
        return np.array(jax.random.randint(key, (H, S), 0, jnp.maximum(jnp.int32(int(n_valid)), 1)))

    return draws


def tiled_frames(data_dir) -> np.ndarray:
    stream = FrameStream(data_dir / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    return np.stack([base[i % 10] for i in range(N_FRAMES)])


def port_pipeline(data_dir) -> TPipeline:
    cfg_dir = data_dir.parent.parent / "configs"
    return TPipeline(TCamera.from_yaml(cfg_dir / "camera.yml"),
                     _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), device="cpu")


@pytest.fixture(scope="module")
def recorded_draws():
    """Each shard's reference draws, recorded as the in-process run asks for them."""
    S, V = tts.plan_time_shards(N_FRAMES, SHARDS, BATCH)
    return {d: RecordedDraws(reference_vo_draws(d, (S + V) // BATCH)) for d in range(SHARDS)}


@pytest.fixture(scope="module")
def tiled_runs(data_dir, recorded_draws):
    cfg_dir = data_dir.parent.parent / "configs"
    frames = tiled_frames(data_dir)
    jpipe = JPipeline(JCamera.from_yaml(cfg_dir / "camera.yml"),
                      _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)))
    want = jts.run_timesharded(jpipe, frames, n_shards=SHARDS, mesh=jmesh(SHARDS), seed=0)
    got = tts.run_timesharded(port_pipeline(data_dir), frames, SHARDS, seed=0, devices=["cpu"],
                              shard_hooks=lambda d: {"draw_fn": recorded_draws[d]})
    return want, got


def hold_against_reference(got, want):
    S, V = got["S"], got["V"]
    assert (S, V) == (want["S"], want["V"]) == (20, 5)
    assert got["poses"].shape == (N_FRAMES, 4, 4) and got["segments"].shape == (SHARDS, S + V, 4, 4)
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    seg, seg_want = got["segments"], want["segments"]
    np.testing.assert_allclose(seg[..., :3, :3], seg_want[..., :3, :3], atol=1e-4)
    np.testing.assert_allclose(seg[..., :3, 3], seg_want[..., :3, 3], atol=1e-3)
    path = np.linalg.norm(np.diff(want["poses"][:, :3, 3], axis=0), axis=1).sum()
    assert path > 5.0
    assert np.abs(got["poses"][:, :3, 3] - want["poses"][:, :3, 3]).max() < 2e-3 * path
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-3)
    ok = got["segments_ok"][1, :V] & got["segments_ok"][0, S - V : S]
    s_got = tts.sim3_from_pose_pairs(seg[1, :V][ok], seg[0, S - V : S][ok])[2]
    s_want = jts.sim3_from_pose_pairs(seg_want[1, :V][ok], seg_want[0, S - V : S][ok])[2]
    assert s_got == pytest.approx(s_want, rel=1e-3)
    assert got["pose_ok"].sum() >= N_FRAMES - 5  # frame 0 and the tiling's cuts at 10, 20, 30 have no pair


def test_run_timesharded_matches_reference(tiled_runs):
    want, got = tiled_runs
    hold_against_reference(got, want)


def test_run_timesharded_in_workers_matches_reference(data_dir, tiled_runs, recorded_draws):
    """The two shards in two worker processes at the same time, replaying the draws recorded above."""
    want, got = tiled_runs
    workers = tts.run_timesharded(port_pipeline(data_dir), tiled_frames(data_dir), SHARDS, seed=0,
                                  devices=["cpu", "cpu"], shard_hooks=lambda d: {"draw_fn": recorded_draws[d]})
    for k in ("poses", "pose_ok", "segments", "segments_ok", "S", "V"):
        np.testing.assert_array_equal(workers[k], got[k], err_msg=k)
    hold_against_reference(workers, want)


def test_timesharded_shard_is_its_window_alone():
    """Each shard's raw trajectory is that window run alone through ``process_sequence`` with seed + d
    (the port's own draws), bit for bit; at ``test_torch_dist.py``'s small shapes, the last shard padded."""
    frames = tiny_frames(5)
    pipe = tiny_pipeline()
    out = tts.run_timesharded(pipe, frames, 2, seed=3)
    S, V = out["S"], out["V"]
    assert (S, V) == (4, 2) and out["poses"].shape == (5, 4, 4)
    assert not out["segments_ok"][1, 3:].any() and out["pose_ok"][1:].all()  # frames 5-7 pad the last shard
    for d in range(2):
        chunks, valid = tts.stage_shard(frames, d, S, V, 2, "cpu")
        alone, _ = pipe.process_sequence(chunks, valid, pipe.initial_state(), seed=3 + d)
        np.testing.assert_array_equal(out["segments"][d], alone.poses.reshape(-1, 4, 4).numpy())
        np.testing.assert_array_equal(out["segments_ok"][d], alone.pose_ok.reshape(-1).numpy())
