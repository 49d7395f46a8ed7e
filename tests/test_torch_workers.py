"""tpuslam_torch.dist.workers on the CPU: one worker process per mesh entry, at the same time, bit for bit.

With the mesh ``["cpu", "cpu"]`` each whole-run program of the dist layer
runs its two entries in two worker processes (``WorkerPool``) at the same
time and gives the in-process, in-turn run's bits: ``shard_sequence_program``
(two PnP SLAM sequences with the flat vocabulary, seeds 7 and 8) against
``run_sequence`` of each on every field of ``_fold_sequence``;
``run_timesharded`` and ``run_timesharded_system`` (VO) at 2 shards against
``devices=["cpu"]`` on every returned field but ``seconds`` (and, for
``run_timesharded``, against the entries in turn in this process,
``InProcess``); the workers' wall intervals overlap.  The in-process path is held against the
reference in ``test_torch_dist.py`` and ``test_torch_timeshard*.py``, and
``test_torch_timeshard.py`` holds this path against the reference's
``run_timesharded`` directly.  Then the pool itself: launches the workers
report reach ``launch_counts()``; answers come back as host tensors and
arrays, their bytes through shared memory that is unlinked after; a worker
has TF32 off, one torch thread here (the parent's) and no JAX; a call that raises surfaces its message,
worker index and traceback and leaves the pool usable; a worker that exits
raises ``WorkerDied`` within a bounded wait and closes the pool; an
unpicklable hook raises ``ValueError`` naming it; no child survives
``close()``.  Small shapes (ROADMAP F4): the 10 fixture frames at full
width, K 512, 256 hypotheses, batch 5, a back end of window 4 and 1024
points; this process and each worker on one torch thread.
"""

import multiprocessing
import operator
import os
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_worker_jobs
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_system import BATCH, _small
from tpuslam_torch import kernels
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.dist import mesh, timeshard, workers
from tpuslam_torch.dist.workers import InProcess, WorkerDied, WorkerError, WorkerPool
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.model.system import SlamSystem
from tpuslam_torch.pre.stream import FrameStream

REPO = Path(__file__).resolve().parent.parent
MESH = ["cpu", "cpu"]


def same(got, want, path: str = "result") -> None:
    """``got`` equals ``want`` bit for bit: arrays and tensors, and the dicts, lists, tuples and scalars
    holding them."""
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype, path
        assert torch.equal(got.cpu(), want.cpu()), path
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert np.asarray(got).dtype == want.dtype, path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


def overlapping(walls: dict) -> bool:
    """Whether every entry's wall interval overlaps every other's."""
    return len(walls) > 1 and max(t0 for t0, _ in walls.values()) < min(t1 for _, t1 in walls.values())


@pytest.fixture(scope="module")
def frames() -> np.ndarray:
    stream = FrameStream(REPO / "tests" / "data" / "images")
    return np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])


@pytest.fixture(scope="module")
def camera() -> Camera:
    return Camera.from_yaml(REPO / "configs" / "camera.yml")


@pytest.fixture(scope="module")
def config() -> SlamConfig:
    return _small(SlamConfig.from_yaml_dir(REPO / "configs", batch_size=BATCH))


def small_system(camera, config, tracking: str, **hooks) -> SlamSystem:
    return SlamSystem(camera, config, vocabulary=REPO / "configs" / "vocabulary.npz", tracking=tracking,
                      ba_window=4, ba_interval=2, ba_iterations=2, max_map_points=1024, device="cpu", **hooks)


@pytest.fixture(scope="module")
def pool():
    with WorkerPool(MESH) as p:
        yield p


def test_workers_start_on_their_devices(pool):
    assert [info["device"] for info in pool.info] == MESH
    assert len(set(pool.pids)) == 2 and os.getpid() not in pool.pids
    assert all(info["threads"] == 1 and not info["tf32"] for info in pool.info)  # the parent runs one thread
    for got in pool.run([(e, torch_worker_jobs.loaded, ()) for e in range(2)]):
        assert got["pid"] in pool.pids and not got["jax"] and not got["tpuslam"]


def test_shard_sequence_program_over_workers_equals_in_turn(pool, camera, config, frames):
    """Two PnP SLAM sequences, one a worker at the same time: each == ``run_sequence`` of its frames and
    seed on every field of the fold, the carry coming back on the host."""
    system = small_system(camera, config, "pnp")
    seqs = np.stack([frames, frames[::-1]])
    chunks = seqs.reshape(2, -1, BATCH, *frames.shape[1:])
    valid = np.ones(chunks.shape[:3], bool)
    seeds = [7, 8]
    carries, outs = mesh.shard_sequence_program(system, MESH, pool=pool)(chunks, valid, seeds)
    assert overlapping(pool.last_walls)
    for s in range(2):
        assert all(t.device.type == "cpu" for t in carries[s][0] if torch.is_tensor(t))
        got = system._fold_sequence(outs[s], len(frames), carries[s])
        same(got, system.run_sequence(seqs[s], seed=seeds[s]), f"sequence {s}")
        assert got["pose_ok"][1:].any() and got["ba_events"]


def test_run_timesharded_system_over_workers_equals_in_process(pool, camera, config, frames):
    """VO full SLAM, 2 shards (S 5, V 5): the shards' runs and folds in two workers at once == in turn in
    this process, every field but ``seconds``."""
    system = small_system(camera, config, "vo")
    want = timeshard.run_timesharded_system(system, frames, 2, seed=3, devices=["cpu"])
    got = timeshard.run_timesharded_system(system, frames, 2, seed=3, devices=MESH, pool=pool)
    assert overlapping(pool.last_walls)
    assert (got["S"], got["V"]) == (5, 5) and len(got["seconds"]["workers"]) == 2
    assert len(want["seconds"]["workers"]) == 1
    for k in ("shards", "folds"):
        assert len(got["seconds"][k]) == 2 and min(got["seconds"][k]) > 0
    same({k: v for k, v in got.items() if k != "seconds"}, {k: v for k, v in want.items() if k != "seconds"})
    assert got["ba_events"] and got["pose_ok"].sum() >= 8


def test_run_timesharded_over_workers_equals_in_process(camera, config, frames):
    """VO, 2 shards: each shard batched alone in its worker == both batched in one call here, and == the
    two entries in turn here (``InProcess``); without ``pool`` the call starts its workers and closes
    them after it."""
    pipe = SlamPipeline(camera, config, device="cpu")
    want = timeshard.run_timesharded(pipe, frames, 2, seed=4, devices=["cpu"])
    before = set(multiprocessing.active_children())
    same(timeshard.run_timesharded(pipe, frames, 2, seed=4, devices=MESH), want)
    assert set(multiprocessing.active_children()) <= before
    same(timeshard.run_timesharded(pipe, frames, 2, seed=4, devices=MESH, pool=InProcess(MESH)), want)
    assert want["pose_ok"].sum() >= 8


def test_default_mesh_takes_the_visible_cards(monkeypatch, camera, config):
    pipe = SlamPipeline(camera, config, device="cpu")
    assert timeshard.default_mesh(pipe, 4) == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    fake = SimpleNamespace(device=torch.device("cuda", 0))  # a pipeline on the card: only its device is read
    assert timeshard.default_mesh(fake, 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert timeshard.default_mesh(fake, 8) == [torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert timeshard.default_mesh(fake, 4) == [torch.device("cuda", 0)]


def test_answers_cross_as_host_arrays_through_shared_memory(pool):
    """Tensors come back as CPU tensors of their dtype and numpy arrays as themselves, their bytes through
    a block of shared memory that the parent unlinks after reading it."""
    values = {"t": torch.arange(6, dtype=torch.int16).reshape(2, 3).t(), "b": torch.tensor([True, False]),
              "a": np.linspace(0, 1, 5, dtype=np.float32), "n": 3}
    blob, name, sizes = workers._pack(values)
    assert (workers._SHM_DIR / name).exists() and sum(sizes) >= values["a"].nbytes
    same(workers._unpack(blob, name, sizes), values)
    assert not (workers._SHM_DIR / name).exists()
    got = pool.run([(1, torch_worker_jobs.answer, (4096,))])[0]
    same(got, torch_worker_jobs.answer(4096))
    assert list(pool.last_answers) == [1] and pool.last_answers[1]["bytes"] > 4096 * 4
    assert pool.last_answers[1]["pack_s"] >= 0 and pool.last_answers[1]["unpack_s"] >= 0


def test_worker_launches_reach_launch_counts(pool):
    kernels.reset_launch_counts()
    pids = pool.run([(0, torch_worker_jobs.bump_launches, ("msac_scores", 3)),
                     (1, torch_worker_jobs.bump_launches, ("msac_scores", 4)),
                     (1, torch_worker_jobs.bump_launches, ("fused_frontend_batch", 2))])
    assert pids[1] == pids[2] != pids[0]
    counts = kernels.launch_counts()
    assert counts["msac_scores"] == 7 and counts["fused_frontend_batch"] == 2 and counts["brief_own_bin_dots"] == 0
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts().values())


def test_a_call_that_raises_names_its_worker(pool):
    with pytest.raises(WorkerError, match=r"worker 1 \(cpu\) failed in _operator\.truediv") as err:
        pool.run([(0, operator.add, (1, 2)), (1, operator.truediv, (1, 0))])
    assert "ZeroDivisionError: division by zero" in str(err.value) and "Traceback" in str(err.value)
    assert pool.run([(1, operator.add, (2, 3))]) == [5]  # the pool goes on


def test_unpicklable_hooks_raise_naming_the_hook(pool, camera, config, frames):
    pipe = SlamPipeline(camera, config, device="cpu")
    with pytest.raises(ValueError, match="shard 0: hook 'draw_fn'"):
        timeshard.run_timesharded(pipe, frames, 2, devices=MESH, pool=pool,
                                  shard_hooks=lambda d: {"draw_fn": lambda *a: None})
    system = small_system(camera, config, "pnp", lc_draw_fn=lambda *a: None)
    chunks = frames[None].reshape(1, -1, BATCH, *frames.shape[1:])
    with pytest.raises(ValueError, match="SlamSystem: hook 'lc_draw_fn'"):
        mesh.shard_sequence_program(system, MESH, pool=pool)(chunks, np.ones(chunks.shape[:3], bool), [0])
    assert pool.run([(0, operator.add, (1, 1))]) == [2]


def test_a_dying_worker_raises_within_a_bounded_wait():
    p = WorkerPool(MESH)
    t0 = time.monotonic()
    with pytest.raises(WorkerDied, match=r"worker 1 \(cpu, pid \d+\) died \(exit code 1\)"):
        p.run([(0, time.sleep, (60,)), (1, os._exit, (1,))])
    assert time.monotonic() - t0 < 30 and p.closed
    assert not any(proc.is_alive() for proc in p._procs)


def test_close_leaves_no_child():
    with WorkerPool(MESH) as p:
        pids = p.pids
        assert p.run([(e, operator.mul, (e, 3)) for e in range(2)]) == [0, 3]
    assert p.closed and not set(pids) & {c.pid for c in multiprocessing.active_children()}
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    with pytest.raises(RuntimeError, match="closed"):
        p.run([(0, operator.add, (1, 1))])
