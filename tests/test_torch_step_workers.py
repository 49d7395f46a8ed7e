"""The per-chunk step over worker processes on the CPU: states resident where they run, bit for bit.

``mesh.shard_batched_pipeline`` over the mesh ``["cpu", "cpu"]`` runs four
VO sequences (the 10 fixture frames forwards, backwards and rolled by 3 and
7; sequences 0 and 2 on entry 0, 1 and 3 on entry 1) over two chunks of 5
frames, its two entries in two ``WorkerPool`` processes at the same time.
Against the same step in this process (``InProcess``, the entries in turn)
it gives the same bits: every result field on every chunk, and the final
states fetched from the workers (``test_torch_dist.py`` holds the step over
workers with the seeds' draws against ``process_chunk``).  Against the
reference's ``shard_batched_pipeline`` on four devices of the conftest's
CPU mesh, with every sequence's chunk c keyed by ``split(PRNGKey(0), 2)[c]``
(``test_torch_timeshard.reference_vo_draws(0, 2)``, whose ranks depend on
the frame index alone, replayed through the pipeline's ``draw_fn``: recorded
in this process, carried to the workers by the picklable
``torch_worker_jobs.RecordedDraws``): ``pose_ok``, ``num_matches`` and
``num_inliers`` identical, poses within ``hold_against_reference``'s 1e-4
(rotations) and 1e-3 (positions).  The workers' wall intervals overlap on
every chunk; frames cross through one block of shared memory an entry,
made at the first call and reused; a state stays in its worker as a
handle, and a handle of another step, a stale one or a closed step raises;
a raising call names its worker; no child is left after ``close()``.
Small shapes (ROADMAP F4): K 512, 256 hypotheses, batch 5, full width, one
torch thread here and in each worker.
"""

import multiprocessing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_system import BATCH, _small
from test_torch_timeshard import reference_vo_draws
from test_torch_workers import overlapping, same
from torch_worker_jobs import RecordedDraws
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.dist.mesh import make_device_mesh as jmesh
from tpuslam.dist.mesh import shard_batched_pipeline as jshard_batched_pipeline
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.dist import mesh
from tpuslam_torch.dist.mesh import StateHandle
from tpuslam_torch.dist.workers import InProcess, WorkerError, WorkerPool
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.pre.stream import FrameStream

REPO = Path(__file__).resolve().parent.parent
MESH = ["cpu", "cpu"]
N_SEQ, N_CHUNKS = 4, 2


@pytest.fixture(scope="module")
def sequences() -> np.ndarray:
    """(4, 2, 5, 512, 1392): the fixture frames forwards, backwards, rolled by 3 and by 7, in chunks."""
    stream = FrameStream(REPO / "tests" / "data" / "images")
    frames = np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])
    seqs = np.stack([frames, frames[::-1], np.roll(frames, 3, axis=0), np.roll(frames, 7, axis=0)])
    return seqs.reshape(N_SEQ, N_CHUNKS, BATCH, *frames.shape[1:])


def port_pipeline(**hooks) -> SlamPipeline:
    cfg = _small(SlamConfig.from_yaml_dir(REPO / "configs", batch_size=BATCH))
    return SlamPipeline(Camera.from_yaml(REPO / "configs" / "camera.yml"), cfg, device="cpu", **hooks)


def drive(step, pipe, sequences, seeds=(0, 1, 2, 3)) -> dict:
    """The step over both chunks from fresh states → results by chunk, the final states fetched, and by
    chunk the walls and the names of the pool's frame blocks."""
    states, out = [pipe.initial_state() for _ in range(N_SEQ)], {"results": [], "handles": [], "walls": [],
                                                      "blocks": []}
    valid = np.ones((N_SEQ, BATCH), bool)
    for c in range(N_CHUNKS):
        results, states = step(sequences[:, c], valid, states, list(seeds))
        assert all(isinstance(h, StateHandle) for h in states)
        out["results"].append(results)
        out["handles"].append(states)
        out["walls"].append(dict(step.pool.last_walls))
        out["blocks"].append({i: b.shm.name for i, b in getattr(step.pool, "_blocks", {}).items()})
    out["states"] = [step.fetch(h) for h in states]
    return out


@pytest.fixture(scope="module")
def pool():
    with WorkerPool(MESH) as p:
        yield p


@pytest.fixture(scope="module")
def runs(pool, sequences):
    """The reference's draws, recorded as the step in this process (the entries in turn) asks for them,
    then replayed in the two workers."""
    pipe = port_pipeline(draw_fn=RecordedDraws(reference_vo_draws(0, N_CHUNKS)))
    with mesh.shard_batched_pipeline(pipe, MESH, pool=InProcess(MESH)) as step:
        in_turn = drive(step, pipe, sequences)
    with mesh.shard_batched_pipeline(pipe, MESH, pool=pool) as step:
        yield in_turn, drive(step, pipe, sequences), step


def test_pooled_step_equals_in_process(runs):
    in_turn, pooled, _ = runs
    same(pooled["results"], in_turn["results"], "results")
    same(pooled["states"], in_turn["states"], "states")
    assert all(overlapping(w) for w in pooled["walls"])
    assert all(r.poses.device.type == "cpu" for c in pooled["results"] for r in c)
    assert all(st.frame_idx == N_CHUNKS * BATCH for st in pooled["states"])


def test_frames_cross_through_one_block_an_entry(runs):
    """Both calls' frames went through the same two blocks, made at the first call."""
    blocks = runs[1]["blocks"]
    assert sorted(blocks[0]) == [0, 1] and blocks[1] == blocks[0]


def test_pooled_step_matches_reference(runs, sequences):
    """The reference's sharded step on 4 CPU devices, each sequence's chunk c keyed by
    ``split(PRNGKey(0), 2)[c]``."""
    got, got_states = runs[1]["results"], runs[1]["states"]
    cfg_dir = REPO / "configs"
    jpipe = JPipeline(JCamera.from_yaml(cfg_dir / "camera.yml"),
                      _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)))
    jstep = jshard_batched_pipeline(jpipe, jmesh(N_SEQ))
    states = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_SEQ, *a.shape)), jpipe.initial_state())
    keys = jax.random.split(jax.random.PRNGKey(0), N_CHUNKS)
    valid = jnp.ones((N_SEQ, BATCH), bool)
    for c in range(N_CHUNKS):
        want, states = jstep(jnp.asarray(sequences[:, c]), valid, states, jnp.stack([keys[c]] * N_SEQ))
        for s in range(N_SEQ):
            for k in ("pose_ok", "num_matches", "num_inliers"):
                np.testing.assert_array_equal(getattr(got[c][s], k).numpy(), np.asarray(getattr(want, k))[s],
                                              err_msg=f"chunk {c} sequence {s} {k}")
            poses, want_poses = got[c][s].poses.numpy(), np.asarray(want.poses)[s]
            np.testing.assert_allclose(poses[:, :3, :3], want_poses[:, :3, :3], atol=1e-4)
            np.testing.assert_allclose(poses[:, :3, 3], want_poses[:, :3, 3], atol=1e-3)
    for s in range(N_SEQ):
        np.testing.assert_allclose(got_states[s].pose[:3, 3].numpy(), np.asarray(states.pose)[s, :3, 3], atol=1e-3)
        assert got_states[s].frame_idx == int(np.asarray(states.frame_idx)[s])
    assert sum(int(got[c][s].pose_ok.sum()) for c in range(N_CHUNKS) for s in range(N_SEQ)) >= 30


def test_handles_stay_in_the_worker(runs, pool, sequences):
    """A handle carries no tensor; another step's handle, a stale handle and a closed step raise, naming
    the step, and closing drops the step's states from the workers."""
    _, pooled, step = runs
    first, last = pooled["handles"]
    assert not any(torch.is_tensor(x) for h in last for x in h)
    valid, seeds = np.ones((N_SEQ, BATCH), bool), [0, 1, 2, 3]
    with mesh.shard_batched_pipeline(port_pipeline(), MESH, pool=pool) as other:
        with pytest.raises(ValueError, match=f"state 0 is a handle of step {step.name}, not of step {other.name}"):
            other(sequences[:, 1], valid, last, seeds)
    with pytest.raises(WorkerError, match=f"step {step.name}: sequence 0's handle is call 1's state, and call 2's"):
        step(sequences[:, 1], valid, first, seeds)
    assert any(k[0] == step.name for k in pool.run([(0, dict.copy, (mesh.HELD,))])[0])
    step.close()
    assert not any(k[0] == step.name for k in pool.run([(0, dict.copy, (mesh.HELD,))])[0])
    with pytest.raises(RuntimeError, match=f"step {step.name} is closed"):
        step(sequences[:, 1], valid, last, seeds)
    with pytest.raises(RuntimeError, match="closed"):
        step.fetch(last[0])


def test_a_raising_call_names_its_worker(pool, sequences):
    pipe = port_pipeline()
    with mesh.shard_batched_pipeline(pipe, MESH, pool=pool) as step:
        states = [pipe.initial_state(), "not a state"]
        with pytest.raises(WorkerError, match=r"worker 1 \(cpu\) failed in tpuslam_torch\.dist\.mesh\._step_entry"):
            step(sequences[:2, 0], np.ones((2, BATCH), bool), states, [0, 1])


def test_a_step_that_starts_its_pool_leaves_no_child(sequences):
    pipe = port_pipeline()
    before = set(multiprocessing.active_children())
    step = mesh.shard_batched_pipeline(pipe, MESH)
    assert step.pool is None  # started at the first call
    results, _ = step(sequences[:2, 0], np.ones((2, BATCH), bool), [pipe.initial_state()] * 2, [0, 1])
    pids = step.pool.pids
    assert len(results) == 2 and len(set(pids)) == 2
    step.close()
    assert set(multiprocessing.active_children()) <= before
    assert not {c.pid for c in multiprocessing.active_children()} & set(pids)
