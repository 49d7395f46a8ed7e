"""A mesh that spans a process group, on the CPU: two gloo ranks give the single-process runs' bits.

Two ranks start with ``spawn`` (``torch_worker_jobs.multihost_rank``, which
imports no JAX) and join a gloo group on 127.0.0.1 at a free port through
``initialize_multihost``; ``make_device_mesh(device_type="cpu")`` then gives
the global mesh of two entries, one a rank, and ``default_mesh`` takes it.
On it, every rank returns the bits of the same program run in this one
process over the mesh ``["cpu", "cpu"]`` (``InProcess``, the entries in
turn), on every rank: ``shard_sequence_program`` (two PnP SLAM sequences,
the carries and raw outputs), ``run_timesharded`` (VO, 2 shards) and
``run_timesharded_system`` (VO, 2 shards, 0 LM steps as ROADMAP F5 holds
time-sharded SLAM; every field but ``seconds``), and the per-chunk step
(four VO sequences over two chunks) with ``hosts.fill_sequences`` gathering
each rank's sequences.  Those single-process runs are held against the
reference by ``test_torch_dist.py``, ``test_torch_timeshard*.py`` and
``test_torch_step_workers.py``.  Then the group's refusals: a coordinator
address where nothing listens makes a rank raise within its timeout; a
recipe that differs on rank 1 raises on every rank, naming rank 1; a rank
that raises is named, with its traceback, on every rank within 60 s; the
group is destroyed and no process is left; the ranks load no JAX and
nothing of the reference package.  Small shapes (ROADMAP F4): the
10 fixture frames at full width, K 512, 256 hypotheses, batch 5, one torch
thread in every process.
"""

import multiprocessing
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_worker_jobs as jobs
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_workers import same
from tpuslam_torch.dist import mesh, timeshard
from tpuslam_torch.dist.workers import InProcess
from tpuslam_torch.model.slam import SlamPipeline

REPO = Path(__file__).resolve().parent.parent
MESH = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' records, and this process's single-process runs, made while the ranks run."""
    out_dir = tmp_path_factory.mktemp("ranks")
    before = set(multiprocessing.active_children())
    ctx = torch.multiprocessing.start_processes(jobs.multihost_rank,
                                                args=(2, jobs.free_port(), str(REPO), str(out_dir)),
                                                nprocs=2, join=False, start_method="spawn")
    pids = ctx.pids()
    refused = multiprocessing.get_context("spawn").Process(target=jobs.cannot_join, args=(str(out_dir / "refused"),))
    refused.start()
    camera, config, frames = jobs.small_parts(str(REPO))
    pipe = SlamPipeline(camera, config, device="cpu")
    pnp = jobs.small_system(str(REPO), camera, config, "pnp")
    chunks = np.stack([frames, frames[::-1]]).reshape(2, -1, 5, *frames.shape[1:])
    want = {"sequence_program": mesh.shard_sequence_program(pnp, MESH, pool=InProcess(MESH))(
                chunks, np.ones(chunks.shape[:3], bool), [7, 8]),
            "timesharded": timeshard.run_timesharded(pipe, frames, 2, seed=4, devices=MESH, pool=InProcess(MESH))}
    vo = jobs.small_system(str(REPO), camera, config, "vo", ba_iterations=0)
    got = timeshard.run_timesharded_system(vo, frames, 2, seed=3, devices=MESH, pool=InProcess(MESH))
    want["timesharded_system"] = {k: v for k, v in got.items() if k != "seconds"}
    with mesh.shard_batched_pipeline(pipe, MESH, pool=InProcess(MESH)) as step:
        want["step"] = jobs.run_step(step, pipe, jobs.multihost_sequences(frames), lambda x: x)
    while not ctx.join(timeout=300):
        pass
    refused.join(60)
    records = [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    name, seconds = (out_dir / "refused").read_text().split()
    records[1]["refused"] = (name, float(seconds))
    return records, want, pids + [refused.pid], before


def test_ranks_join_a_global_mesh(ranks):
    records, _, pids, _ = ranks
    for r, rec in enumerate(records):
        assert rec["joined"] is True
        assert rec["mesh"] == rec["default_mesh"] == ["rank 0 cpu", "rank 1 cpu"], r
        assert rec["loaded"]["pid"] == pids[r] and not rec["loaded"]["jax"] and not rec["loaded"]["tpuslam"]


@pytest.mark.parametrize("program", ["sequence_program", "timesharded", "timesharded_system", "step"])
def test_every_rank_equals_the_single_process_run(ranks, program):
    records, want, _, _ = ranks
    for r, rec in enumerate(records):
        same(rec[program], want[program], f"rank {r} {program}")
    if program == "sequence_program":
        assert all(t.device.type == "cpu" for t in records[0][program][0][1] if torch.is_tensor(t))
    if program == "timesharded_system":
        assert want[program]["pose_ok"].sum() >= 8 and want[program]["dbs"] is not None


def test_a_rank_that_cannot_join_raises(ranks):
    records, _, _, _ = ranks
    name, seconds = records[1]["refused"]
    assert name in ("DistStoreError", "DistNetworkError", "RuntimeError", "TimeoutError") and seconds < 30


def test_a_recipe_that_differs_raises_on_every_rank(ranks):
    records, _, _, _ = ranks
    for rec in records:
        assert rec["disagree"] is not None and "rank(s) [1] disagree with rank 0 on the recipe" in rec["disagree"]


def test_a_raising_rank_is_named_on_every_rank(ranks):
    records, _, _, _ = ranks
    for r, rec in enumerate(records):
        message, seconds = rec["raised"]
        assert message.startswith(f"rank 1 failed (seen on rank {r})") and seconds < 60
        assert "RuntimeError: shard 1 refused on rank 1" in message and "Traceback" in message


def test_the_group_ends_and_no_process_is_left(ranks):
    records, _, pids, before = ranks
    assert all(rec["destroyed"] for rec in records)
    assert set(multiprocessing.active_children()) <= before
    assert not {c.pid for c in multiprocessing.active_children()} & set(pids)
