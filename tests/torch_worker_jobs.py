"""Picklable helpers for tests that run code in ``tpuslam_torch.dist.workers`` processes.

A worker process unpickles what it is sent by importing the module that
defines it, so these live in a module that imports neither JAX nor a test
file.
"""

import os
import sys


class RecordedDraws:
    """A draw hook that answers from a table keyed by its integer arguments.

    Built around a live hook (``RecordedDraws(fn)``) it calls ``fn`` and
    records each answer; pickled, it carries the table alone, so a worker
    process replays what ``fn`` answered here, and a call the recording
    never saw raises ``KeyError`` there.
    """

    def __init__(self, fn=None):
        self.fn = fn
        self.table = {}

    def __call__(self, *args):
        key = tuple(int(a) for a in args)
        if self.fn is not None and key not in self.table:
            self.table[key] = self.fn(*args)
        return self.table[key]

    def __getstate__(self):
        return {"fn": None, "table": self.table}


def bump_launches(name: str, n: int) -> int:
    """Add ``n`` to kernel wrapper ``name``'s launch count in this process, as ``n`` launches would."""
    from tpuslam_torch.kernels import _wrappers

    _wrappers()[name].launches += n
    return os.getpid()


def answer(n: int) -> dict:
    """An answer of a float32 tensor of ``n`` values, an int64 one, a numpy array and a scalar."""
    import numpy as np
    import torch

    return {"x": torch.linspace(0, 1, n), "i": torch.arange(n // 2), "a": np.arange(7, dtype=np.uint8), "s": n}


def loaded() -> dict:
    """This process's pid and whether it has imported JAX or the reference package."""
    return {"pid": os.getpid(), "jax": "jax" in sys.modules,
            "tpuslam": any(m == "tpuslam" or m.startswith("tpuslam.") for m in sys.modules)}


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on at the time of the call."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def small_parts(repo: str):
    """``test_torch_workers.py``'s small shapes without importing a test file: the camera, the config (K
    512, 256 hypotheses, batch 5) and the 10 fixture frames."""
    import dataclasses
    from pathlib import Path

    import numpy as np

    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.pre.stream import FrameStream

    repo = Path(repo)
    cfg = SlamConfig.from_yaml_dir(repo / "configs", batch_size=5)
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512),
                              pose=dataclasses.replace(cfg.pose, num_hypotheses=256))
    stream = FrameStream(repo / "tests" / "data" / "images")
    frames = np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])
    return Camera.from_yaml(repo / "configs" / "camera.yml"), cfg, frames


def small_system(repo: str, camera, config, tracking: str, ba_iterations: int = 2):
    """``test_torch_workers.py``'s small system (the flat vocabulary, window 4, 1024 points) on the CPU."""
    from pathlib import Path

    from tpuslam_torch.model.system import SlamSystem

    return SlamSystem(camera, config, vocabulary=Path(repo) / "configs" / "vocabulary.npz", tracking=tracking,
                      ba_window=4, ba_interval=2, ba_iterations=ba_iterations, max_map_points=1024, device="cpu")


def multihost_sequences(frames):
    """The per-chunk step's four sequences, (4, 2, 5, H, W): forwards, backwards, rolled by 3 and by 7."""
    import numpy as np

    seqs = np.stack([frames, frames[::-1], np.roll(frames, 3, axis=0), np.roll(frames, 7, axis=0)])
    return seqs.reshape(4, 2, 5, *frames.shape[1:])


def run_step(step, pipe, seqs, fill) -> dict:
    """The per-chunk step over ``seqs``' two chunks with seeds 0-3 → each chunk's results and the final
    states, each list passed through ``fill`` (a global mesh's ``hosts.fill_sequences``)."""
    import numpy as np

    states, results = [pipe.initial_state() for _ in range(len(seqs))], []
    for c in range(seqs.shape[1]):
        res, states = step(seqs[:, c], np.ones(seqs.shape[:1] + seqs.shape[2:3], bool), states, [0, 1, 2, 3])
        results.append(fill(res))
    return {"results": results, "states": fill([None if h is None else step.fetch(h) for h in states])}


def cannot_join(out_path: str) -> None:
    """Rank 1 of 2 at a coordinator address where nothing listens: what ``initialize_multihost`` raised
    (its type's name) and after how many seconds, to ``out_path``."""
    import time
    from pathlib import Path

    from tpuslam_torch.dist import mesh

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    t0 = time.monotonic()
    try:
        mesh.initialize_multihost(f"127.0.0.1:{free_port()}", 2, 1, timeout=2.0)
        got = "joined"
    except Exception as exc:
        got = type(exc).__name__
    Path(out_path).write_text(f"{got} {time.monotonic() - t0}")


def multihost_rank(rank: int, world: int, port: int, repo: str, out_dir: str) -> None:
    """One rank of a two-rank gloo group on the CPU: the dist layer's programs over the global mesh of
    two ``cpu`` entries, then a recipe that differs on rank 1 and a rank that raises; what it saw goes to
    ``out_dir/rank<r>.pkl`` for the parent to hold against the single-process runs."""
    import pickle
    import time
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpuslam_torch.dist import hosts, mesh, timeshard
    from tpuslam_torch.dist.workers import _dumps
    from tpuslam_torch.model.slam import SlamPipeline

    torch.set_num_threads(1)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # both ranks on this host: gloo's pairs over the loopback
    out: dict = {}
    out["joined"] = mesh.initialize_multihost(f"127.0.0.1:{port}", world, rank, timeout=120.0)
    devices = mesh.make_device_mesh(device_type="cpu")
    out["mesh"] = [str(d) for d in devices]
    camera, config, frames = small_parts(repo)
    pipe = SlamPipeline(camera, config, device="cpu")
    out["default_mesh"] = [str(d) for d in timeshard.default_mesh(pipe, 2)]

    pnp = small_system(repo, camera, config, "pnp")
    chunks = np.stack([frames, frames[::-1]]).reshape(2, -1, 5, *frames.shape[1:])
    out["sequence_program"] = mesh.shard_sequence_program(pnp, devices)(chunks, np.ones(chunks.shape[:3], bool),
                                                                        [7, 8])
    out["timesharded"] = timeshard.run_timesharded(pipe, frames, 2, seed=4)
    vo = small_system(repo, camera, config, "vo", ba_iterations=0)
    got = timeshard.run_timesharded_system(vo, frames, 2, seed=3, devices=devices)
    out["timesharded_system"] = {k: v for k, v in got.items() if k != "seconds"}
    with mesh.shard_batched_pipeline(pipe, devices) as step:
        out["step"] = run_step(step, pipe, multihost_sequences(frames), hosts.fill_sequences)

    # rank 1 builds its pipeline with other options: every rank refuses the run, naming rank 1
    other = SlamPipeline(camera, config, device="cpu", map_window=4 if rank == 1 else pipe.map_window)
    try:
        timeshard.run_timesharded(other, frames, 2, devices=devices)
        out["disagree"] = None
    except hosts.RankError as exc:
        out["disagree"] = str(exc)

    def hooks(d: int) -> dict:
        if dist.get_rank() == 1:
            raise RuntimeError(f"shard {d} refused on rank 1")
        return {}

    t0 = time.monotonic()
    try:
        timeshard.run_timesharded(pipe, frames, 2, devices=devices, shard_hooks=hooks)
        out["raised"] = None
    except hosts.RankError as exc:
        out["raised"] = (str(exc), time.monotonic() - t0)
    dist.destroy_process_group()
    out["destroyed"] = not dist.is_initialized()
    out["loaded"] = loaded()
    Path(out_dir, f"rank{rank}.pkl").write_bytes(_dumps(out))
