"""One worker process per mesh entry: the dist layer's whole-run programs on distinct devices at once.

The reference runs one program per device at the same time (``shard_map``
over ``make_device_mesh(n)``, ``tpuslam/dist/mesh.py``).  The port's host
code is eager Python that keeps a card 10-17% busy, so devices driven from
one interpreter would share its lock over exactly that work.  As PyTorch
drives several cards (torchrun, DDP), ``WorkerPool(devices)`` gives each
entry of the mesh a process of its own: a ``ProcessPoolExecutor`` of one
worker; two entries that name one device give two processes on that card.

- Processes start with ``spawn``: ``fork`` is unsafe once the parent has
  initialised CUDA.  Before it starts them, the parent builds the kernel
  library when the mesh names a card, so that the workers load it instead
  of each compiling its own.
- Each worker sets its card (``torch.cuda.set_device``) and takes
  ``max(1, min(the parent's torch threads, cores // n))`` torch threads.
  It imports ``tpuslam_torch``, so TF32 is off there as well
  (``info[i]["tf32"]``).  A worker opens no frame loader: frames reach it
  as a file it maps (below).
- A worker builds each replica it needs once, from ``mesh.recipe(obj)``
  (``mesh.from_recipe``, as ``mesh.replica_on`` builds one), and keeps it under the
  recipe's hash; never from the parent's tensors.  A draw hook that cannot
  be pickled raises ``ValueError`` naming it.
- ``run(calls, obj, frames)`` sends every entry its calls at once; each
  worker runs its own in order, ``fn(replica, frames, *args)``, and answers
  with the values, its wall interval (``last_walls``: ``time.monotonic``,
  one clock for every process of a host) and its kernel launches, which
  ``kernels.launch_counts()`` adds.  Tensors cross either way as numpy
  arrays on the host.  An answer's arrays travel out of band: the worker
  copies their bytes into one block of POSIX shared memory and the parent
  copies them out and unlinks it, so the pipe carries only the pickle's
  skeleton (``last_answers``: the bytes, and the seconds each side spent).
- Frames reach a worker as a file it maps read-only: an ``np.memmap`` by
  its own path and offset, anything else copied once into POSIX shared
  memory for the call.  A worker reads only the rows it runs.
- No silent fallback.  A call that raises in a worker raises
  ``WorkerError`` in the parent with the worker's index, device and
  traceback, once the other workers have answered; a worker that dies
  (killed, out of memory, a fault) raises ``WorkerDied`` as soon as its
  executor sees the process end, and the pool closes.  Nothing is rerun in
  the parent.

``InProcess(devices)`` has the same interface and runs every call in the
parent, entry after entry, on ``mesh.replica_on``'s replica for each
device: the path of a mesh of one entry, and the in-turn run a pool's
results are held against.  ``executor`` picks between the two.
"""

from __future__ import annotations

import hashlib
import io
import mmap
import os
import pickle
import time
import traceback
from concurrent.futures import FIRST_EXCEPTION, ProcessPoolExecutor, wait
from concurrent.futures.process import BrokenProcessPool
from contextlib import contextmanager
from multiprocessing.shared_memory import SharedMemory
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

# one call: (mesh entry, fn, args); fn(replica, frames, *args) when the run has an object, else fn(*args)
Call = tuple[int, Callable, tuple]

_SHM_DIR = Path("/dev/shm")  # where POSIX shared memory appears as files on Linux


class WorkerError(RuntimeError):
    """A call raised in a worker process (the message names the worker, its device and the traceback)."""


class WorkerDied(RuntimeError):
    """A worker process ended while it had calls to answer."""


# --------------------------------------------------------------------------
# What crosses the process boundary
# --------------------------------------------------------------------------
def require_picklable(hooks: dict, where: str) -> None:
    """Raise ``ValueError`` naming the first hook of ``hooks`` a worker process cannot receive."""
    for name, fn in hooks.items():
        if fn is None:
            continue
        try:
            pickle.dumps(fn)
        except Exception as exc:
            raise ValueError(
                f"{where}: hook {name!r} ({fn!r}) cannot be pickled for a worker process ({exc}); on a mesh of "
                "more than one entry a hook must be a module-level function or an instance of a module-level "
                "class") from exc


class _HostPickler(pickle.Pickler):
    """Pickles a tensor as the numpy array of its values on the host, rebuilt by ``torch.from_numpy``:
    its bytes are then one buffer that can travel out of band."""

    def reducer_override(self, obj):
        if torch.is_tensor(obj):
            return torch.from_numpy, (obj.detach().cpu().numpy(),)
        return NotImplemented


def _dumps(obj, buffer_callback=None) -> bytes:
    f = io.BytesIO()
    _HostPickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def _pack(values) -> tuple[bytes, str | None, list[int]]:
    """``values`` pickled with every array's bytes in one new block of shared memory → (the pickle, the
    block's name or None, each buffer's size)."""
    buffers: list[pickle.PickleBuffer] = []
    blob = _dumps(values, buffers.append)
    raws = [b.raw() for b in buffers]
    sizes = [r.nbytes for r in raws]
    if not raws:
        return blob, None, []
    shm = SharedMemory(create=True, size=max(1, sum(sizes)))
    off = 0
    for r in raws:
        shm.buf[off:off + r.nbytes] = r
        off += r.nbytes
    shm.close()
    return blob, shm.name, sizes


def _unpack(blob: bytes, name: str | None, sizes: list[int]):
    """``_pack``'s values, the shared block copied out and unlinked."""
    if name is None:
        return pickle.loads(blob)
    shm = SharedMemory(name=name)
    try:
        buffers, off = [], 0
        for n in sizes:
            buffers.append(bytearray(shm.buf[off:off + n]))
            off += n
    finally:
        shm.close()
        shm.unlink()
    return pickle.loads(blob, buffers=buffers)


@contextmanager
def _frames_file(frames):
    """``frames`` as ``(path, dtype, shape, offset)`` of a file a worker maps: a memmap's own file, else
    a copy in POSIX shared memory that lives as long as the block."""
    if frames is None:
        yield None
        return
    if (isinstance(frames, np.memmap) and isinstance(frames.base, mmap.mmap) and frames.flags.c_contiguous
            and frames.filename):
        yield (str(frames.filename), frames.dtype.str, tuple(frames.shape), int(frames.offset))
        return
    arr = frames.detach().cpu().numpy() if torch.is_tensor(frames) else np.asarray(frames)
    shm = SharedMemory(create=True, size=max(arr.nbytes, 1))
    try:
        path = _SHM_DIR / shm.name
        if not path.exists():
            raise RuntimeError(f"POSIX shared memory {shm.name!r} is not at {path}: the worker pool needs Linux")
        view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
        view[...] = arr
        del view
        yield (str(path), arr.dtype.str, tuple(arr.shape), 0)
    finally:
        shm.close()
        shm.unlink()


def _open_frames(desc):
    if desc is None:
        return None
    path, dtype, shape, offset = desc
    return np.memmap(path, dtype=np.dtype(dtype), mode="r", shape=shape, offset=offset)


def _by_entry(calls: Sequence[Call], n: int) -> dict[int, list[int]]:
    """Call indices grouped by mesh entry, entries in order."""
    groups: dict[int, list[int]] = {}
    for i, (entry, _, _) in enumerate(calls):
        if not 0 <= entry < n:
            raise ValueError(f"call {i} names mesh entry {entry} of a mesh of {n}")
        groups.setdefault(entry, []).append(i)
    return dict(sorted(groups.items()))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _name(fn) -> str:
    return f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"


# --------------------------------------------------------------------------
# The worker process
# --------------------------------------------------------------------------
_WORKER: dict = {}  # this worker's device and replicas, set by _start


def _start(index: int, device: str, threads: int) -> dict:
    """A worker's set-up, its first task: its threads and card, then what it reports of itself."""
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context now, not inside the first call
    _WORKER.update(device=dev, replicas={})
    return {"index": index, "pid": os.getpid(), "device": str(dev), "threads": torch.get_num_threads(),
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
            "matmul_precision": torch.get_float32_matmul_precision()}


def _serve(key: str | None, rec: bytes | None, desc, batch: bytes) -> tuple:
    """One entry's calls, in order → ``("ok", pickle, block, sizes, wall, launches, pack seconds)`` or
    ``("error", where, traceback)``."""
    from tpuslam_torch.dist.mesh import from_recipe
    from tpuslam_torch.kernels import launch_counts

    dev, replicas = _WORKER["device"], _WORKER["replicas"]
    what = "building the replica"
    try:
        if key is not None and key not in replicas:
            replicas[key] = from_recipe(pickle.loads(rec), dev)
        frames = _open_frames(desc)
        before = launch_counts()
        t0 = time.monotonic()
        values = []
        for fn, args in pickle.loads(batch):
            what = _name(fn)
            values.append(fn(replicas[key], frames, *args) if key is not None else fn(*args))
        _sync(dev)
        wall = (t0, time.monotonic())
        after = launch_counts()
        del frames
        what = "sending the answer"
        t1 = time.perf_counter()
        blob, name, sizes = _pack(values)
        return "ok", blob, name, sizes, wall, {k: after[k] - before[k] for k in after}, time.perf_counter() - t1
    except Exception:
        return "error", what, traceback.format_exc()


# --------------------------------------------------------------------------
# The parent's side
# --------------------------------------------------------------------------
class WorkerPool:
    """One worker process per entry of ``devices``, alive until ``close()`` (a context manager).

    Each worker runs ``max(1, min(torch.get_num_threads(), cores // len(devices)))`` torch threads: the
    host's cores shared out, and no more than this process uses.  ``info[i]``: worker i's pid, device,
    threads, whether TF32 is on and its float32 matmul precision.
    """

    crosses_processes = True

    def __init__(self, devices: Sequence[torch.device | str]):
        self.devices = [torch.device(d) for d in devices]
        n = len(self.devices)
        if n < 1:
            raise ValueError("a worker pool needs at least one device")
        self.threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // n))
        self.closed = False
        self.last_walls: dict[int, tuple[float, float]] = {}
        self.last_answers: dict[int, dict] = {}
        if any(d.type == "cuda" for d in self.devices):
            from tpuslam_torch.kernels.build import library

            library()
        ctx = torch.multiprocessing.get_context("spawn")
        self._executors = [ProcessPoolExecutor(1, mp_context=ctx) for _ in self.devices]
        self._procs = []
        try:
            starts = {i: ex.submit(_start, i, str(d), self.threads)
                      for i, (ex, d) in enumerate(zip(self._executors, self.devices))}
            # each executor's one process, started by submit: joined or killed by close()
            self._procs = [next(iter(ex._processes.values())) for ex in self._executors]
            replies = self._gather(starts)
            self.info = [replies[i] for i in range(n)]
        except BaseException:
            self.close(timeout=0.0)
            raise

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _gather(self, futures: dict) -> dict:
        """Each entry's answer; ``WorkerDied`` (the pool closed) as soon as one of the workers ends."""
        done, _ = wait(futures.values(), return_when=FIRST_EXCEPTION)
        for i, f in futures.items():
            exc = f.exception() if f in done else None
            if isinstance(exc, BrokenProcessPool):
                proc = self._procs[i]
                proc.join(5.0)
                code = proc.exitcode
                self.close(timeout=0.0)
                how = f"signal {-code}" if code is not None and code < 0 else f"exit code {code}"
                raise WorkerDied(f"worker {i} ({self.devices[i]}, pid {proc.pid}) died ({how}) with calls to "
                                 "answer; the pool is closed") from exc
            if exc is not None:
                raise WorkerError(f"worker {i} ({self.devices[i]}) failed: {exc!r}") from exc
        return {i: f.result() for i, f in futures.items()}

    def run(self, calls: Sequence[Call], obj=None, frames=None) -> list:
        """Every entry's calls in its worker, the entries at the same time; the values in call order."""
        if self.closed:
            raise RuntimeError("the worker pool is closed")
        by_entry = _by_entry(calls, len(self.devices))
        key = rec = None
        if obj is not None:
            from tpuslam_torch.dist.mesh import draw_hooks, recipe

            require_picklable(draw_hooks(obj), type(obj).__name__)
            rec = _dumps(recipe(obj))
            key = hashlib.sha256(rec).hexdigest()
        batches = {}
        for i, idx in by_entry.items():
            try:
                batches[i] = _dumps([(calls[j][1], tuple(calls[j][2])) for j in idx])
            except Exception as exc:
                raise ValueError(f"the calls for worker {i} cannot be pickled: {exc}") from exc
        with _frames_file(frames) as desc:
            replies = self._gather({i: self._executors[i].submit(_serve, key, rec, desc, b)
                                    for i, b in batches.items()})
        from tpuslam_torch.kernels import add_launch_counts

        values: list = [None] * len(calls)
        self.last_walls, self.last_answers = {}, {}
        errors = []
        for i, idx in by_entry.items():
            msg = replies[i]
            if msg[0] != "ok":
                errors.append((i, msg))
                continue
            _, blob, name, sizes, wall, counts, pack_s = msg
            t0 = time.perf_counter()
            vals = _unpack(blob, name, sizes)
            self.last_answers[i] = {"bytes": len(blob) + sum(sizes), "pack_s": pack_s,
                                    "unpack_s": time.perf_counter() - t0}
            add_launch_counts(counts)
            self.last_walls[i] = wall
            for j, v in zip(idx, vals):
                values[j] = v
        if errors:
            i, (_, what, tb) = errors[0]
            raise WorkerError(f"worker {i} ({self.devices[i]}) failed in {what}:\n{tb}")
        return values

    def close(self, timeout: float = 30.0) -> None:
        """Ask every worker to end, wait ``timeout`` seconds in all, then kill what is left."""
        if self.closed:
            return
        self.closed = True
        for ex in self._executors:
            ex.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + timeout
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join()


class InProcess:
    """``WorkerPool``'s interface in this process: each entry's calls in turn, on ``mesh.replica_on``'s
    replica for its device."""

    crosses_processes = False

    def __init__(self, devices: Sequence[torch.device | str]):
        self.devices = [torch.device(d) for d in devices]
        self.last_walls: dict[int, tuple[float, float]] = {}

    def __enter__(self) -> "InProcess":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def run(self, calls: Sequence[Call], obj=None, frames=None) -> list:
        from tpuslam_torch.dist.mesh import _Replicas

        replicas = None if obj is None else _Replicas(obj, self.devices)
        values: list = [None] * len(calls)
        self.last_walls = {}
        for i, idx in _by_entry(calls, len(self.devices)).items():
            t0 = time.monotonic()
            for j in idx:
                _, fn, args = calls[j]
                values[j] = fn(*args) if replicas is None else fn(replicas(i), frames, *args)
            _sync(replicas(i).device if replicas is not None else self.devices[i])
            self.last_walls[i] = (t0, time.monotonic())
        return values


def crosses_processes(devices: Sequence[torch.device | str], pool=None) -> bool:
    """Whether ``executor(devices, pool)`` runs the calls in other processes."""
    return pool.crosses_processes if pool is not None else len(devices) > 1


@contextmanager
def executor(devices: Sequence[torch.device | str], pool=None):
    """``pool`` (a ``WorkerPool`` or ``InProcess`` over ``devices``) if given; else ``InProcess`` for a
    mesh of one entry, and for more a ``WorkerPool`` started for the block and closed after it."""
    from tpuslam_torch.dist.mesh import _canonical

    if pool is not None:
        if [_canonical(d) for d in pool.devices] != [_canonical(d) for d in devices]:
            raise ValueError(f"the pool runs on {[str(d) for d in pool.devices]}, not on "
                             f"{[str(d) for d in devices]}")
        yield pool
    elif len(devices) == 1:
        yield InProcess(devices)
    else:
        with WorkerPool(devices) as p:
            yield p
