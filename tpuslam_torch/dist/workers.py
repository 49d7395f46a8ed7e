"""One worker process per mesh entry: the dist layer's programs on distinct devices at once.

The reference runs one program per device at the same time (``shard_map``
over ``make_device_mesh(n)``, ``tpuslam/dist/mesh.py``).  The port's host
code is eager Python that keeps a card 10-17% busy, so devices driven from
one interpreter would share its lock over exactly that work.  As PyTorch
drives several cards (torchrun, DDP), ``WorkerPool(devices)`` gives each
entry of the mesh a process of its own: a ``ProcessPoolExecutor`` of one
worker; two entries that name one device give two processes, two replicas
and two generators on that card.

- Processes start with ``spawn``: ``fork`` is unsafe once the parent has
  initialised CUDA.  Before it starts them, the parent builds the kernel
  library when the mesh names a card, so that the workers load it instead
  of each compiling its own.
- Each worker sets its card (``torch.cuda.set_device``) and takes
  ``max(1, min(the parent's torch threads, cores // n))`` torch threads.
  It imports ``tpuslam_torch``, so TF32 is off there as well
  (``info[i]["tf32"]``).  A worker opens no frame loader: frames reach it
  as a file it maps, or on its card (below).
- A worker builds each replica it needs once, from ``mesh.recipe(obj)``
  (``mesh.from_recipe``, as ``mesh.replica_on`` builds one), and keeps it under the
  recipe's hash; never from the parent's tensors.  A draw hook that cannot
  be pickled raises ``ValueError`` naming it.
- ``run(calls, obj, frames, entry_frames)`` sends every entry its calls at
  once; each worker runs its own in order, ``fn(replica, frames, *args)``,
  and answers with the values, its wall interval (``last_walls``:
  ``time.monotonic``, one clock for every process of a host) and its kernel
  launches, which ``kernels.launch_counts()`` adds.  Tensors cross either
  way as numpy arrays on the host.  An answer's arrays travel out of band:
  the worker copies their bytes into one block of POSIX shared memory and
  the parent copies them out and unlinks it, so the pipe carries only the
  pickle's skeleton (``last_answers``: the bytes, and the seconds each side
  spent).
- Values stay resident in a worker between calls: an argument ``HELD``
  reaches ``fn`` as the worker's own dict, which outlives the call (the
  per-chunk step, ``mesh.ShardedStep``, keeps each sequence's state there
  and hands the parent a handle).
- Frames reach a worker in one of three ways.  ``frames`` (every entry
  reads the rows it runs): an ``np.memmap`` by its own path and offset,
  anything else copied once into POSIX shared memory for the call.
  ``entry_frames[i]`` (entry i's own rows, each call, the per-chunk step)
  go through a block of entry i's own, made at its first call and reused
  by every later one (grown when a call needs more), which the worker opens
  once and keeps: a CUDA tensor on the worker's card is copied into a
  buffer on that card, shared through CUDA IPC; anything else into a
  block of POSIX shared memory (``last_answers``: ``send_s``, the parent's
  staging, and ``open_s``, the worker's).  A fresh IPC handle a call costs
  the worker an open each time, and a fresh block of shared memory a
  first touch of every page (``PERF.md`` §6 has the times on the card).
- No silent fallback.  A call that raises in a worker raises
  ``WorkerError`` in the parent with the worker's index, device and
  traceback, once the other workers have answered; a worker that dies
  (killed, out of memory, a fault) raises ``WorkerDied`` as soon as its
  executor sees the process end, and the pool closes.  Nothing is rerun in
  the parent.

``InProcess(devices)`` has the same interface and runs every call in the
parent, entry after entry, on ``mesh.replica_on``'s replica for each
device, with a dict of its own for ``HELD``: the path of a mesh of one
entry, and the in-turn run a pool's results are held against.
``executor`` picks between the two.
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
from contextlib import contextmanager, suppress
from multiprocessing.shared_memory import SharedMemory
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

# one call: (mesh entry, fn, args); fn(replica, frames, *args) when the run has an object, else fn(*args)
Call = tuple[int, Callable, tuple]

_SHM_DIR = Path("/dev/shm")  # where POSIX shared memory appears as files on Linux


class _Held:
    """The type of ``HELD``: pickled by name, so a worker unpickles the same object."""

    def __reduce__(self):
        return "HELD"

    def __repr__(self) -> str:
        return "HELD"


HELD = _Held()  # in a call's arguments: the executor's dict of values that outlive the call


def _with_held(args: tuple, held: dict) -> tuple:
    return tuple(held if a is HELD else a for a in args)


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


class _Block:
    """A block of POSIX shared memory that one entry's frames go through on every call."""

    def __init__(self, nbytes: int):
        self.shm = SharedMemory(create=True, size=max(nbytes, 1))
        self.size = self.shm.size
        self.path = _SHM_DIR / self.shm.name
        if not self.path.exists():
            self.close()
            raise RuntimeError(f"POSIX shared memory {self.shm.name!r} is not at {self.path}: the worker pool "
                               "needs Linux")

    def put(self, x) -> tuple:
        """``x`` (an array or a CPU tensor) copied into the block → the worker's description of it."""
        arr = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        view = np.ndarray(arr.shape, arr.dtype, buffer=self.shm.buf)
        view[...] = arr
        del view
        return ("block", str(self.path), arr.dtype.str, tuple(arr.shape))

    def close(self) -> None:
        self.shm.close()
        self.shm.unlink()


class _CardBlock:
    """A buffer on an entry's card that its frames go through on every call: shared once as a CUDA IPC
    handle, which the worker opens once and keeps (``token`` names it)."""

    def __init__(self, nbytes: int, device: torch.device):
        from torch.multiprocessing.reductions import reduce_tensor

        self.buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)
        self.size = self.buf.numel()
        self.ipc = reduce_tensor(self.buf)[1]
        self.token = os.urandom(8).hex()

    def put(self, x: torch.Tensor) -> tuple:
        """``x`` (on the buffer's card) copied into the buffer, the copy finished → the worker's description."""
        n = x.numel() * x.element_size()
        self.buf[:n].view(x.dtype).view(x.shape).copy_(x)
        torch.cuda.current_stream(self.buf.device).synchronize()  # the worker reads it from another process
        return ("cuda", self.token, self.ipc, str(x.dtype).removeprefix("torch."), tuple(x.shape))

    def close(self) -> None:
        del self.buf


def _entry_frames_desc(x, device: torch.device, blocks: dict, i: int):
    """How entry ``i`` (on ``device``) receives its own rows ``x``: a CUDA tensor on its card through the
    entry's buffer there (CUDA IPC), anything else through the entry's block of shared memory; either made,
    or grown, here."""
    from tpuslam_torch.dist.mesh import _canonical

    on_card = torch.is_tensor(x) and x.is_cuda and _canonical(x.device) == _canonical(device)
    if not on_card:
        x = x.detach().cpu() if torch.is_tensor(x) else np.asarray(x)
    nbytes = x.element_size() * x.numel() if torch.is_tensor(x) else x.nbytes
    kind = _CardBlock if on_card else _Block
    block = blocks.get(i)
    if not isinstance(block, kind) or block.size < nbytes:
        if block is not None:
            blocks.pop(i).close()
        blocks[i] = _CardBlock(nbytes, x.device) if on_card else _Block(nbytes)
    return blocks[i].put(x)


def _open_frames(desc):
    if desc is None:
        return None
    if desc[0] == "cuda":  # the entry's buffer on its card, opened at its first call and kept
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        _, token, ipc, dtype, shape = desc
        if _WORKER.get("card", (None,))[0] != token:
            _WORKER["card"] = (token, rebuild_cuda_tensor(*ipc))
        dtype = getattr(torch, dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        return _WORKER["card"][1][:n].view(dtype).view(shape)
    if desc[0] == "block":  # mapped once, writable so that torch.from_numpy takes it without a copy
        _, path, dtype, shape = desc
        if _WORKER.get("block", (None,))[0] != path:
            _WORKER["block"] = (path, np.memmap(path, dtype=np.uint8, mode="r+"))
        mm = _WORKER["block"][1]
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return mm[:n].view(np.dtype(dtype)).reshape(shape)
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
    _WORKER.update(device=dev, replicas={}, held={})
    return {"index": index, "pid": os.getpid(), "device": str(dev), "threads": torch.get_num_threads(),
            "tf32": bool(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
            "matmul_precision": torch.get_float32_matmul_precision()}


def _drop_card() -> None:
    """Let go of the entry's frame buffer on the card, so that the parent may free it."""
    _WORKER.pop("card", None)


def _serve(key: str | None, rec: bytes | None, desc, batch: bytes) -> tuple:
    """One entry's calls, in order → ``("ok", pickle, block, sizes, wall, launches, pack seconds, frames' open
    seconds)`` or ``("error", where, traceback)``."""
    from tpuslam_torch.dist.mesh import from_recipe
    from tpuslam_torch.kernels import launch_counts

    dev, replicas, held = _WORKER["device"], _WORKER["replicas"], _WORKER["held"]
    what = "building the replica"
    try:
        if key is not None and key not in replicas:
            replicas[key] = from_recipe(pickle.loads(rec), dev)
        what = "opening the frames"
        t0 = time.perf_counter()
        frames = _open_frames(desc)
        open_s = time.perf_counter() - t0
        before = launch_counts()
        t0 = time.monotonic()
        values = []
        for fn, args in pickle.loads(batch):
            what = _name(fn)
            args = _with_held(args, held)
            values.append(fn(replicas[key], frames, *args) if key is not None else fn(*args))
        _sync(dev)
        wall = (t0, time.monotonic())
        after = launch_counts()
        del frames
        what = "sending the answer"
        t1 = time.perf_counter()
        blob, name, sizes = _pack(values)
        return ("ok", blob, name, sizes, wall, {k: after[k] - before[k] for k in after}, time.perf_counter() - t1,
                open_s)
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
        self._blocks: dict[int, _Block | _CardBlock] = {}  # entry → its block for entry_frames, kept across calls
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

    def run(self, calls: Sequence[Call], obj=None, frames=None, entry_frames: dict | None = None) -> list:
        """Every entry's calls in its worker, the entries at the same time; the values in call order.

        ``frames`` reach every entry; ``entry_frames[i]``, where given, reaches entry i in their place."""
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
        descs, send_s = {}, {}
        for i in by_entry:
            if entry_frames is not None and i in entry_frames:
                t0 = time.perf_counter()
                descs[i] = _entry_frames_desc(entry_frames[i], self.devices[i], self._blocks, i)
                send_s[i] = time.perf_counter() - t0
        with _frames_file(frames) as desc:
            replies = self._gather({i: self._executors[i].submit(_serve, key, rec, descs.get(i, desc), b)
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
            _, blob, name, sizes, wall, counts, pack_s, open_s = msg
            t0 = time.perf_counter()
            vals = _unpack(blob, name, sizes)
            self.last_answers[i] = {"bytes": len(blob) + sum(sizes), "pack_s": pack_s,
                                    "unpack_s": time.perf_counter() - t0, "send_s": send_s.get(i, 0.0),
                                    "open_s": open_s}
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
        # each executor's manager thread reaps its process: wait for it first, since a second waitpid on the
        # same child from here could lose the race and leave the process object believing it still runs
        managers = [getattr(ex, "_executor_manager_thread", None) for ex in self._executors]
        deadline = time.monotonic() + timeout
        cards = []
        for i, b in self._blocks.items():
            if isinstance(b, _CardBlock) and timeout > 0:
                with suppress(RuntimeError):  # a broken executor: its worker is gone already
                    cards.append(self._executors[i].submit(_drop_card))
        if cards:
            wait(cards, timeout=min(5.0, timeout))
        for ex in self._executors:
            ex.shutdown(wait=False, cancel_futures=True)
        for thread in managers:
            if thread is not None:
                thread.join(max(0.0, deadline - time.monotonic()))
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.monotonic()))
            if proc.is_alive():
                proc.kill()
                proc.join()
        for block in self._blocks.values():
            block.close()
        self._blocks.clear()


class InProcess:
    """``WorkerPool``'s interface in this process: each entry's calls in turn, on ``mesh.replica_on``'s
    replica for its device (one per recipe and device, kept across calls), ``HELD`` its own dict."""

    crosses_processes = False

    def __init__(self, devices: Sequence[torch.device | str]):
        self.devices = [torch.device(d) for d in devices]
        self.last_walls: dict[int, tuple[float, float]] = {}
        self.held: dict = {}
        self._replicas: dict[tuple[str, torch.device], object] = {}

    def __enter__(self) -> "InProcess":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def _replica(self, obj, i: int):
        from tpuslam_torch.dist.mesh import _canonical, recipe, replica_on

        dev = _canonical(self.devices[i])
        if _canonical(obj.device) == dev:
            return obj
        key = (hashlib.sha256(_dumps(recipe(obj))).hexdigest(), dev)
        if key not in self._replicas:
            self._replicas[key] = replica_on(obj, dev)
        return self._replicas[key]

    def run(self, calls: Sequence[Call], obj=None, frames=None, entry_frames: dict | None = None) -> list:
        values: list = [None] * len(calls)
        self.last_walls = {}
        for i, idx in _by_entry(calls, len(self.devices)).items():
            replica = None if obj is None else self._replica(obj, i)
            x = entry_frames[i] if entry_frames is not None and i in entry_frames else frames
            t0 = time.monotonic()
            for j in idx:
                _, fn, args = calls[j]
                args = _with_held(tuple(args), self.held)
                values[j] = fn(*args) if replica is None else fn(replica, x, *args)
            _sync(replica.device if replica is not None else self.devices[i])
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
