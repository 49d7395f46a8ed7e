"""A mesh that spans a process group: the exchange between ranks.

The reference's ``initialize_multihost`` calls ``jax.distributed.initialize``;
after it ``jax.devices()`` lists every device of every process, ordered by
process, and every program on a mesh spans the cluster.  Here
``mesh.initialize_multihost`` joins a ``torch.distributed`` process group,
and ``mesh.make_device_mesh()`` then returns the global mesh: each rank's
cards in rank order, each entry a ``RankDevice`` that names the rank owning
it.  In a single process nothing here is used and a mesh stays a list of
``torch.device``\\ s.

Programs on a global mesh are SPMD: every rank calls them with the same
arguments, runs only the mesh entries it owns (its own ``WorkerPool``
where it owns more than one) and reads only their rows, and the ranks then
exchange what they ran, so that every rank returns the same values.

- Every exchange is host bytes over gloo: a value is pickled with each
  array's bytes out of band (as a worker's answer is) into one uint8
  tensor, and each rank's tensor is broadcast to the others.  Where a card
  is visible the group's backend is ``"cpu:gloo,cuda:nccl"``: NCCL would
  refuse two ranks on one card as soon as it formed a communicator, and no
  exchange here touches a CUDA tensor, so none forms.
- No rank raises alone.  Each rank's part runs under ``exchange``: it sends
  its value or its error, and when any rank failed, every rank raises
  ``RankError`` naming the first rank that failed, with its traceback, as
  soon as the exchange completes; a rank that dies or hangs makes the
  others' collectives fail within the group's timeout.
- The ranks check that they agree before a program runs: every rank's hash
  of ``mesh.recipe(obj)`` and its mesh against rank 0's; a difference
  raises on every rank, naming the ranks that differ.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import pickle
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch


# the latest exchanges of this process, newest last: {"bytes": sent and received, "seconds": wall}
EXCHANGES: collections.deque = collections.deque(maxlen=64)


class RankError(RuntimeError):
    """A rank of the process group failed (the message names the rank and carries its traceback)."""


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """An entry of a global mesh: ``device`` as rank ``rank`` names it."""

    rank: int
    device: torch.device

    def __str__(self) -> str:
        return f"rank {self.rank} {self.device}"


def group_active() -> bool:
    """Whether this process is a rank of a process group of more than one process."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_global(devices: Sequence) -> bool:
    return any(isinstance(d, RankDevice) for d in devices)


def owned(devices: Sequence[RankDevice]) -> list[int]:
    """The entries of a global mesh that this rank owns, in mesh order."""
    import torch.distributed as dist

    rank = dist.get_rank()
    return [e for e, d in enumerate(devices) if d.rank == rank]


def owner(devices: Sequence, e: int) -> int | None:
    """The rank that owns entry ``e`` of a global mesh; None on a mesh of this process."""
    return devices[e].rank if isinstance(devices[e], RankDevice) else None


# --------------------------------------------------------------------------
# Host bytes between ranks
# --------------------------------------------------------------------------
def _to_bytes(tree) -> torch.Tensor:
    """``tree`` as one uint8 tensor: a header of sizes, the pickle's skeleton, then each array's bytes."""
    from tpuslam_torch.dist.workers import _dumps

    buffers: list[pickle.PickleBuffer] = []
    skeleton = _dumps(tree, buffers.append)
    raws = [b.raw() for b in buffers]
    sizes = np.array([len(skeleton)] + [r.nbytes for r in raws], np.int64)
    head = np.concatenate([np.array([len(sizes)], np.int64), sizes])
    out = np.empty(head.nbytes + int(sizes.sum()), np.uint8)
    out[:head.nbytes] = head.view(np.uint8)
    off = head.nbytes
    for part in [np.frombuffer(skeleton, np.uint8)] + [np.frombuffer(r, np.uint8) for r in raws]:
        out[off:off + part.nbytes] = part
        off += part.nbytes
    return torch.from_numpy(out)


def _from_bytes(t: torch.Tensor):
    arr = t.numpy()
    n = int(arr[:8].view(np.int64)[0])
    sizes = arr[8:8 * (n + 1)].view(np.int64)
    off = 8 * (n + 1)
    parts = []
    for size in sizes:
        parts.append(arr[off:off + size])
        off += int(size)
    return pickle.loads(parts[0].tobytes(), buffers=[bytearray(p) for p in parts[1:]])


def _allgather_bytes(payload: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's byte tensor, on every rank: the sizes, then each rank's bytes broadcast from it."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([payload.numel()], dtype=torch.int64))
    out = []
    for r in range(world):
        buf = payload if r == rank else torch.empty(int(sizes[r]), dtype=torch.uint8)
        dist.broadcast(buf, src=r)
        out.append(buf)
    EXCHANGES.append({"bytes": sum(b.numel() for b in out), "seconds": time.perf_counter() - t0})
    return out


def process_allgather(tree) -> list:
    """Every rank's ``tree`` (tensors, arrays, and the dicts, lists, tuples and scalars holding them), on
    every rank, in rank order; tensors arrive on the host.  The port's
    ``jax.experimental.multihost_utils.process_allgather`` (a list by rank where that stacks a leading
    axis).  A collective: every rank calls it."""
    return [_from_bytes(b) for b in _allgather_bytes(_to_bytes(tree))]


def fill_sequences(values: list) -> list:
    """Lists by sequence in which each rank holds only the sequences it ran (``None`` elsewhere), as the
    per-chunk step returns them on a global mesh: every rank's filled in, on every rank (a collective)."""
    ranks = process_allgather(values)
    return [next((r[s] for r in ranks if r[s] is not None), None) for s in range(len(values))]


def exchange(fn: Callable[[], Any], root: int | None = None) -> list:
    """``fn()`` on this rank, then every rank's value on every rank, in rank order (with ``root``: ``fn``
    runs on that rank alone and its value is every rank's, a list of one).  When ``fn`` raised on any rank,
    every rank raises ``RankError`` naming the first, with its traceback.  A collective: every rank calls
    it."""
    import torch.distributed as dist

    rank = dist.get_rank()
    err = None
    if root is None or rank == root:
        try:
            mine = ("ok", fn())
        except Exception as exc:
            err = exc
            mine = ("error", traceback.format_exc())
    else:
        mine = ("ok", None)
    if root is None:
        got = process_allgather(mine)
    else:
        payload = _to_bytes(mine) if rank == root else None
        t0 = time.perf_counter()
        size = torch.tensor([0 if payload is None else payload.numel()], dtype=torch.int64)
        dist.broadcast(size, src=root)
        buf = payload if rank == root else torch.empty(int(size), dtype=torch.uint8)
        dist.broadcast(buf, src=root)
        EXCHANGES.append({"bytes": buf.numel(), "seconds": time.perf_counter() - t0})
        got = [_from_bytes(buf)]
    for r, (status, value) in enumerate(got):
        if status != "ok":
            who = r if root is None else root
            raise RankError(f"rank {who} failed (seen on rank {rank}):\n{value}") from err
    return [value for _, value in got]


def check_agreement(obj, devices: Sequence[RankDevice]) -> None:
    """Every rank's hash of ``recipe(obj)`` (when ``obj`` is given) and its mesh against rank 0's: a
    difference raises ``RankError`` on every rank, naming the ranks that differ."""
    from tpuslam_torch.dist.mesh import recipe
    from tpuslam_torch.dist.workers import _dumps

    mine = {"mesh": [str(d) for d in devices],
            "recipe": None if obj is None else hashlib.sha256(_dumps(recipe(obj))).hexdigest()}
    every = exchange(lambda: mine)
    for what in ("mesh", "recipe"):
        differ = [r for r, v in enumerate(every) if v[what] != every[0][what]]
        if differ:
            raise RankError(f"rank(s) {differ} disagree with rank 0 on the {what}: "
                            f"{[every[r][what] for r in differ]} against {every[0][what]}")
