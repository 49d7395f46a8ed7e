"""Device meshes and multi-sequence SLAM: one sequence per device, each with its own state.

Port of ``tpuslam/dist/mesh.py``.  The reference shards a stacked sequence
axis over a ``jax.sharding.Mesh`` and runs one program per device at once;
in PyTorch's idiom a mesh is an explicit list of ``torch.device``s and the
placement rule replaces ``sequence_sharding``: sequence (or time shard)
``d`` runs on entry ``d % len(devices)``.  On a mesh of more than one entry
the entries run at the same time, one worker process each
(``dist/workers.py``), and a mesh of one entry runs in this process; each
entry runs its own sequences in order.  That holds for the whole-run
programs (``shard_sequence_program`` here, ``run_timesharded`` and
``run_timesharded_system`` in ``timeshard.py``) and for the per-chunk step
(``shard_vmapped_step``, ``shard_batched_pipeline``), whose loop belongs to
the caller: its ``ShardedStep`` keeps each sequence's state resident in the
worker that runs it between calls and hands the caller a handle.  VO
sequences that share a mesh entry run as one batched chunk step
(``SlamPipeline.process_chunks``, the reference's ``jax.vmap``).
Per-sequence state never leaves its device during a run, so no collective
is needed on the hot path.  Each device gets its own replica of the
pipeline or system (``replica_on``: built from ``recipe(obj)``, as a
worker process builds it); the results do not depend on the placement.

After ``initialize_multihost`` a mesh spans the process group:
``make_device_mesh()`` lists every rank's cards in rank order
(``hosts.RankDevice``), and each program runs the entries this rank owns and
exchanges the rest with the other ranks (``dist/hosts.py``).

The reference runs the unbatched sequence program per device under
``shard_map`` so that its ``lax.cond``s stay real branches; here every
branch is a host read already, so ``shard_sequence_program`` is the plain
``SlamSystem._sequence_raw`` loop of each sequence.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from datetime import timedelta
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from tpuslam_torch.dist import hosts
from tpuslam_torch.dist.hosts import RankDevice
from tpuslam_torch.dist.workers import HELD, InProcess, WorkerPool, crosses_processes, executor


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: float = 1800.0,
) -> bool:
    """Join a multi-process group when the caller or the environment names a world larger than 1.

    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``; ``coordinator_address`` (``host:port``) to ``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``.  The backend is ``"cpu:gloo,cuda:nccl"``
    where a card is visible (every exchange of the dist layer is host bytes
    over gloo, ``dist/hosts.py``), gloo otherwise; a collective, and joining,
    wait at most ``timeout`` seconds.  A process that cannot join raises.
    Returns True when a group of more than one process is active, False in a
    single process (nothing is initialised then).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return dist.get_world_size() > 1


def _local_devices(device_type: str) -> list[torch.device]:
    """This process's devices of ``device_type``: in a group, the card ``LOCAL_RANK`` names where it is
    set, else every visible card; one CPU device."""
    if device_type != "cuda":
        return [torch.device(device_type)]
    if hosts.group_active() and "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_device_mesh(n_devices: int | None = None, device_type: str = "cuda") -> list:
    """The first ``n_devices`` devices of ``device_type`` (default: every visible CUDA card).

    There is one CPU device.  After ``initialize_multihost``, the global
    mesh: every rank's devices in rank order, each a ``hosts.RankDevice``
    (a collective then: every rank calls it).  Raises ``ValueError`` when
    more devices are asked for than exist, or when there is none.
    """
    devices: list = _local_devices(device_type)
    if hosts.group_active():
        every = hosts.process_allgather([str(d) for d in devices])
        devices = [RankDevice(r, torch.device(d)) for r, ds in enumerate(every) for d in ds]
    want = len(devices) if n_devices is None else n_devices
    if want < 1 or len(devices) < want:
        raise ValueError(f"Requested {want} devices but only {len(devices)} available.")
    return devices[:want]


def _device(entry) -> torch.device:
    return entry.device if isinstance(entry, RankDevice) else torch.device(entry)


def device_for(devices: Sequence, d: int) -> torch.device:
    """The placement rule: sequence or shard ``d`` runs on ``devices[d % len(devices)]``."""
    return _device(devices[d % len(devices)])


def _canonical(device: torch.device | str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_PIPELINE_OPTIONS = ("tracking", "with_features", "map_window", "max_map_points", "pnp_gn_iters", "freeze_map")
_PIPELINE_HOOKS = ("draw_fn", "pnp_draw_fn")
_SYSTEM_HOOKS = ("draw_fn", "pnp_draw_fn", "lc_draw_fn", "reloc_draw_fn", "cross_draw_fn")


def draw_hooks(obj) -> dict:
    """The draw hooks of ``obj`` (a ``SlamPipeline`` or ``SlamSystem``) by name."""
    from tpuslam_torch.model.slam import SlamPipeline

    return {k: getattr(obj, k) for k in (_PIPELINE_HOOKS if isinstance(obj, SlamPipeline) else _SYSTEM_HOOKS)}


def recipe(obj) -> tuple:
    """What a replica of ``obj`` (a ``SlamPipeline`` or ``SlamSystem``) is built from on another device:
    the camera, the configuration and options, the draw hooks, and the vocabulary's arrays on the host."""
    from tpuslam_torch.model.slam import SlamPipeline

    if isinstance(obj, SlamPipeline):
        options = {k: getattr(obj, k) for k in _PIPELINE_OPTIONS + _PIPELINE_HOOKS}
        return ("pipeline", obj.camera, obj.config, {**options, "nms_fused": obj.detector.nms_fused})
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj) if f.name not in ("device", "vocabulary")}
    vocab = None
    if obj.loop_closure is not None:
        v = obj.loop_closure.vocabulary
        vocab = (v.centroids.cpu(), v.idf.cpu(), None if v.coarse is None else v.coarse.cpu())
    return ("system", fields, vocab)


def from_recipe(rec: tuple, device: torch.device | str):
    """The replica ``recipe(obj)`` describes, built on ``device``."""
    if rec[0] == "pipeline":
        from tpuslam_torch.model.slam import SlamPipeline

        _, camera, config, options = rec
        return SlamPipeline(camera, config, device=device, **options)
    from tpuslam_torch.backend.vocabulary import Vocabulary
    from tpuslam_torch.model.system import SlamSystem

    _, fields, vocab = rec
    return SlamSystem(**fields, vocabulary=None if vocab is None else Vocabulary(*vocab, device=device),
                      device=device)


def replica_on(obj, device: torch.device | str):
    """``obj`` (a ``SlamPipeline`` or ``SlamSystem``) itself if it lives on ``device``, else a copy
    built there with the same configuration, vocabulary and draw hooks (``from_recipe(recipe(obj))``, as
    a worker process builds it)."""
    if _canonical(obj.device) == _canonical(device):
        return obj
    return from_recipe(recipe(obj), device)


def _entries(n: int, n_entries: int) -> dict[int, list[int]]:
    """Sequences ``0..n-1`` grouped by the mesh entry the placement rule gives them, in order."""
    groups: dict[int, list[int]] = {}
    for s in range(n):
        groups.setdefault(s % n_entries, []).append(s)
    return groups


def run_groups(devices: Sequence, pool, groups: dict[int, list], make_call: Callable, obj=None,
               frames=None) -> tuple[dict, dict]:
    """Each mesh entry's call over ``groups`` (entry → its sequences or shards): ``make_call(items,
    crosses) → (fn, args)``, run as ``fn(replica, frames, *args)``, ``crosses`` telling whether it runs in
    another process.  The entries of a mesh of more than one run at the same time in ``pool`` (a
    ``WorkerPool`` or ``InProcess`` over the mesh, over this rank's entries on a global mesh; default: a
    ``WorkerPool`` for the call), a mesh of one entry in this process.  On a global mesh each rank runs
    the entries it owns and every rank returns every entry's value (``dist/hosts.py``).  Returns (value
    by entry, wall interval by entry)."""

    def run_local(local_devices: list, mine: dict[int, tuple[int, list]]) -> tuple[dict, dict]:
        crosses = crosses_processes(local_devices, pool)
        calls = [(i, *make_call(items, crosses)) for i, (_, items) in mine.items()]
        with executor(local_devices, pool) as ex:
            values = ex.run(calls, obj=obj, frames=frames)
            walls = dict(ex.last_walls)
        return ({e: v for (e, _), v in zip(mine.values(), values)}, {mine[i][0]: w for i, w in walls.items()})

    if not hosts.is_global(devices):
        return run_local(list(devices), {e: (e, items) for e, items in groups.items()})
    hosts.check_agreement(obj, devices)
    here = hosts.owned(devices)
    mine = {i: (e, groups[e]) for i, e in enumerate(here) if e in groups}
    local_devices = [devices[e].device for e in here]
    values, walls = {}, {}
    for v, w in hosts.exchange(lambda: run_local(local_devices, mine) if mine else ({}, {})):
        values.update(v)
        walls.update(w)
    return values, dict(sorted(walls.items()))


# --------------------------------------------------------------------------
# The per-chunk step
# --------------------------------------------------------------------------
class StateHandle(NamedTuple):
    """Sequence ``seq``'s state after call ``version`` of step ``step``, resident where that step runs it
    (``ShardedStep.fetch`` brings it back)."""

    step: str
    seq: int
    version: int


_STEP_IDS = itertools.count()


def _held_state(held: dict, step: str, seq: int, version: int):
    have = held.get((step, seq))
    if have is None or have[0] != version:
        now = "nothing" if have is None else f"call {have[0]}'s"
        raise ValueError(f"step {step}: sequence {seq}'s handle is call {version}'s state, and {now} is held")
    return have[1]


def _drop_held(held: dict, step: str) -> None:
    for key in [k for k in held if k[0] == step]:
        del held[key]


def _step_entry(replica, frames, fn: Callable, held: dict, step: str, seqs: list[int], version: int, valid,
                states: list, seeds: list[int]) -> list:
    """One mesh entry's sequences of a step call: each state from ``held`` (a handle) or as given (put on
    the replica's device), ``fn(replica, frames, valid, states, seeds)``, the new states kept in ``held``
    → the results."""
    given = [_held_state(held, step, s, st.version) if isinstance(st, StateHandle) else to_device(st, replica.device)
             for s, st in zip(seqs, states)]
    x = frames if torch.is_tensor(frames) else torch.from_numpy(frames)
    results, new = fn(replica, x, valid, given, seeds)
    for s, st in zip(seqs, new):
        held[(step, s)] = (version, st)
    return results


def _rows(frames, seqs: list[int]):
    if torch.is_tensor(frames):
        return frames.index_select(0, torch.tensor(seqs, device=frames.device))
    return np.asarray(frames[seqs])


class ShardedStep:
    """A batched chunk function over a mesh, its states resident where they run (``shard_vmapped_step``).

    ``step(frames (S, B, H, W), valid (S, B), states, seeds) → (results,
    states)``, lists by sequence.  Sequence s runs on entry ``s % len(devices)``;
    the sequences of an entry run as one ``fn(replica, frames (n, B, H, W),
    valid (n, B), states, seeds)`` call, as the reference vmaps them, and the
    entries of a mesh of more than one run at the same time, one worker
    process each (``pool``: a ``workers.WorkerPool`` or ``InProcess`` over
    the mesh; default: a ``WorkerPool`` started at the first call and closed
    by ``close()``); a mesh of one entry runs in this process.  ``fn`` must
    be a module-level function and ``obj``'s draw hooks must pickle.

    The results come back on each sequence's device.  The states stay where
    they ran: the step returns a ``StateHandle`` for each, which the next
    call takes back; ``fetch(handle)`` brings one to the sequence's device.
    A state given where a handle is expected (the first call's
    ``initial_state()``) seeds its sequence.  An entry's frames go to its
    worker through one buffer reused every call: on the worker's card
    (CUDA IPC) where the frames are there, else in shared memory; the mask
    is read on the host.

    On a global mesh every rank makes the same calls; each runs the
    sequences of the entries it owns, and the results and states of the
    others are None in its lists (``hosts.fill_sequences(results)`` gathers
    them).  A failure on any rank raises ``hosts.RankError`` on every rank.
    """

    def __init__(self, fn: Callable, obj, devices: Sequence, pool=None):
        self.fn, self.obj, self.devices = fn, obj, list(devices)
        self.name = f"{getattr(fn, '__name__', 'step')}#{os.getpid()}.{next(_STEP_IDS)}"
        self.is_global = hosts.is_global(self.devices)
        self._here = hosts.owned(self.devices) if self.is_global else list(range(len(self.devices)))
        self._local = [_device(self.devices[e]) for e in self._here]
        if pool is not None and [_canonical(d) for d in pool.devices] != [_canonical(d) for d in self._local]:
            raise ValueError(f"the pool runs on {[str(d) for d in pool.devices]}, not on "
                             f"{[str(d) for d in self._local]}")
        self._pool, self._owns_pool = pool, pool is None
        self._version = 0
        self._agreed = not self.is_global
        self.closed = False

    @property
    def pool(self):
        """The executor this rank's entries run in (None before the first call of a step that starts its own)."""
        return self._pool

    def __enter__(self) -> "ShardedStep":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _executor(self):
        if self.closed:
            raise RuntimeError(f"step {self.name} is closed")
        if self._pool is None:
            self._pool = InProcess(self._local) if len(self._local) <= 1 else WorkerPool(self._local)
        return self._pool

    def _check(self, s: int, st) -> None:
        if isinstance(st, StateHandle) and st.step != self.name:
            raise ValueError(f"state {s} is a handle of step {st.step}, not of step {self.name}")
        if isinstance(st, StateHandle) and st.seq != s:
            raise ValueError(f"step {self.name}: state {s} is the handle of sequence {st.seq}")

    def __call__(self, frames, valid, states, seeds):
        ex = self._executor()
        n = len(frames)
        if not len(valid) == len(states) == len(seeds) == n:
            raise ValueError(f"step {self.name}: {n} sequences of frames, {len(valid)} masks, {len(states)} "
                             f"states, {len(seeds)} seeds")
        for s, st in enumerate(states):
            self._check(s, st)
        valid = torch.as_tensor(valid, dtype=torch.bool).cpu()  # a host mask: process_chunks reads its sum
        groups = _entries(n, len(self.devices))
        local = {e: i for i, e in enumerate(self._here)}
        mine = {e: seqs for e, seqs in groups.items() if e in local}
        self._version += 1
        version = self._version
        calls = [(local[e], _step_entry, (self.fn, HELD, self.name, seqs, version, valid[seqs],
                                          [states[s] for s in seqs], [int(seeds[s]) for s in seqs]))
                 for e, seqs in mine.items()]
        out: list = []

        def run() -> None:
            entry_frames = {local[e]: _rows(frames, seqs) for e, seqs in mine.items()}
            out.extend(ex.run(calls, obj=self.obj, entry_frames=entry_frames) if calls else [])

        if self.is_global:
            if not self._agreed:
                hosts.check_agreement(self.obj, self.devices)
                self._agreed = True
            hosts.exchange(run)  # every rank's status: a failure anywhere raises everywhere
        else:
            run()
        results, handles = [None] * n, [None] * n
        for seqs, res in zip(mine.values(), out):
            for s, r in zip(seqs, res):
                results[s] = to_device(r, device_for(self.devices, s))
                handles[s] = StateHandle(self.name, s, version)
        return results, handles

    def fetch(self, handle: StateHandle):
        """The state ``handle`` stands for, on its sequence's device."""
        ex = self._executor()
        self._check(handle.seq, handle)
        e = handle.seq % len(self.devices)
        if e not in self._here:
            raise ValueError(f"step {self.name}: sequence {handle.seq} is held by rank "
                             f"{hosts.owner(self.devices, e)}")
        value = ex.run([(self._here.index(e), _held_state, (HELD, self.name, handle.seq, handle.version))])[0]
        return to_device(value, device_for(self.devices, handle.seq))

    def close(self) -> None:
        """Drop this step's states where they are held; close the worker pool if the step started it."""
        if self.closed:
            return
        self.closed = True
        pool, self._pool = self._pool, None
        if pool is None:
            return
        if self._owns_pool:
            if isinstance(pool, WorkerPool):
                pool.close()
        elif not getattr(pool, "closed", False):
            pool.run([(i, _drop_held, (HELD, self.name)) for i in range(len(self._local))])


def shard_vmapped_step(fn: Callable, obj, devices: Sequence, pool=None) -> ShardedStep:
    """A batched chunk function over the mesh: ``fn(replica, frames (n, B, H, W), valid (n, B), states,
    seeds) → (results, states)`` over the n sequences that ``obj``'s replica on one entry runs, a
    module-level function; returns the ``ShardedStep`` that runs it (the reference jits the vmapped
    chunk function with the sequence axis sharded over the mesh)."""
    return ShardedStep(fn, obj, devices, pool)


def _process_chunks(pipeline, frames, valid, states, seeds):
    return pipeline.process_chunks(frames, valid, states, seeds)


def shard_batched_pipeline(pipeline, devices: Sequence, pool=None) -> ShardedStep:
    """The multi-sequence VO chunk step over ``devices`` (``SlamPipeline.process_chunks`` of each entry's
    replica); the first call's states are ``pipeline.initial_state()``s, later calls take the handles the
    step returned."""
    return ShardedStep(_process_chunks, pipeline, devices, pool)


def to_device(tree, device: torch.device | str):
    """``tree`` (tensors in tuples, NamedTuples, lists and dicts) with every tensor on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def _run_sequences(system, chunks, seqs: list[int], valid: list, seeds: list[int], carries: list):
    """One mesh entry's sequences ``seqs`` in order, each from its carry (None: a fresh one), its frames
    sent to the device just before it runs → ``[(carry, raw outputs)]``."""
    out = []
    for s, v, seed, carry in zip(seqs, valid, seeds, carries):
        carry = system.initial_carry() if carry is None else to_device(carry, system.device)
        x = chunks[s] if torch.is_tensor(chunks) else torch.from_numpy(np.array(chunks[s]))
        out.append(system._sequence_raw(x.to(system.device), torch.as_tensor(v, dtype=torch.bool), carry, seed))
    return out


def shard_sequence_program(system, devices: Sequence, pool=None):
    """One whole SLAM sequence per device: ``SlamSystem._sequence_raw`` of each sequence's replica.

    Returns ``step(chunks (S, C, B, H, W), chunk_valid (S, C, B), seeds (S,),
    carries=None) → (carries, outs)``, lists by sequence: each sequence
    keeps its own carry (``initial_carry()`` when ``carries`` is None) and
    draws from ``(seeds[s], frame)``; its frames go to its device just
    before it runs.  Sequence s runs on entry ``s % len(devices)``; the
    entries of a mesh of more than one run at the same time in ``pool`` (a
    ``workers.WorkerPool`` or ``InProcess`` over ``devices``; default: a
    ``WorkerPool`` for the call); there the system's draw hooks must pickle
    (one that does not raises ``ValueError`` naming it), and a carry comes
    back on the host.  On a global mesh (``make_device_mesh()`` after
    ``initialize_multihost``) every rank makes the same call, runs the
    sequences of its own entries (``pool`` over those) and returns every
    sequence's carry and outputs, on the host.
    ``outs[s]`` are the raw outputs on the host;
    ``system._fold_sequence(outs[s], n, carries[s])`` is ``run_sequence``'s
    result.
    """

    def step(chunks, chunk_valid, seeds, carries=None):
        n = len(chunks)
        valid = np.asarray(torch.as_tensor(chunk_valid, dtype=torch.bool).cpu())
        given = [None] * n if carries is None else list(carries)
        groups = _entries(n, len(devices))
        values, _ = run_groups(
            devices, pool, groups,
            lambda seqs, _: (_run_sequences, (seqs, [valid[s] for s in seqs], [int(seeds[s]) for s in seqs],
                                              [given[s] for s in seqs])),
            obj=system, frames=chunks)
        carries_out, outs = [None] * n, [None] * n
        for e, seqs in groups.items():
            for s, (carry, raw) in zip(seqs, values[e]):
                carries_out[s], outs[s] = carry, raw
        return carries_out, outs

    return step
