"""Device meshes and multi-sequence SLAM: one sequence per device, each with its own state.

Port of ``tpuslam/dist/mesh.py``.  The reference shards a stacked sequence
axis over a ``jax.sharding.Mesh`` and runs one program per device at once;
in PyTorch's idiom a mesh is an explicit list of ``torch.device``s and the
placement rule replaces ``sequence_sharding``: sequence (or time shard)
``d`` runs on entry ``d % len(devices)``.  The whole-run programs
(``shard_sequence_program`` here, ``run_timesharded`` and
``run_timesharded_system`` in ``timeshard.py``) run the entries of a mesh
of more than one entry at the same time, one worker process each
(``dist/workers.py``), and a mesh of one entry in this process; each entry
runs its own sequences in order.  The per-chunk step
(``shard_vmapped_step``, ``shard_batched_pipeline``) stays in this process:
its loop belongs to the caller, and the entries run in turn there.  VO
sequences that share a mesh entry run as one batched chunk step
(``SlamPipeline.process_chunks``, the reference's ``jax.vmap``).
Per-sequence state never leaves its device during a run, so no collective
is needed.  Each device gets its own replica of the pipeline or system
(``replica_on``: built from ``recipe(obj)``, as a worker process builds
it); the results do not depend on the placement.

The reference runs the unbatched sequence program per device under
``shard_map`` so that its ``lax.cond``s stay real branches; here every
branch is a host read already, so ``shard_sequence_program`` is the plain
``SlamSystem._sequence_raw`` loop of each sequence.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import numpy as np
import torch

from tpuslam_torch.dist.workers import executor


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join a multi-process group when the caller or the environment names a world larger than 1.

    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``; ``coordinator_address`` (``host:port``) to ``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``.  NCCL where a card is visible, gloo
    otherwise.  Returns True when a group of more than one process is
    active, False in a single process (nothing is initialised then).
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return dist.get_world_size() > 1


def make_device_mesh(n_devices: int | None = None, device_type: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` (default: every visible CUDA card).

    There is one CPU device.  Raises ``ValueError`` when more devices are
    asked for than exist, or when there is none.
    """
    if device_type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(device_type)]
    want = len(devices) if n_devices is None else n_devices
    if want < 1 or len(devices) < want:
        raise ValueError(f"Requested {want} devices but only {len(devices)} available.")
    return devices[:want]


def device_for(devices: Sequence[torch.device | str], d: int) -> torch.device:
    """The placement rule: sequence or shard ``d`` runs on ``devices[d % len(devices)]``."""
    return torch.device(devices[d % len(devices)])


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


class _Replicas:
    """One replica of ``obj`` per device, built on first use."""

    def __init__(self, obj, devices: Sequence[torch.device | str]):
        self.obj = obj
        self.devices = list(devices)
        self._by_device: dict[torch.device, object] = {}

    def __call__(self, d: int):
        dev = _canonical(device_for(self.devices, d))
        if dev not in self._by_device:
            self._by_device[dev] = replica_on(self.obj, dev)
        return self._by_device[dev]


def _entries(n: int, n_entries: int) -> dict[int, list[int]]:
    """Sequences ``0..n-1`` grouped by the mesh entry the placement rule gives them, in order."""
    groups: dict[int, list[int]] = {}
    for s in range(n):
        groups.setdefault(s % n_entries, []).append(s)
    return groups


def shard_vmapped_step(batched_fn_on: Callable, devices: Sequence[torch.device | str]):
    """A batched chunk function over the mesh.

    ``batched_fn_on(d)`` is the batched chunk function of sequence d's
    device, ``f(frames (n, B, H, W), valid (n, B), states, seeds) →
    (results, states)`` over the n sequences placed there, lists by
    sequence.  Returns ``step(frames (S, B, H, W), valid (S, B), states,
    seeds) → (results, states)``: lists by sequence, each result and state
    on its sequence's device.  The sequences that share a mesh entry run as
    one call, as the reference vmaps them; the entries run in turn, in this
    process (the caller's loop drives each chunk).
    """

    def step(frames, valid, states, seeds):
        frames = torch.as_tensor(frames)
        valid = torch.as_tensor(valid, dtype=torch.bool)
        results, new_states = [None] * len(frames), [None] * len(frames)
        for seqs in _entries(len(frames), len(devices)).values():
            idx = torch.tensor(seqs)
            res, st = batched_fn_on(seqs[0])(frames[idx], valid[idx], [states[s] for s in seqs],
                                             [int(seeds[s]) for s in seqs])
            for s, r, t in zip(seqs, res, st):
                results[s], new_states[s] = r, t
        return results, new_states

    return step


def shard_batched_pipeline(pipeline, devices: Sequence[torch.device | str]):
    """The multi-sequence VO chunk step over ``devices`` (``SlamPipeline.process_chunks`` of each
    device's replica); the states come from ``replica_on(pipeline, device).initial_state()``."""
    replicas = _Replicas(pipeline, devices)
    return shard_vmapped_step(lambda s: replicas(s).process_chunks, devices)


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


def shard_sequence_program(system, devices: Sequence[torch.device | str], pool=None):
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
    back on the host.
    ``outs[s]`` are the raw outputs on the host;
    ``system._fold_sequence(outs[s], n, carries[s])`` is ``run_sequence``'s
    result.
    """

    def step(chunks, chunk_valid, seeds, carries=None):
        n = len(chunks)
        valid = np.asarray(torch.as_tensor(chunk_valid, dtype=torch.bool).cpu())
        groups = _entries(n, len(devices))
        given = [None] * n if carries is None else list(carries)
        calls = [(e, _run_sequences, (seqs, [valid[s] for s in seqs], [int(seeds[s]) for s in seqs],
                                      [given[s] for s in seqs]))
                 for e, seqs in groups.items()]
        with executor(devices, pool) as ex:
            values = ex.run(calls, obj=system, frames=chunks)
        carries_out, outs = [None] * n, [None] * n
        for (_, seqs), ran in zip(groups.items(), values):
            for s, (carry, raw) in zip(seqs, ran):
                carries_out[s], outs[s] = carry, raw
        return carries_out, outs

    return step
