"""Device meshes and multi-sequence SLAM: one sequence per device, each with its own state.

Port of ``tpuslam/dist/mesh.py``.  The reference shards a stacked sequence
axis over a ``jax.sharding.Mesh`` and runs one program; in PyTorch's idiom
a mesh is an explicit list of ``torch.device``s and the placement rule
replaces ``sequence_sharding``: sequence (or time shard) ``d`` runs on
``devices[d % len(devices)]``.  VO sequences that share a device run as one
batched chunk step (``SlamPipeline.process_chunks``, the reference's
``jax.vmap``); distinct devices run in turn.  Per-sequence state never
leaves its device, so no collective is needed.  Each device gets its own
replica of the pipeline or system (``replica_on``); the results do not
depend on the placement.

The reference runs the unbatched sequence program per device under
``shard_map`` so that its ``lax.cond``s stay real branches; here every
branch is a host read already, so ``shard_sequence_program`` is the plain
``SlamSystem._sequence_raw`` loop of each sequence.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

import torch


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


def replica_on(obj, device: torch.device | str):
    """``obj`` (a ``SlamPipeline`` or ``SlamSystem``) itself if it lives on ``device``, else a copy
    built there with the same configuration, vocabulary and draw hooks."""
    from tpuslam_torch.model.slam import SlamPipeline

    if _canonical(obj.device) == _canonical(device):
        return obj
    if isinstance(obj, SlamPipeline):
        return SlamPipeline(
            obj.camera, obj.config, tracking=obj.tracking, device=device, draw_fn=obj.draw_fn,
            with_features=obj.with_features, nms_fused=obj.detector.nms_fused, map_window=obj.map_window,
            max_map_points=obj.max_map_points, pnp_gn_iters=obj.pnp_gn_iters, freeze_map=obj.freeze_map,
            pnp_draw_fn=obj.pnp_draw_fn,
        )
    vocab = obj.vocabulary if obj.loop_closure is None else obj.loop_closure.vocabulary.to(device)
    return dataclasses.replace(obj, device=device, vocabulary=vocab)


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


def _groups(n: int, devices: Sequence[torch.device | str]) -> dict[torch.device, list[int]]:
    """Sequences ``0..n-1`` grouped by the device the placement rule gives them, in order."""
    groups: dict[torch.device, list[int]] = {}
    for s in range(n):
        groups.setdefault(_canonical(device_for(devices, s)), []).append(s)
    return groups


def shard_vmapped_step(batched_fn_on: Callable, devices: Sequence[torch.device | str]):
    """A batched chunk function over the mesh.

    ``batched_fn_on(d)`` is the batched chunk function of sequence d's
    device, ``f(frames (n, B, H, W), valid (n, B), states, seeds) →
    (results, states)`` over the n sequences placed there, lists by
    sequence.  Returns ``step(frames (S, B, H, W), valid (S, B), states,
    seeds) → (results, states)``: lists by sequence, each result and state
    on its sequence's device.  The sequences that share a device run as one
    call, as the reference vmaps them; distinct devices run in turn.
    """

    def step(frames, valid, states, seeds):
        frames = torch.as_tensor(frames)
        valid = torch.as_tensor(valid, dtype=torch.bool)
        results, new_states = [None] * len(frames), [None] * len(frames)
        for seqs in _groups(len(frames), devices).values():
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


def shard_sequence_program(system, devices: Sequence[torch.device | str]):
    """One whole SLAM sequence per device: ``SlamSystem._sequence_raw`` of each sequence's replica.

    Returns ``step(chunks (S, C, B, H, W), chunk_valid (S, C, B), seeds (S,),
    carries=None) → (carries, outs)``, lists by sequence: each sequence
    keeps its own carry (``initial_carry()`` when ``carries`` is None) and
    draws from ``(seeds[s], frame)``; its frames go to its device just
    before it runs.  ``outs[s]`` are the raw outputs on the host;
    ``system._fold_sequence(outs[s], n, carries[s])`` is ``run_sequence``'s
    result.
    """
    replicas = _Replicas(system, devices)

    def step(chunks, chunk_valid, seeds, carries=None):
        carries_out, outs = [], []
        for s in range(len(chunks)):
            rep = replicas(s)
            carry = rep.initial_carry() if carries is None else carries[s]
            x = torch.as_tensor(chunks[s]).to(rep.device)
            carry, raw = rep._sequence_raw(x, torch.as_tensor(chunk_valid[s], dtype=torch.bool), carry,
                                           int(seeds[s]))
            carries_out.append(carry)
            outs.append(raw)
        return carries_out, outs

    return step
