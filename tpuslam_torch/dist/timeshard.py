"""Time-sharded long-sequence mode: one video cut in time into overlapping segments.

Port of ``tpuslam/dist/timeshard.py``.  One long sequence is cut into D
contiguous segments; each is tracked on its own, with its own state, and
the per-segment trajectories are stitched back into one by aligning each
segment's lead-in frames to the previous segment's already-stitched tail
with a Sim(3) (monocular scale is free per segment).

Layout (core segment length S, overlap V, both multiples of the batch):

    shard 0:  frames [0,            S + V)    core = local [0, S)
    shard d:  frames [d·S − V, (d+1)·S)       core = local [V, V + S)

Shard d runs on entry ``d % len(devices)`` of the mesh (``dist/mesh.py``;
default: the first min(D, visible cards) cards for a pipeline on the card,
``default_mesh``, every rank's cards in a process group).  The entries of a
mesh of more than one run at the same time, one worker process each
(``dist/workers.py``), and a mesh of one entry runs in this process; on a
mesh that spans a process group each rank runs the shards of its own
entries, and the serial part after the shards (the stitch, the
cross-segment pass, the global pose graph) runs once, on the rank that owns
entry 0, and is sent to every rank, so that every rank returns the same
result (``dist/hosts.py``).  In VO mode (``run_timesharded``) an entry's
shards run as one batched sequence (``SlamPipeline.process_chunks`` a
chunk, the reference's ``jax.vmap``), each batched chunk staged just before
it runs; full SLAM (``run_timesharded_system``) runs an entry's shards in
turn, in shard order, one window (``stage_shard``) on the device at a time,
and folds each there, as the reference runs one unbatched program per core.
Either way only the rows that run are read from the frame array: a
``frames_to_memmap`` memmap reads only those, in a worker too (it maps the
file), and another array is copied once into shared memory for the
workers.  Shard d draws from ``(seed + d, local frame)`` in the pipeline's
streams; ``shard_hooks(d)`` may instead give it draw hooks (``draw_fn``,
``pnp_draw_fn``, ``lc_draw_fn``, ``reloc_draw_fn``, called with local frame
ids, so the chunk is ``frame // B``).  A worker receives its hooks pickled,
so on a mesh of more than one entry a hook that cannot be pickled (a
closure) raises ``ValueError`` naming it.

Inside a shard everything runs on local frame ids: the map, the keyframe
DB, ``kf_enabled`` and the BA snapshots.  Only the reported loops, BA
events and the global keyframes are offset by ``d·S − V``, and only core
frames are reported.  With full SLAM, loops whose query and match fall in
different shards are found after the shards by ``cross_segment_loop_closure``
and closed by a global pose graph over every shard's core keyframes.

The Sim(3) helpers are host numpy in float64, copied from the reference.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Sequence

import numpy as np
import torch

from tpuslam_torch.dist import hosts
from tpuslam_torch.dist.mesh import _PIPELINE_HOOKS, _device, _entries, make_device_mesh, replica_on, run_groups
from tpuslam_torch.dist.workers import require_picklable
from tpuslam_torch.model.slam import _stack_results

_CROSS_STREAM = 0x27D4EB2F165667C5  # xor-ed into the seed of cross-segment verification's draws


# --------------------------------------------------------------------------
# Host-side slicing
# --------------------------------------------------------------------------
def plan_time_shards(n_frames: int, n_shards: int, batch: int, overlap: int | None = None) -> tuple[int, int]:
    """Choose (core segment length S, overlap V), both multiples of ``batch``.

    ``n_shards * S >= n_frames``; the overlap defaults to one chunk.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    V = batch if overlap is None else overlap
    if V < 2 or V % batch:
        raise ValueError("overlap must be a positive multiple of the batch size")
    S = -(-n_frames // n_shards)  # ceil
    S = -(-S // batch) * batch  # round up to a chunk multiple
    if n_shards > 1 and V > S:
        raise ValueError(f"overlap {V} exceeds segment length {S}")
    return S, V


def _shard_start(d: int, S: int, V: int) -> int:
    return 0 if d == 0 else d * S - V


def shard_frames_in_time(
    frames: np.ndarray, n_shards: int, batch: int, overlap: int | None = None
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Cut one (N, H, W) sequence into overlapping per-shard windows, all at once.

    Returns ``(shards (D, S+V, H, W), valid (D, S+V), S, V)``.  Frames past
    the end pad the last shard with the last frame and are invalid.
    """
    n = frames.shape[0]
    S, V = plan_time_shards(n, n_shards, batch, overlap)
    L = S + V
    pad_to = (n_shards - 1) * S + L if n_shards > 1 else L
    padded = np.concatenate([frames, np.repeat(frames[-1:], max(pad_to - n, 0), axis=0)], axis=0)
    starts = [_shard_start(d, S, V) for d in range(n_shards)]
    shards = np.stack([padded[s : s + L] for s in starts])
    valid = np.stack([(np.arange(s, s + L) < n) for s in starts])
    return shards, valid, S, V


def _window_rows(frames, shards: Sequence[int], rows: np.ndarray, S: int, V: int, device):
    """Local frames ``rows`` of each of ``shards``' windows: ``(frames (len(shards), len(rows), H, W)
    uint8 on device, valid (len(shards), len(rows)) bool on the host)``.  Indices past the end clamp
    to the last frame and are invalid, as ``shard_frames_in_time`` pads; only those rows are read."""
    n = len(frames)
    pos = np.stack([_shard_start(d, S, V) + rows for d in shards])
    window = np.ascontiguousarray(np.asarray(frames)[np.minimum(pos, n - 1)])
    return torch.from_numpy(window).to(device), torch.from_numpy(pos < n)


def stage_shard(frames, d: int, S: int, V: int, batch: int, device: torch.device | str):
    """Shard ``d``'s window of ``frames`` (an array or memmap) on ``device``.

    Returns ``(chunks (C, B, H, W) uint8 on device, valid (C, B) bool on the
    host)`` with C = (S + V) / B.
    """
    L = S + V
    window, valid = _window_rows(frames, [d], np.arange(L), S, V, device)
    return window[0].reshape(L // batch, batch, *window.shape[2:]), valid[0].reshape(L // batch, batch)


def _core_ok(pose_ok: np.ndarray, S: int, V: int, n: int) -> np.ndarray:
    D = pose_ok.shape[0]
    return np.concatenate([pose_ok[0, :S]] + [pose_ok[d, V : V + S] for d in range(1, D)])[:n]


@contextmanager
def _shard_hooks(obj, hooks: dict | None):
    """Set ``hooks`` on a ``SlamPipeline`` or ``SlamSystem`` (the two-view and tracker hooks live on
    its pipeline) for one shard's run, and restore what was there."""
    if not hooks:
        yield
        return
    pipe = getattr(obj, "pipeline", obj)
    saved = []
    for name, fn in hooks.items():
        target = pipe if name in _PIPELINE_HOOKS else obj
        saved.append((target, name, getattr(target, name)))
        setattr(target, name, fn)
    try:
        yield
    finally:
        for target, name, fn in reversed(saved):
            setattr(target, name, fn)


def default_mesh(obj, n_shards: int) -> list:
    """The mesh of a time-sharded run of ``obj`` (a ``SlamPipeline`` or ``SlamSystem``) into ``n_shards``:
    the first min(n_shards, visible cards) cards when ``obj`` is on the card (the reference's
    ``make_device_mesh(n_shards)``, without its refusal of fewer cards than shards: shard d runs on
    entry ``d % len``), else ``obj``'s own device; ``obj``'s device alone where that is one card.  In a
    process group (``mesh.initialize_multihost``) the first min(n_shards, its size) entries of the global
    mesh of ``obj``'s device type (a collective: every rank calls it)."""
    dev = torch.device(obj.device)
    if hosts.group_active():
        every = make_device_mesh(device_type=dev.type)
        return every[:min(n_shards, len(every))]
    n = min(n_shards, torch.cuda.device_count()) if dev.type == "cuda" else 1
    return make_device_mesh(n) if n > 1 else [dev]


def _on_lead(devices, fn):
    """``fn()`` once: here on a mesh of this process, on the rank that owns entry 0 of a global mesh, which
    sends its value to every rank."""
    lead = hosts.owner(devices, 0)
    return fn() if lead is None else hosts.exchange(fn, root=lead)[0]


def _hooks(shard_hooks, shards: list[int], pickled: bool, allowed: set | None = None) -> list[dict]:
    """``shard_hooks(d)`` of each shard (``{}`` without it): only ``allowed`` names where given, and each
    hook picklable where the shards run in another process (``pickled``)."""
    hooks = [shard_hooks(d) if shard_hooks else {} for d in shards]
    for d, h in zip(shards, hooks):
        extra = sorted(set(h) - allowed) if allowed is not None else []
        if extra:
            raise ValueError(f"shard {d}: run_timesharded takes a draw_fn hook only, not {extra}")
        if pickled:
            require_picklable(h, f"shard {d}")
    return hooks


# --------------------------------------------------------------------------
# Sharded tracking
# --------------------------------------------------------------------------
def _track_shards(pipe, frames, shards: list[int], hooks: list[dict], S: int, V: int, seed: int) -> list:
    """One mesh entry's shards as one batched sequence, a batched chunk staged just before it runs →
    ``[(poses (S+V, 4, 4), pose_ok (S+V,))]`` by shard, numpy."""
    B = pipe.config.batch_size
    draw_fns = [h.get("draw_fn", pipe.draw_fn) for h in hooks]
    states = [pipe.initial_state() for _ in shards]
    out = []
    for c in range((S + V) // B):
        chunk, valid = _window_rows(frames, shards, c * B + np.arange(B), S, V, pipe.device)
        results, states = pipe.process_chunks(chunk, valid, states, [seed + d for d in shards], draw_fns)
        out.append(results)
    tracked = []
    for i in range(len(shards)):
        result = _stack_results([r[i] for r in out])
        tracked.append((result.poses.reshape(-1, 4, 4).cpu().numpy(), result.pose_ok.reshape(-1).cpu().numpy()))
    return tracked


def run_timesharded(
    pipeline,
    frames,
    n_shards: int,
    overlap: int | None = None,
    seed: int = 0,
    devices: Sequence[torch.device | str] | None = None,
    shard_hooks: Callable[[int], dict] | None = None,
    pool=None,
) -> dict:
    """Track one long sequence cut into ``n_shards`` time segments (VO), then stitch.

    Each shard runs over its S + V frames with seed + d, on entry ``d %
    len(devices)`` (default ``default_mesh(pipeline, n_shards)``); the shards
    of one entry run as one batched sequence, one
    ``SlamPipeline.process_chunks`` a chunk, each shard with its own carry
    and draws (``shard_hooks(d)`` may give shard d a ``draw_fn``).  The
    entries of a mesh of more than one run at the same time in ``pool`` (a
    ``workers.WorkerPool`` or ``InProcess`` over ``devices``; default: a
    ``WorkerPool`` for the call); there every hook must pickle, and one
    that does not raises ``ValueError`` naming it.  On a global mesh every
    rank makes the same call, runs its own entries' shards (``pool`` over
    those), and gets the stitch made on entry 0's rank.  Returns ``poses`` (N, 4,
    4) stitched in shard 0's frame, ``pose_ok`` (N,) of the core frames,
    ``segments`` (D, S+V, 4, 4) raw per shard, ``segments_ok``, ``S``,
    ``V``.
    """
    B = pipeline.config.batch_size
    n = len(frames)
    S, V = plan_time_shards(n, n_shards, B, overlap)
    devices = default_mesh(pipeline, n_shards) if devices is None else devices
    poses, pose_ok = [None] * n_shards, [None] * n_shards
    groups = _entries(n_shards, len(devices))
    values, _ = run_groups(
        devices, pool, groups,
        lambda shards, crosses: (_track_shards, (shards, _hooks(shard_hooks, shards, crosses, {"draw_fn"}), S, V,
                                                 seed)),
        obj=pipeline, frames=frames)
    for e, shards in groups.items():
        for d, (p, ok) in zip(shards, values[e]):
            poses[d], pose_ok[d] = p, ok
    poses, pose_ok = np.stack(poses), np.stack(pose_ok)
    return {
        "poses": _on_lead(devices, lambda: stitch_segments(poses, S, V, n, pose_ok=pose_ok)),
        "pose_ok": _core_ok(pose_ok, S, V, n),
        "segments": poses,
        "segments_ok": pose_ok,
        "S": S,
        "V": V,
    }


def _system_shards(system, frames, shards: list[int], hooks: list[dict], S: int, V: int, seed: int) -> list:
    """One mesh entry's shards of a full SLAM run, in turn: each shard's ``_sequence_raw`` from a fresh
    carry, then its fold over all its S + V frames (``run_sequence``'s: BA snapshots, then its pose
    graph), its core region's loops and BA events at global frame ids."""
    B = system.config.batch_size
    L = S + V
    out = []
    for d, h in zip(shards, hooks):
        t0 = time.perf_counter()
        chunks, valid = stage_shard(frames, d, S, V, B, system.device)
        with _shard_hooks(system, h):
            carry, raw = system._sequence_raw(chunks, valid, system.initial_carry(), seed + d)
        del chunks
        t1 = time.perf_counter()
        folded = system._fold_sequence(raw, L, carry)
        offset = _shard_start(d, S, V)
        core_lo = 0 if d == 0 else V
        out.append({
            "ba_events": [{**ev, "frame_id": offset + ev["frame_id"]}
                          for ev in folded["ba_events"] if ev["frame_id"] >= core_lo],
            "loops": [{**lp, "frame_id": offset + lp["frame_id"],
                       "matched_keyframe_id": offset + lp["matched_keyframe_id"]}
                      for lp in folded["loops"] if lp["frame_id"] >= core_lo],
            "db": folded["db"],
            "poses": folded["poses"],
            "pose_ok": folded["pose_ok"],
            "kf_enabled": raw["kf_enabled"].reshape(L),
            "seconds": (t1 - t0, time.perf_counter() - t1),
        })
    return out


def run_timesharded_system(
    system,
    frames,
    n_shards: int,
    overlap: int | None = None,
    seed: int = 0,
    devices: Sequence[torch.device | str] | None = None,
    shard_hooks: Callable[[int], dict] | None = None,
    pool=None,
) -> dict:
    """Time-shard a full SLAM run (tracking, map, loop closure, BA; VO or PnP tracking).

    Each shard runs ``SlamSystem._sequence_raw`` from a fresh carry with
    seed + d: its own map, keyframe DB and BA schedule, on entry ``d %
    len(devices)`` (default ``default_mesh(system, n_shards)``), an entry's
    shards in turn.  Each shard's outputs fold there as ``run_sequence``'s
    do (``_fold_sequence`` over all S + V frames: its BA snapshots, then its
    own pose graph), and the BA events and loops of its core region are
    kept at global ids ``d·S − V + local``.  The entries of a mesh of more
    than one run at the same time in ``pool`` (a ``workers.WorkerPool`` or
    ``InProcess`` over ``devices``; default: a ``WorkerPool`` for the
    call); there every hook, the system's and ``shard_hooks(d)``'s, must
    pickle, and one that does not raises ``ValueError`` naming it, and the
    DBs come back on the host.  Then, here, the shards stitch as in VO
    mode; with loop closure and more than one shard,
    ``cross_segment_loop_closure`` scores each shard's DB against every
    earlier shard's and verifies the best candidates in one batched call on
    shard 0's device; verified cross loops feed a global pose graph over
    every shard's core keyframes on the stitched trajectory.  On a global
    mesh every rank makes the same call and runs its own entries' shards;
    the stitch, the cross pass and the global graph run on entry 0's rank,
    and every rank returns the same result.

    Returns ``poses``, ``pose_ok``, ``segments``, ``segments_ok``,
    ``loops`` (in-shard core loops, then cross loops), ``cross_loops``,
    ``ba_events``, ``S``, ``V``, ``dbs`` (each shard's final DB, None
    without loop closure), ``global_keyframes``, ``pose_graph_applied``
    (the global graph) and ``seconds``: host time of each shard's run and
    of its fold (``shards``, ``folds``, taken where the shard ran), each
    entry's wall time over its shards (``workers``), and the stitch's, the
    cross pass's and the global pose graph's.
    """
    B = system.config.batch_size
    n = len(frames)
    S, V = plan_time_shards(n, n_shards, B, overlap)
    D = n_shards
    devices = default_mesh(system, n_shards) if devices is None else devices
    seconds = {"shards": [0.0] * D, "folds": [0.0] * D, "workers": [], "stitch": 0.0, "cross": 0.0,
               "pose_graph": 0.0}
    shard_out = [None] * D
    groups = _entries(D, len(devices))
    values, walls = run_groups(
        devices, pool, groups,
        lambda shards, crosses: (_system_shards, (shards, _hooks(shard_hooks, shards, crosses), S, V, seed)),
        obj=system, frames=frames)
    seconds["workers"] = [t1 - t0 for t0, t1 in walls.values()]
    for e, shards in groups.items():
        for d, o in zip(shards, values[e]):
            shard_out[d] = o
            seconds["shards"][d], seconds["folds"][d] = o["seconds"]

    all_ba_events = [ev for o in shard_out for ev in o["ba_events"]]
    all_loops = [lp for o in shard_out for lp in o["loops"]]
    dbs = [o["db"] for o in shard_out]
    segments = [o["poses"] for o in shard_out]
    pose_ok = [o["pose_ok"] for o in shard_out]
    kf_enabled = [o["kf_enabled"] for o in shard_out]

    segments, pose_ok = np.stack(segments), np.stack(pose_ok)

    def serial() -> tuple:
        """The stitch, the cross-segment pass and the global pose graph, with their seconds."""
        t0 = time.perf_counter()
        stitched = stitch_segments(segments, S, V, n, pose_ok=pose_ok)
        secs = {"stitch": time.perf_counter() - t0, "cross": 0.0, "pose_graph": 0.0}
        cross_loops: list[dict] = []
        global_kf: list[int] = []
        pose_graph_applied = False
        if system.loop_closure is not None and D > 1:
            t0 = time.perf_counter()
            # the cross pass and the global graph run on shard 0's device
            lead = replica_on(system, _device(devices[0]))
            cross_loops = cross_segment_loop_closure(lead, dbs, D, S, V, n, seed=seed)
            secs["cross"] = time.perf_counter() - t0
            # each shard's core keyframes at global ids (lead-in keyframes repeat the previous shard's tail)
            for d in range(D):
                lo, hi = (0, S) if d == 0 else (V, V + S)
                offset = _shard_start(d, S, V)
                global_kf.extend(offset + int(f) for f in np.nonzero(kf_enabled[d])[0]
                                 if lo <= f < hi and offset + f < n)
            if cross_loops and system.enable_pose_graph and len(global_kf) >= 2:
                t0 = time.perf_counter()
                stitched = lead._apply_pose_graph(stitched, global_kf, all_loops + cross_loops)
                secs["pose_graph"] = time.perf_counter() - t0
                pose_graph_applied = True
        return stitched, cross_loops, global_kf, pose_graph_applied, secs

    stitched, cross_loops, global_kf, pose_graph_applied, secs = _on_lead(devices, serial)
    seconds.update(secs)

    return {
        "poses": stitched,
        "pose_ok": _core_ok(pose_ok, S, V, n),
        "segments": segments,
        "segments_ok": pose_ok,
        "loops": all_loops + cross_loops,
        "cross_loops": cross_loops,
        "ba_events": all_ba_events,
        "S": S,
        "V": V,
        "dbs": dbs if system.loop_closure is not None else None,
        "global_keyframes": global_kf,
        "pose_graph_applied": pose_graph_applied,
        "seconds": seconds,
    }


def cross_segment_candidates(dbs_host: list[dict], D: int, S: int, V: int, n: int, min_frames_difference: int,
                             min_absolute_score: float, budget: int) -> list[tuple[float, int, int, int, int]]:
    """The cross pass's candidates on the host: ``(score, query shard, query slot, match shard, match slot)``.

    ``dbs_host[d]`` holds shard d's ``bow`` (C, W) and ``ids`` (C,) as numpy.
    For each later shard's core keyframe, the best of every earlier shard's
    core keyframes more than V + ``min_frames_difference`` frames away by
    BoW score (at least ``min_absolute_score``); the best per query, then
    the ``budget`` best overall.
    """
    offsets = [_shard_start(d, S, V) for d in range(D)]
    core_lo = [0] + [V] * (D - 1)
    core_hi = [S] + [V + S] * (D - 1)
    cands: list[tuple[float, int, int, int, int]] = []
    for qd in range(1, D):
        ids_q = dbs_host[qd]["ids"]
        gq = offsets[qd] + ids_q
        okq = (ids_q >= core_lo[qd]) & (ids_q < core_hi[qd]) & (gq < n)
        if not okq.any():
            continue
        for td in range(qd):
            ids_t = dbs_host[td]["ids"]
            gt = offsets[td] + ids_t
            okt = (ids_t >= core_lo[td]) & (ids_t < core_hi[td]) & (gt < n)
            far = np.abs(gq[:, None] - gt[None, :]) > V + min_frames_difference
            mask = okq[:, None] & okt[None, :] & far
            if not mask.any():
                continue
            scores = np.where(mask, dbs_host[qd]["bow"] @ dbs_host[td]["bow"].T, -np.inf)
            best_t = np.argmax(scores, axis=1)
            best_s = scores[np.arange(scores.shape[0]), best_t]
            for qs in np.nonzero(best_s >= min_absolute_score)[0]:
                cands.append((float(best_s[qs]), qd, int(qs), td, int(best_t[qs])))
    best_by_query: dict[tuple[int, int], tuple] = {}
    for c in cands:
        k = (c[1], c[2])
        if k not in best_by_query or c[0] > best_by_query[k][0]:
            best_by_query[k] = c
    return sorted(best_by_query.values(), reverse=True)[:budget]


def cross_segment_loop_closure(system, dbs: list, D: int, S: int, V: int, n: int, seed: int = 0,
                               budget: int | None = None, details: bool = False):
    """Detect and verify loops whose query and match fall in different shards.

    ``dbs``: each shard's final ``KeyframeDB`` (on any device).  Candidates
    come from ``cross_segment_candidates`` (``budget`` defaults to
    max(2D, 8)); their rows are gathered onto ``system``'s device and
    verified in one batched call of ``LoopClosure._verify_impl`` (re-match,
    RANSAC DLT-PnP), candidate i drawing from ``(seed, i)`` in its own
    stream or from ``system.cross_draw_fn(i, len(candidates), valid)``.

    Returns the verified loops in global frame ids, as ``run_sequence``'s
    loops plus ``bow_score`` and ``cross_segment``; with ``details``,
    ``(loops, candidates, ok, T, num_inliers)``, the last three numpy over
    every candidate.
    """
    from tpuslam_torch.backend.pnp import gumbel_sample_indices
    from tpuslam_torch.model.slam import _stream_seed
    from tpuslam_torch.utils.convert import _numpy

    lc = system.loop_closure
    cfg = lc.config
    if budget is None:
        budget = max(2 * D, 8)
    host = [{"bow": _numpy(db.bow), "ids": _numpy(db.ids)} for db in dbs]
    chosen = cross_segment_candidates(host, D, S, V, n, cfg.min_frames_difference, cfg.min_absolute_score, budget)
    empty = np.zeros(0, bool), np.zeros((0, 4, 4), np.float32), np.zeros(0, np.int32)
    if not chosen:
        return ([], chosen, *empty) if details else []
    dev = system.device

    def gather(field: str, rows: list[tuple[int, int]]) -> torch.Tensor:
        return torch.stack([getattr(dbs[d], field)[s].to(dev) for d, s in rows])

    q_rows = [(qd, qs) for _, qd, qs, _, _ in chosen]
    t_rows = [(td, ts) for _, _, _, td, ts in chosen]
    Kc = len(chosen)

    def sampler(positions, valid, H):
        out = []
        for i, p in enumerate(positions):
            if system.cross_draw_fn is not None:
                out.append(torch.as_tensor(system.cross_draw_fn(p, Kc, valid[i]), device=dev))
            else:
                gen = system.pipeline._generator
                gen.manual_seed(_stream_seed(seed, p, _CROSS_STREAM))
                out.append(gumbel_sample_indices(valid[i], H, 6, gen))
        return torch.stack(out).to(torch.int64)

    ok, T, ninl, _ = lc._verify_impl(
        gather("descriptors", q_rows), gather("xy", q_rows), gather("kp_valid", q_rows),
        gather("descriptors", t_rows), gather("xy", t_rows), gather("kp_valid", t_rows),
        gather("map_points", t_rows), gather("mp_valid", t_rows),
        torch.ones(Kc, dtype=torch.bool, device=dev), system._K, list(range(Kc)), sampler,
    )
    ok, T, ninl = ok.cpu().numpy(), T.cpu().numpy(), ninl.cpu().numpy()
    offsets = [_shard_start(d, S, V) for d in range(D)]
    loops = [
        {"frame_id": int(offsets[qd] + host[qd]["ids"][qs]),
         "matched_keyframe_id": int(offsets[td] + host[td]["ids"][ts]),
         "num_inliers": int(ninl[i]), "relative_transform": T[i], "bow_score": float(sc), "cross_segment": True}
        for i, (sc, qd, qs, td, ts) in enumerate(chosen) if ok[i]
    ]
    return (loops, chosen, ok, T, ninl) if details else loops


# --------------------------------------------------------------------------
# Host-side Sim(3) stitching
# --------------------------------------------------------------------------
def _centers(T: np.ndarray) -> np.ndarray:
    return np.asarray(T, np.float64)[:, :3, 3]


def sim3_from_pose_pairs(T_src: np.ndarray, T_dst: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Sim(3) (R, t, s) with ``T_dst ≈ [s·R|t] ∘ T_src`` from paired poses.

    Rotation is the polar mean of the paired orientations, polar(Σ R_dstᵢ
    R_srcᵢᵀ), which collinear forward motion does not make degenerate as it
    does Umeyama on the camera centres; scale and translation are then the
    closed-form least squares on the centres.
    """
    T_src = np.asarray(T_src, np.float64)
    T_dst = np.asarray(T_dst, np.float64)
    M = np.einsum("nij,nkj->ik", T_dst[:, :3, :3], T_src[:, :3, :3])
    U, _, Vt = np.linalg.svd(M)
    Sg = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sg[2, 2] = -1
    R = U @ Sg @ Vt
    cs, cd = _centers(T_src), _centers(T_dst)
    mu_s, mu_d = cs.mean(axis=0), cd.mean(axis=0)
    xs = (cs - mu_s) @ R.T
    xd = cd - mu_d
    denom = float((xs**2).sum())
    s = float((xs * xd).sum() / denom) if denom > 1e-18 else 1.0
    if s <= 1e-12:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def apply_sim3(R: np.ndarray, t: np.ndarray, s: float, T: np.ndarray) -> np.ndarray:
    """Apply a Sim(3) to (N, 4, 4) world-from-camera poses: centres C ← s·R·C + t, orientations
    R_wc ← R·R_wc."""
    T = np.asarray(T, np.float64)
    out = np.tile(np.eye(4), (T.shape[0], 1, 1))
    out[:, :3, :3] = R @ T[:, :3, :3]
    out[:, :3, 3] = (s * (T[:, :3, 3] @ R.T)) + t
    return out


def stitch_segments(
    poses: np.ndarray, S: int, V: int, n_frames: int, pose_ok: np.ndarray | None = None
) -> np.ndarray:
    """Fold per-shard trajectories (D, S+V, 4, 4) into one (n_frames, 4, 4) float32 trajectory.

    Shard d's V lead-in poses re-track the previous shard's last V core
    frames; the Sim(3) of those pairs maps the shard into the stitched
    frame, cumulatively.  With ``pose_ok`` (D, S+V) a pair counts only when
    both sides tracked it; fewer than 2 such pairs fall back to all pairs.
    """
    D = poses.shape[0]
    if pose_ok is None:
        pose_ok = np.ones(poses.shape[:2], bool)
    out = np.asarray(poses[0], np.float64).copy()
    out = out[:S] if D > 1 else out
    stitched = [out]
    ok_tail = pose_ok[0, :S]
    total = S
    for d in range(1, D):
        ref = np.concatenate(stitched)[total - V : total]
        pair_ok = pose_ok[d, :V] & ok_tail[-V:]
        if pair_ok.sum() < 2:
            pair_ok = np.ones(V, bool)
        R, t, s = sim3_from_pose_pairs(poses[d, :V][pair_ok], ref[pair_ok])
        stitched.append(apply_sim3(R, t, s, poses[d, V : V + S]))
        ok_tail = pose_ok[d, V : V + S]
        total += S
    return np.asarray(np.concatenate(stitched)[:n_frames], np.float32)
