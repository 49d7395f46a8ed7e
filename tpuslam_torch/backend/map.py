"""Fixed-shape world map: keyframe poses, 3D points and their observations.

Port of ``tpuslam/backend/map.py``.  The map is an immutable tuple of
capacity-bounded tensors: every function returns new tensors and leaves its
inputs as they were.  Observations are a dense (W keyframes × P points) grid
with a mask.

The reference builds its scatters from one-hot equality tables, one-hot
matmuls and roll/blits, because a scatter is slow on a TPU.  Here the same
semantics are an index reduction, a gather and an indexed write:

* on duplicate target rows the *first valid* writer wins — an
  ``amin``-reduction of the writers' positions picks it, since an indexed
  write with repeated indices picks an unspecified writer on the card;
* integer payloads stay exact (a gather, no float product);
* point slots are a ring allocated from ``point_count``, and a recycled
  slot loses its observations;
* a disabled keyframe insert is a no-op that returns slot −1.

A chunk of frames folds into the map by ``update_map_chunk`` (the per-frame
scan, the oracle) or ``update_map_chunk_batched`` (the default: a lean
identity scan, then one rebuild of the rows that survive the chunk).

Counters and slots stay on the map's device, so no call syncs with the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def row_select(
    slots: torch.Tensor,  # (..., M) target rows (may repeat; out of range = dropped)
    valid: torch.Tensor,  # (..., M) bool
    out_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Writer of each target row: ``(first (..., out_rows) int64, written (..., out_rows) bool)``.

    ``first[r]`` is the position of the first valid entry whose slot is r
    (0 where no entry writes r, as the reference's argmax of an empty row).
    Leading dimensions are independent tables.
    """
    *lead, M = slots.shape
    L = math.prod(lead)
    dev = slots.device
    slots = slots.reshape(L, M).to(torch.int64)
    take = valid.reshape(L, M) & (slots >= 0) & (slots < out_rows)
    # row out_rows of each table collects the dropped entries
    target = torch.where(take, slots, out_rows) + (out_rows + 1) * torch.arange(L, device=dev)[:, None]
    pos = torch.arange(M, device=dev).expand(L, M)
    first = torch.full((L * (out_rows + 1),), M, dtype=torch.int64, device=dev)
    first = first.scatter_reduce(0, target.reshape(-1), pos.reshape(-1), "amin", include_self=True)
    first = first.reshape(L, out_rows + 1)[:, :out_rows]
    written = first < M
    first = torch.where(written, first, 0)
    return first.reshape(*lead, out_rows), written.reshape(*lead, out_rows)


def apply_row_select(
    first: torch.Tensor,  # (..., out_rows) int64 from row_select
    written: torch.Tensor,  # (..., out_rows) bool from row_select
    values: torch.Tensor,  # (..., M, D) or (..., M) payload
) -> torch.Tensor:
    """Each target row's payload from its writer; rows no entry writes are 0."""
    d = first.ndim - 1  # the row axis
    tail = values.shape[d + 1 :]
    idx = first.reshape(first.shape + (1,) * len(tail)).expand(*first.shape, *tail)
    rows = torch.gather(values, d, idx)
    w = written.reshape(written.shape + (1,) * len(tail))
    return torch.where(w, rows, torch.zeros((), dtype=values.dtype, device=values.device))


def scatter_rows_dense(
    values: torch.Tensor,  # (..., M, D) or (..., M) source values
    slots: torch.Tensor,  # (..., M) target rows (may repeat; out of range = dropped)
    valid: torch.Tensor,  # (..., M) bool
    out_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-valid-writer scatter → (rows (..., out_rows, D), written (..., out_rows)); unwritten rows are 0."""
    first, written = row_select(slots, valid, out_rows)
    return apply_row_select(first, written, values), written


def _scatter_rows_multi(
    slots: torch.Tensor,  # (..., M) target rows
    valid: torch.Tensor,  # (..., M) bool
    payloads: list[torch.Tensor],  # each (..., M) or (..., M, D)
    out_rows: int,
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """First-valid-writer scatter of several payloads through one writer table → (written, rows)."""
    first, written = row_select(slots, valid, out_rows)
    return written, [apply_row_select(first, written, p) for p in payloads]


def _apply_row_scatter(
    target: torch.Tensor,  # (P,) or (P, D)
    values: torch.Tensor,  # (M,) or (M, D)
    slots: torch.Tensor,  # (M,)
    valid: torch.Tensor,  # (M,) bool
) -> torch.Tensor:
    """``target`` with row ``slots[i]`` set to ``values[i]`` where valid (first valid writer wins)."""
    written, (rows,) = _scatter_rows_multi(slots, valid, [values], target.shape[0])
    w = written.reshape(written.shape + (1,) * (target.ndim - 1))
    return torch.where(w, rows, target)


def _compact_valid(
    valid: torch.Tensor, payloads: list[torch.Tensor], cap: int
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The first ``cap`` valid entries along the last axis of ``valid``, in ascending order.

    Overflow (more than ``cap`` valid) drops the highest-index ones.  A
    stable sort puts the valid entries first in their order; the invalid
    ones fill the rest.  Returns (valid' (..., cap), each payload gathered
    along the same axis).
    """
    d = valid.ndim - 1
    order = torch.argsort((~valid).to(torch.uint8), dim=d, stable=True)
    order = order.narrow(d, 0, min(cap, valid.shape[d]))

    def take(p: torch.Tensor) -> torch.Tensor:
        tail = p.shape[d + 1 :]
        return torch.gather(p, d, order.reshape(order.shape + (1,) * len(tail)).expand(*order.shape, *tail))

    return take(valid), [take(p) for p in payloads]


class MapState(NamedTuple):
    """World state.  W = keyframe window capacity, P = point capacity."""

    kf_R: torch.Tensor  # (W, 3, 3) float32 — world→camera rotation (x_c = R X + t)
    kf_t: torch.Tensor  # (W, 3) float32
    kf_id: torch.Tensor  # (W,) int32 — frame id (−1 = empty)
    kf_valid: torch.Tensor  # (W,) bool
    points: torch.Tensor  # (P, 3) float32 — world coordinates
    point_valid: torch.Tensor  # (P,) bool
    point_birth: torch.Tensor  # (P,) int32 — allocation counter at insertion
    obs_uv: torch.Tensor  # (W, P, 2) float32 — pixel observation of point j in keyframe i
    obs_mask: torch.Tensor  # (W, P) bool
    kf_count: torch.Tensor  # () int32 — keyframes ever inserted
    point_count: torch.Tensor  # () int32 — points ever inserted

    @property
    def window(self) -> int:
        return self.kf_R.shape[0]

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def empty_map(window: int = 8, max_points: int = 4096, device: torch.device | str = "cpu") -> MapState:
    dev = torch.device(device)
    return MapState(
        kf_R=torch.eye(3, device=dev).expand(window, 3, 3).clone(),
        kf_t=torch.zeros((window, 3), device=dev),
        kf_id=torch.full((window,), -1, dtype=torch.int32, device=dev),
        kf_valid=torch.zeros((window,), dtype=torch.bool, device=dev),
        points=torch.zeros((max_points, 3), device=dev),
        point_valid=torch.zeros((max_points,), dtype=torch.bool, device=dev),
        point_birth=torch.full((max_points,), -1, dtype=torch.int32, device=dev),
        obs_uv=torch.zeros((window, max_points, 2), device=dev),
        obs_mask=torch.zeros((window, max_points), dtype=torch.bool, device=dev),
        kf_count=torch.zeros((), dtype=torch.int32, device=dev),
        point_count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _scalar(x: torch.Tensor | int | bool, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-d tensor on ``device``; a Python number is filled there, not copied from the host."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _set_row(buf: torch.Tensor, row: torch.Tensor, new: torch.Tensor, enabled: torch.Tensor) -> torch.Tensor:
    """``buf`` with row ``row`` (a (1,) int64 index) replaced by ``new`` where ``enabled``."""
    old = buf.index_select(0, row)
    return buf.index_copy(0, row, torch.where(enabled, new.to(buf.dtype).expand_as(old), old))


def insert_keyframe(
    m: MapState,
    frame_id: torch.Tensor | int,
    R: torch.Tensor,
    t: torch.Tensor,
    enabled: torch.Tensor | bool = True,
) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe pose into the sliding window's next ring slot.

    Returns (new map, slot).  The oldest slot is recycled on overflow and
    its observations cleared; with ``enabled`` false the map is unchanged
    and the slot is −1.
    """
    dev = m.kf_R.device
    enabled = _scalar(enabled, torch.bool, dev)
    slot = torch.remainder(m.kf_count, m.window)
    row = slot.reshape(1).to(torch.int64)
    fid = _scalar(frame_id, torch.int32, dev)
    return (
        m._replace(
            kf_R=_set_row(m.kf_R, row, R, enabled),
            kf_t=_set_row(m.kf_t, row, t, enabled),
            kf_id=_set_row(m.kf_id, row, fid, enabled),
            kf_valid=_set_row(m.kf_valid, row, torch.ones((), dtype=torch.bool, device=dev), enabled),
            obs_uv=_set_row(m.obs_uv, row, torch.zeros((), device=dev), enabled),
            obs_mask=_set_row(m.obs_mask, row, torch.zeros((), dtype=torch.bool, device=dev), enabled),
            kf_count=m.kf_count + enabled.to(torch.int32),
        ),
        torch.where(enabled, slot, -1).to(torch.int32),
    )


def insert_points(
    m: MapState, new_points: torch.Tensor, new_valid: torch.Tensor
) -> tuple[MapState, torch.Tensor]:
    """Append the valid ones of N new points in ring slots from ``point_count``.

    ``new_points``: (N, 3); ``new_valid``: (N,) bool.  Returns (new map,
    (N,) int32 slots, −1 where not valid).  As in the reference, the
    capacity must hold N points at once.
    """
    n, P = new_points.shape[0], m.capacity
    if n > P:
        raise ValueError(f"insert_points: {n} candidates exceed the map's capacity {P}")
    offsets = torch.cumsum(new_valid.to(torch.int32), dim=0) - 1
    counter = m.point_count + offsets  # the birth id of each valid entry
    slots = torch.remainder(counter, P)
    # The valid entries' slots are distinct (at most P of them, consecutive
    # mod P): one indexed write, with the invalid entries sent to a spare row.
    target = torch.where(new_valid, slots, P).to(torch.int64)

    def write(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([buf, buf[:1]])
        return ext.index_copy(0, target, vals.to(buf.dtype))[:P]

    written = write(torch.zeros_like(m.point_valid), new_valid)
    return (
        m._replace(
            points=write(m.points, new_points),
            point_valid=m.point_valid | written,
            point_birth=write(m.point_birth, counter),
            obs_mask=m.obs_mask & ~written[None, :],  # recycled slots lose their observations
            point_count=m.point_count + new_valid.sum(dtype=torch.int32),
        ),
        torch.where(new_valid, slots, -1).to(torch.int32),
    )


def add_observations(
    m: MapState,
    kf_slot: torch.Tensor | int,
    point_slots: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
) -> MapState:
    """Record pixel observations of ``point_slots`` in keyframe ``kf_slot``.

    Duplicate point slots keep the first valid observation; ``kf_slot < 0``
    is a no-op.
    """
    dev = m.obs_uv.device
    ks = _scalar(kf_slot, torch.int32, dev)
    row = torch.clamp(ks, 0, m.window - 1).reshape(1).to(torch.int64)
    ok = valid & (point_slots >= 0)
    first, written = row_select(point_slots, ok, m.capacity)
    new_uv = apply_row_select(first, written, uv)
    old_uv = m.obs_uv.index_select(0, row)[0]
    old_mask = m.obs_mask.index_select(0, row)[0]
    enabled = ks >= 0
    row_uv = torch.where(written[:, None] & enabled, new_uv, old_uv)
    row_mask = old_mask | (written & enabled)
    return m._replace(
        obs_uv=m.obs_uv.index_copy(0, row, row_uv[None]),
        obs_mask=m.obs_mask.index_copy(0, row, row_mask[None]),
    )


class AssocState(NamedTuple):
    """Cross-frame landmark association carried between chunks.

    Maps each keypoint slot of the last processed frame to the map point it
    re-observes (−1 = none).  ``kp_birth`` guards against ring recycling:
    an association holds only while the slot's ``point_birth`` matches.
    """

    kp_to_point: torch.Tensor  # (K,) int32 — map slot per keypoint, −1 none
    kp_birth: torch.Tensor  # (K,) int32 — allocation id guard
    prev_kf_slot: torch.Tensor  # () int32 — window slot of the last keyframe, −1
    prev_xy: torch.Tensor  # (K, 2) float32 — last frame's keypoint pixels


def empty_assoc(max_keypoints: int, device: torch.device | str = "cpu") -> AssocState:
    dev = torch.device(device)
    return AssocState(
        kp_to_point=torch.full((max_keypoints,), -1, dtype=torch.int32, device=dev),
        kp_birth=torch.full((max_keypoints,), -1, dtype=torch.int32, device=dev),
        prev_kf_slot=torch.full((), -1, dtype=torch.int32, device=dev),
        prev_xy=torch.zeros((max_keypoints, 2), device=dev),
    )


# ---------------------------------------------------------------------------
# Folding a chunk of frames into the map
# ---------------------------------------------------------------------------


def _rotate(X: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """``X @ Rᵀ`` for (..., N, 3) points and (..., 3, 3) matrices, summed in one fixed order.

    Both folds compute their gates with it, so the scan and the batched
    fold see the same bits on any device.
    """
    p = X[..., None, :] * R[..., None, :, :]  # (..., N, 3, 3)
    return p[..., 0] + p[..., 1] + p[..., 2]


def _gate(Xc: torch.Tensor, uv: torch.Tensor, K: torch.Tensor, gate_px: float, min_depth: float) -> torch.Tensor:
    """Camera-frame points in front of the camera whose projection lies within ``gate_px`` of ``uv``."""
    pix = _rotate(Xc, K)
    uv_pred = pix[..., :2] / torch.clamp_min(pix[..., 2:3], 1e-9)
    d = uv_pred - uv
    return (Xc[..., 2] > min_depth) & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] < gate_px * gate_px)


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without a host sync."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def update_map_chunk(
    m: MapState,
    assoc: AssocState,
    K: torch.Tensor,  # (3, 3) intrinsics (observation gating)
    frame_ids: torch.Tensor,  # (B,) int32
    kf_mask: torch.Tensor,  # (B,) bool — which frames become keyframes
    poses: torch.Tensor,  # (B, 4, 4) T_world_cam
    pose_ok: torch.Tensor,  # (B,) bool
    kps_xy: torch.Tensor,  # (B, K, 2)
    m_query: torch.Tensor,  # (B, M) match index into the previous frame's keypoints
    m_train: torch.Tensor,  # (B, M) match index into the current frame's keypoints
    m_valid: torch.Tensor,  # (B, M) bool
    points3d_cur: torch.Tensor,  # (B, M, 3) current-camera triangulations
    point_ok: torch.Tensor,  # (B, M) bool
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
) -> tuple[MapState, AssocState]:
    """Fold a chunk of frames into the map frame by frame (the oracle of the batched fold).

    Landmark identity is carried through every frame's match indices: a
    keypoint matched to one that carried a map point inherits the point, if
    the point still holds its allocation and projects within ``gate_px``.
    Keyframes insert their pose, their new triangulations and their
    observations; a new point also gets a second view in the previous
    keyframe when that projects within the gate.
    """
    k_cap = assoc.kp_to_point.shape[0]
    a = assoc
    for b in range(frame_ids.shape[0]):
        T_w, xy = poses[b], kps_xy[b]
        mv, ok_pt = m_valid[b], point_ok[b]
        enabled = kf_mask[b] & (pose_ok[b] | (m.kf_count == 0))
        qc = torch.clamp_min(m_query[b], 0).to(torch.int64)
        tc = torch.clamp_min(m_train[b], 0).to(torch.int64)
        uv_cur = xy[tc]
        R_w, C_w = T_w[:3, :3], T_w[:3, 3]
        R_cw = R_w.T

        # association through the previous frame's keypoints, reprojection-gated
        cand_slot = a.kp_to_point[qc]
        cs = torch.clamp_min(cand_slot, 0).to(torch.int64)
        alive = mv & (cand_slot >= 0) & (m.point_birth[cs] == a.kp_birth[qc]) & m.point_valid[cs]
        alive = alive & _gate(_rotate(m.points[cs] - C_w, R_cw), uv_cur, K, gate_px, min_cand_depth)
        assoc_slot = torch.where(alive, cand_slot, -1)

        # new landmarks: good triangulations with no association
        X_world = _rotate(points3d_cur[b], R_w) + C_w
        new_mask = ok_pt & (assoc_slot < 0) & enabled
        m, new_slots = insert_points(m, X_world, new_mask)
        pt_slot = torch.where(assoc_slot >= 0, assoc_slot, new_slots)

        # keyframe, its observations, and the previous keyframe's view of the new points
        t_cw = -_rotate(C_w[None], R_cw)[0]
        m, kf_slot = insert_keyframe(m, frame_ids[b], R_cw, t_cw, enabled)
        m = add_observations(m, torch.clamp_min(kf_slot, 0), pt_slot, uv_cur, (alive | new_mask) & enabled)
        uv_prev = a.prev_xy[qc]
        pks = torch.clamp_min(a.prev_kf_slot, 0)
        Xc_prev = _rotate(X_world, _row(m.kf_R, pks)) + _row(m.kf_t, pks)
        gate_p = _gate(Xc_prev, uv_prev, K, gate_px, min_cand_depth)
        m = add_observations(m, pks, new_slots, uv_prev, new_mask & (a.prev_kf_slot >= 0) & gate_p)

        # landmark identity of this frame's keypoints (slot and birth through one writer table)
        carry_ok = mv & (pt_slot >= 0) & (alive | new_mask)
        birth_of = m.point_birth[torch.clamp_min(pt_slot, 0).to(torch.int64)]
        written, (slot_row, birth_row) = _scatter_rows_multi(tc, carry_ok, [pt_slot, birth_of], k_cap)
        a = AssocState(
            kp_to_point=torch.where(written, slot_row, -1),
            kp_birth=torch.where(written, birth_row, -1),
            prev_kf_slot=torch.where(enabled, kf_slot, -1),
            prev_xy=xy,
        )
    return m, a


def update_map_chunk_batched(
    m: MapState,
    assoc: AssocState,
    K: torch.Tensor,
    frame_ids: torch.Tensor,
    kf_mask: torch.Tensor,
    poses: torch.Tensor,
    pose_ok: torch.Tensor,
    kps_xy: torch.Tensor,
    m_query: torch.Tensor,
    m_train: torch.Tensor,
    m_valid: torch.Tensor,
    points3d_cur: torch.Tensor,
    point_ok: torch.Tensor,
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
    obs_per_row: int = 1024,
    new_per_frame: int = 512,
) -> tuple[MapState, AssocState]:
    """Chunk-batched equivalent of :func:`update_map_chunk` (the default fold).

    The per-frame fold rebuilds observation rows and inserts points every
    frame, yet only the final state survives the chunk.  This one splits it:

    1. an **identity scan** over the frames carrying only per-keypoint
       landmark identity (slot, allocation id, world position) in (K,)
       tensors.  Liveness of a candidate is a closed form: allocations are
       sequential ring slots, so the slot of allocation ``b`` is recycled
       exactly when the counter passes ``b + P``;
    2. a **rebuild** of what survives: every new point of the chunk written
       to its ring slot in one indexed write, the keyframe rows from the
       last frame that took each slot, and each final observation row from
       one first-valid-writer table (its frame's own observations and the
       next frame's second views), with the columns recycled by later
       allocations cleared in closed form.

    Equal to the scan within its capacity rules: at most ``new_per_frame``
    new landmarks a frame (the excess is dropped here, so counters, slots
    and observations agree about which points exist), at most ``P`` a chunk,
    at most ``obs_per_row`` observations a keyframe row (the highest-index
    ones drop), and a window of at least 2.  No host sync.
    """
    B, M = m_query.shape
    P, W = m.capacity, m.window
    k_cap = assoc.kp_to_point.shape[0]
    if W < 2:
        raise ValueError("update_map_chunk_batched requires window >= 2")
    dev = m.points.device
    count0 = m.point_count
    ncap = min(new_per_frame, M)

    # ---- phase 1: identity scan --------------------------------------------
    kp2p, kpb = assoc.kp_to_point, assoc.kp_birth
    kppos = m.points[torch.clamp_min(kp2p, 0).to(torch.int64)]
    prev_xy, count, kfc = assoc.prev_xy, count0, m.kf_count
    ys = []
    for b in range(B):
        T_w, xy, mv = poses[b], kps_xy[b], m_valid[b]
        enabled = kf_mask[b] & (pose_ok[b] | (kfc == 0))
        qc = torch.clamp_min(m_query[b], 0).to(torch.int64)
        tc = torch.clamp_min(m_train[b], 0).to(torch.int64)
        uv_cur = xy[tc]
        cand_slot, cand_birth, cand_pos = kp2p[qc], kpb[qc], kppos[qc]
        # a pre-chunk candidate must hold its allocation in the initial map; any
        # candidate dies once the counter passes birth + P
        scg = torch.clamp_min(cand_slot, 0).to(torch.int64)
        init_ok = (m.point_birth[scg] == cand_birth) & m.point_valid[scg]
        live = torch.where(cand_birth < count0, init_ok, True) & (count <= cand_birth + P)
        R_w, C_w = T_w[:3, :3], T_w[:3, 3]
        gate = _gate(_rotate(cand_pos - C_w, R_w.T), uv_cur, K, gate_px, min_cand_depth)
        alive = mv & (cand_slot >= 0) & live & gate
        assoc_slot = torch.where(alive, cand_slot, -1)

        X_world = _rotate(points3d_cur[b], R_w) + C_w
        new_mask = point_ok[b] & (assoc_slot < 0) & enabled
        offs = torch.cumsum(new_mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
        new_mask = new_mask & (offs < ncap)  # the per-frame capacity
        alloc_id = count + offs
        new_slots = torch.where(new_mask, torch.remainder(alloc_id, P), -1)
        pt_slot = torch.where(assoc_slot >= 0, assoc_slot, new_slots)
        count2 = count + new_mask.sum(dtype=torch.int32)

        # The scan reads births and positions from the map after this frame's
        # inserts, so an alive association whose slot one of this frame's
        # allocations recycles inherits the new occupant's birth and position
        # (and dies at the next frame's check).  Replicated exactly.
        a_slot = count + torch.remainder(cand_slot - count, P)
        recycled_now = alive & (a_slot < count2)
        _, (new_pts,) = _compact_valid(new_mask, [X_world], ncap)  # by allocation offset
        occ_pos = new_pts[torch.clamp(a_slot - count, 0, ncap - 1).to(torch.int64)]
        carry_ok = mv & (pt_slot >= 0) & (alive | new_mask)
        birth_val = torch.where(alive, torch.where(recycled_now, a_slot, cand_birth), alloc_id)
        pos_val = torch.where(alive[:, None], torch.where(recycled_now[:, None], occ_pos, cand_pos), X_world)
        written_k, (srow, brow, prow) = _scatter_rows_multi(tc, carry_ok, [pt_slot, birth_val, pos_val], k_cap)
        kp2p = torch.where(written_k, srow, -1)
        kpb = torch.where(written_k, brow, -1)
        kppos = torch.where(written_k[:, None], prow, 0.0)
        kf_slot = torch.where(enabled, torch.remainder(kfc, W), -1)
        ys.append((enabled, kf_slot, count, pt_slot, (alive | new_mask) & enabled, new_mask, X_world,
                   uv_cur, prev_xy[qc]))
        prev_xy, count, kfc = xy, count2, kfc + enabled.to(torch.int32)
    enabled_B, kf_slot_B, count_start_B, pt_slot_B, obs_ok_B, new_mask_B, X_world_B, uv_cur_B, uv_prev_B = (
        torch.stack(parts) for parts in zip(*ys)
    )
    count_final, kfc_final = count, kfc
    count_after_B = count_start_B + new_mask_B.sum(dim=1, dtype=torch.int32)
    alloc_B = count_start_B[:, None] + torch.cumsum(new_mask_B.to(torch.int32), dim=1, dtype=torch.int32) - 1
    new_slots_B = torch.where(new_mask_B, torch.remainder(alloc_B, P), -1)

    # ---- phase 2a: the chunk's new points in their ring slots, one write ----
    # Allocation ids are consecutive, so the first P of the chunk land on
    # distinct slots; invalid entries go to a spare row.
    take = new_mask_B & (alloc_B - count0 < min(B * ncap, P))
    target = torch.where(take, torch.remainder(alloc_B, P), P).reshape(-1).to(torch.int64)

    def write(buf: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([buf, buf[:1]])
        return ext.index_copy(0, target, vals.reshape(-1, *buf.shape[1:]).to(buf.dtype))[:P]

    points_f = write(m.points, X_world_B)
    birth_f = write(m.point_birth, alloc_B)
    point_valid_f = m.point_valid | write(torch.zeros_like(m.point_valid), take)

    # ---- phase 2b: keyframe rows, from the last frame that took each slot ----
    f_idx = torch.arange(B, dtype=torch.int32, device=dev)
    hits = (kf_slot_B[None, :] == torch.arange(W, dtype=torch.int32, device=dev)[:, None]) & enabled_B[None, :]
    fw = torch.where(hits, f_idx[None, :], -1).amax(dim=1)  # (W,)
    in_chunk = fw >= 0
    fwc = torch.clamp_min(fw, 0).to(torch.int64)
    T_rows = poses[fwc]
    R_cw_rows = T_rows[:, :3, :3].transpose(-1, -2)
    t_cw_rows = -_rotate(T_rows[:, None, :3, 3], R_cw_rows)[:, 0]
    kf_R_f = torch.where(in_chunk[:, None, None], R_cw_rows, m.kf_R)
    kf_t_f = torch.where(in_chunk[:, None], t_cw_rows, m.kf_t)
    kf_id_f = torch.where(in_chunk, frame_ids[fwc].to(torch.int32), m.kf_id)
    kf_valid_f = m.kf_valid | in_chunk

    # ---- phase 2c: observation rows -----------------------------------------
    col = torch.arange(P, dtype=torch.int32, device=dev)

    def cleared_from(start: torch.Tensor) -> torch.Tensor:
        # column c is recycled iff an allocation in [start, count_final) lands
        # on it: the first at or after start is start + ((c - start) mod P)
        return start[..., None] + torch.remainder(col - start[..., None], P) < count_final

    # frame 0's second views go to the carried previous keyframe row (its
    # pre-chunk pose); they survive only if the chunk does not reinsert it
    r0 = assoc.prev_kf_slot
    r0c = torch.clamp_min(r0, 0)
    Xc0 = _rotate(X_world_B[0], _row(m.kf_R, r0c)) + _row(m.kf_t, r0c)
    sec0_ok = new_mask_B[0] & (r0 >= 0) & _gate(Xc0, uv_prev_B[0], K, gate_px, min_cand_depth)
    sec0_written, (sec0_uv,) = _scatter_rows_multi(new_slots_B[0], sec0_ok, [uv_prev_B[0]], P)

    # each chunk row w: its frame's own observations, and the second views of
    # the next frame's new points (the only frame whose previous keyframe is w)
    f2 = fw + 1
    has2 = in_chunk & (f2 < B)
    f2c = torch.clamp(f2, 0, B - 1).to(torch.int64)
    Xc2 = _rotate(X_world_B[f2c], R_cw_rows) + t_cw_rows[:, None, :]
    sec_ok = new_mask_B[f2c] & has2[:, None] & _gate(Xc2, uv_prev_B[f2c], K, gate_px, min_cand_depth)
    # second views first: in the scan a later add_observations overwrites earlier columns
    slots_c = torch.cat([new_slots_B[f2c], pt_slot_B[fwc]], dim=1)  # (W, 2M)
    uv_c = torch.cat([uv_prev_B[f2c], uv_cur_B[fwc]], dim=1)
    ok_c = torch.cat([sec_ok, obs_ok_B[fwc] & in_chunk[:, None]], dim=1)
    is_sec = (torch.arange(2 * M, device=dev) < M).expand(W, 2 * M)
    cv, (cs, cuv, csec) = _compact_valid(ok_c, [slots_c, uv_c, is_sec], obs_per_row)
    row_written, (uv_rows, sec_rows) = _scatter_rows_multi(cs, cv, [cuv, csec], P)
    mask_in = row_written & (sec_rows | ~cleared_from(count_after_B[fwc]))
    # a pre-chunk row keeps its content minus recycled columns, plus frame 0's second views
    add0 = sec0_written[None, :] & ((torch.arange(W, device=dev) == r0) & ~in_chunk)[:, None]
    mask_pre = (m.obs_mask & ~cleared_from(count0)[None, :]) | add0
    uv_pre = torch.where(add0[..., None], sec0_uv[None], m.obs_uv)
    obs_mask_f = torch.where(in_chunk[:, None], mask_in, mask_pre)
    obs_uv_f = torch.where(in_chunk[:, None, None], uv_rows, uv_pre)

    m_out = MapState(
        kf_R=kf_R_f, kf_t=kf_t_f, kf_id=kf_id_f, kf_valid=kf_valid_f,
        points=points_f, point_valid=point_valid_f, point_birth=birth_f,
        obs_uv=obs_uv_f, obs_mask=obs_mask_f,
        kf_count=kfc_final, point_count=count_final,
    )
    a_out = AssocState(
        kp_to_point=kp2p,
        kp_birth=kpb,
        prev_kf_slot=torch.where(enabled_B[B - 1], kf_slot_B[B - 1], -1),
        prev_xy=prev_xy,
    )
    return m_out, a_out
