"""Fixed-shape world map: keyframe poses, 3D points and their observations.

Port of ``tpuslam/backend/map.py`` (``row_select``, ``apply_row_select``,
``MapState``, ``empty_map``, ``insert_keyframe``, ``insert_points``,
``add_observations``, ``AssocState``, ``empty_assoc``).  The map is an
immutable tuple of capacity-bounded tensors: every function returns new
tensors and leaves its inputs as they were.  Observations are a dense
(W keyframes × P points) grid with a mask.

The reference builds its scatters from one-hot equality tables and a
roll/blit because a scatter is slow on a TPU.  Here the same semantics are
an index reduction, a gather and an indexed write:

* on duplicate target rows the *first valid* writer wins — an
  ``amin``-reduction of the writers' positions picks it, since an indexed
  write with repeated indices picks an unspecified writer on the card;
* integer payloads stay exact (a gather, no float product);
* point slots are a ring allocated from ``point_count``, and a recycled
  slot loses its observations;
* a disabled keyframe insert is a no-op that returns slot −1.

Counters and slots stay on the map's device, so no call syncs with the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def row_select(
    slots: torch.Tensor,  # (M,) target rows (may repeat; out of range = dropped)
    valid: torch.Tensor,  # (M,) bool
    out_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Writer of each target row: ``(first (out_rows,) int64, written (out_rows,) bool)``.

    ``first[r]`` is the position of the first valid entry whose slot is r
    (0 where no entry writes r, as the reference's argmax of an empty row).
    """
    M = slots.shape[0]
    slots = slots.to(torch.int64)
    take = valid & (slots >= 0) & (slots < out_rows)
    target = torch.where(take, slots, out_rows)  # row out_rows collects the dropped
    pos = torch.arange(M, device=slots.device)
    first = torch.full((out_rows + 1,), M, dtype=torch.int64, device=slots.device)
    first = first.scatter_reduce(0, target, pos, "amin", include_self=True)[:out_rows]
    written = first < M
    return torch.where(written, first, 0), written


def apply_row_select(
    first: torch.Tensor,  # (out_rows,) int64 from row_select
    written: torch.Tensor,  # (out_rows,) bool from row_select
    values: torch.Tensor,  # (M, D) or (M,) payload
) -> torch.Tensor:
    """Each target row's payload from its writer; rows no entry writes are 0."""
    rows = values[first]
    w = written.reshape(written.shape + (1,) * (values.ndim - 1))
    return torch.where(w, rows, torch.zeros((), dtype=values.dtype, device=values.device))


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
