"""PnP tracking against the persistent map (port of ``tpuslam/model/tracking.py``).

Each frame is tracked *absolutely* against the metric map the pipeline
builds: the landmarks it re-observes, chained through the match indices of
consecutive frames, give 3D↔2D correspondences, and the pose comes from
``motion_pnp`` seeded by the two-view pose at map-anchored scale, with
``ransac_pnp`` as the fallback where that descent fails its gates.  Then
the frame becomes a keyframe, its new triangulations become map points,
and the landmark association is carried to the next frame.

The frame-parallel two-view stage runs batched before this; the loop here
is sequential over the chunk's frames.  The reference's two ``lax.cond``
branches (the RANSAC fallback, and with ``freeze_map`` the projection
refresh) run only on the frames that need them: their predicates are read
on the host, one sync a frame for each.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from tpuslam_torch.backend.map import (
    AssocState,
    MapState,
    _row,
    add_observations,
    apply_row_select,
    insert_keyframe,
    insert_points,
    row_select,
)
from tpuslam_torch.backend.pnp import motion_pnp, ransac_pnp
from tpuslam_torch.model.slam import _nanmedian

# (frame position in the chunk, (M,) bool valid correspondences) → (H, 6) RANSAC sample indices
SampleFn = Callable[[int, torch.Tensor], torch.Tensor]


class TrackChunkResult(NamedTuple):
    poses: torch.Tensor  # (B, 4, 4) T_world_cam
    pnp_ok: torch.Tensor  # (B,) bool — PnP produced this frame's pose
    num_pnp_inliers: torch.Tensor  # (B,) int32
    scale: torch.Tensor  # (B,) float32 — metric baseline applied to the pair
    num_assoc: torch.Tensor  # (B,) int32 — live landmark associations fed to PnP
    used_ransac: torch.Tensor  # (B,) bool — the RANSAC fallback ran
    point_count0: torch.Tensor  # (B,) int32 — map point_count before each frame's inserts
    kp_to_point: torch.Tensor  # (B, K) int32 — per-frame landmark association
    kp_birth: torch.Tensor  # (B, K) int32 — allocation guard of kp_to_point


def _pose_from_rt(R_cw: torch.Tensor, t_cw: torch.Tensor) -> torch.Tensor:
    """[R|t] world→cam → 4×4 T_world_cam."""
    R_wc = R_cw.transpose(-1, -2)
    top = torch.cat([R_wc, -(R_wc @ t_cw[..., :, None])], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _project(Xc: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    pix = Xc @ K.T
    return pix[:, :2] / torch.clamp_min(pix[:, 2:3], 1e-9)


def project_associate(
    m: MapState,
    T_prev: torch.Tensor,  # (4, 4) T_world_cam of the previous frame
    K: torch.Tensor,
    uv_cur: torch.Tensor,  # (M, 2) matched pixels of the current frame
    m_valid: torch.Tensor,  # (M,) bool
    min_cand_depth: float,
    radius_px: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Projection refresh against a frozen map → ((M,) int32 map slot or −1, (M,) found).

    Every valid landmark in front of the previous camera is projected with
    its pose; each match takes the nearest projection within ``radius_px``.
    """
    R_cw = T_prev[:3, :3].T
    Xc = m.points @ R_cw.T - R_cw @ T_prev[:3, 3]
    pix = Xc @ K.T
    uvp = pix[:, :2] / torch.clamp_min(pix[:, 2:3], 1e-9)
    proj_ok = m.point_valid & (Xc[:, 2] > min_cand_depth)
    d2 = (uv_cur**2).sum(dim=1)[:, None] + (uvp**2).sum(dim=1)[None, :] - 2.0 * (uv_cur @ uvp.T)
    d2 = torch.where(proj_ok[None, :], d2, torch.inf)
    nearest = torch.argmin(d2, dim=1)
    nd2 = torch.gather(d2, 1, nearest[:, None])[:, 0]
    found = m_valid & (nd2 < radius_px * radius_px)
    return torch.where(found, nearest.to(torch.int32), -1), found


def pnp_track_chunk(
    m: MapState,
    assoc: AssocState,
    K: torch.Tensor,  # (3, 3)
    T_prev0: torch.Tensor,  # (4, 4) pose of the frame before the chunk
    frame_ids: Sequence[int],  # (B,) global frame indices
    frame_valid: torch.Tensor,  # (B,) bool
    samples: SampleFn,  # RANSAC sample indices of frame b, asked only where the fallback runs
    R_rel: torch.Tensor,  # (B, 3, 3) two-view [R|t]: x_cur = R x_prev + t
    t_rel: torch.Tensor,  # (B, 3) unit-baseline translation
    vo_ok: torch.Tensor,  # (B,) bool — two-view estimate succeeded
    kps_xy: torch.Tensor,  # (B, K, 2)
    m_query: torch.Tensor,  # (B, M) match index into the previous frame's keypoints
    m_train: torch.Tensor,  # (B, M) match index into the current frame's keypoints
    m_valid: torch.Tensor,  # (B, M) bool
    X_cur_unit: torch.Tensor,  # (B, M, 3) unit-baseline triangulation, current camera
    z_prev_unit: torch.Tensor,  # (B, M) unit-baseline depth in the previous camera
    point_ok: torch.Tensor,  # (B, M) bool
    *,
    pnp_hypotheses: int = 64,
    pnp_min_inliers: int = 12,
    pnp_min_inlier_frac: float = 0.4,
    pnp_min_coverage: float = 0.4,
    gate_px: float = 8.0,
    min_cand_depth: float = 0.2,
    gn_iters: int = 4,
    freeze_map: bool = False,
    loc_assoc_radius_px: float = 48.0,
) -> tuple[TrackChunkResult, MapState, AssocState, torch.Tensor]:
    """Track a chunk of frames against the map → ``(result, map, assoc, T_last)``.

    Every valid frame whose pose is known becomes a keyframe.  With
    ``freeze_map`` the map is an immutable reference (localization): no
    inserts, the association chains through re-observations, and where it
    covers too few matches it is refreshed by projecting every landmark
    with the previous pose and taking the nearest within
    ``loc_assoc_radius_px``.
    """
    dev = K.device
    k_cap = assoc.kp_to_point.shape[0]
    schedule = (16.0, 8.0, 4.0, 2.0)[: gn_iters - 1] + (2.0,)
    neg1 = torch.full((), -1, dtype=torch.int32, device=dev)
    outs = []
    T_prev = T_prev0
    for b, fid in enumerate(frame_ids):
        fv, Rr, tr, vok = frame_valid[b], R_rel[b], t_rel[b], vo_ok[b]
        xy, mv, zp_u, ok_pt = kps_xy[b], m_valid[b], z_prev_unit[b], point_ok[b]
        qc = torch.clamp_min(m_query[b], 0).to(torch.int64)
        tc = torch.clamp_min(m_train[b], 0).to(torch.int64)
        uv_cur = xy[tc]

        # --- landmark association through the previous frame's keypoints
        cand_slot = assoc.kp_to_point[qc]
        cand_birth = assoc.kp_birth[qc]
        cs = torch.clamp_min(cand_slot, 0).to(torch.int64)
        alive = mv & (cand_slot >= 0) & (m.point_birth[cs] == cand_birth) & m.point_valid[cs]
        if freeze_map:
            n_match_f = mv.sum(dtype=torch.int32).float()
            need_refresh = alive.sum(dtype=torch.int32).float() < (
                pnp_min_coverage * torch.clamp_min(n_match_f, 1.0)
            )
            if bool(need_refresh):
                cand_slot, alive = project_associate(
                    m, T_prev, K, uv_cur, mv, min_cand_depth, loc_assoc_radius_px
                )
            else:
                cand_slot = torch.where(alive, cand_slot, -1)
            cs = torch.clamp_min(cand_slot, 0).to(torch.int64)
        X_map = m.points[cs]  # (M, 3) world

        # --- fallback and seed: the two-view pose at map-anchored scale
        R_cw_p = T_prev[:3, :3].T
        t_cw_p = -R_cw_p @ T_prev[:3, 3]
        z_map_prev = (X_map @ R_cw_p.T + t_cw_p)[:, 2]
        r_ok = alive & ok_pt & (zp_u > 1e-3) & (z_map_prev > 1e-3)
        ratio = torch.where(r_ok, z_map_prev / torch.clamp_min(zp_u, 1e-9), torch.nan)
        s_fb = torch.clamp(torch.nan_to_num(_nanmedian(ratio), nan=1.0), 0.05, 20.0)
        s_fb = torch.where(r_ok.sum() >= 5, s_fb, 1.0)
        T_fb = T_prev @ _pose_from_rt(Rr, tr * s_fb)

        # --- absolute pose: motion-model descent, RANSAC where it fails its gates
        T_seed = torch.where(vok & fv, T_fb, T_prev)
        R_cw_s = T_seed[:3, :3].T
        gn = motion_pnp(
            K, R_cw_s, -R_cw_s @ T_seed[:3, 3], X_map, uv_cur, alive,
            iters=gn_iters, min_inliers=pnp_min_inliers, huber_schedule=schedule,
        )
        n_alive = alive.sum(dtype=torch.int32).float()
        n_match = torch.clamp_min(mv.sum(dtype=torch.int32), 1).float()
        cov_ok = n_alive >= pnp_min_coverage * n_match

        def frac_gate(n_inl: torch.Tensor) -> torch.Tensor:
            return n_inl.float() >= pnp_min_inlier_frac * n_alive

        gn_ok = gn.success & frac_gate(gn.num_inliers) & cov_ok & fv
        need_ransac = fv & cov_ok & ~gn_ok
        if bool(need_ransac):
            p = ransac_pnp(
                X_map, uv_cur, alive, K, samples(b, alive),
                num_hypotheses=pnp_hypotheses, min_inliers=pnp_min_inliers,
                solver_sweeps=8, hyp_sweeps=6, lo_rounds=1, refine="gn",
            )
        else:
            p = gn
        pnp_ok = p.success & frac_gate(p.num_inliers) & cov_ok & fv
        T_cur = torch.where(pnp_ok, _pose_from_rt(p.R, p.t), torch.where(vok & fv, T_fb, T_prev))
        # the camera-centre distance: ‖(T_prev⁻¹ T_cur)[:3, 3]‖
        s_used = torch.linalg.vector_norm(T_cur[:3, 3] - T_prev[:3, 3])

        # --- map update
        enabled = fv & (pnp_ok | vok | (m.kf_count == 0))
        R_cw_c = T_cur[:3, :3].T
        Xc_cand = (X_map - T_cur[:3, 3][None, :]) @ R_cw_c.T
        uv_pred = _project(Xc_cand, K)
        gate = (Xc_cand[:, 2] > min_cand_depth) & (
            ((uv_pred - uv_cur) ** 2).sum(dim=-1) < gate_px * gate_px
        )
        obs_alive = alive & gate
        assoc_slot = torch.where(obs_alive, cand_slot, -1)

        point_count0 = m.point_count
        if freeze_map:
            new_mask = torch.zeros_like(mv)
            pt_slot = assoc_slot
            kf_slot = neg1
        else:
            X_world = (X_cur_unit[b] * s_used) @ T_cur[:3, :3].T + T_cur[:3, 3][None, :]
            new_mask = ok_pt & (assoc_slot < 0) & enabled
            m, new_slots = insert_points(m, X_world, new_mask)
            pt_slot = torch.where(assoc_slot >= 0, assoc_slot, new_slots)
            m, kf_slot = insert_keyframe(m, fid, R_cw_c, -R_cw_c @ T_cur[:3, 3], enabled)
            m = add_observations(
                m, torch.clamp_min(kf_slot, 0), pt_slot, uv_cur, (obs_alive | new_mask) & enabled
            )
            # the previous keyframe's view of the brand-new points
            uv_prev = assoc.prev_xy[qc]
            pks = torch.clamp_min(assoc.prev_kf_slot, 0)
            Xc_prev = X_world @ _row(m.kf_R, pks).T + _row(m.kf_t, pks)[None, :]
            gate_p = (Xc_prev[:, 2] > min_cand_depth) & (
                ((_project(Xc_prev, K) - uv_prev) ** 2).sum(dim=-1) < gate_px * gate_px
            )
            m = add_observations(
                m, pks, new_slots, uv_prev, new_mask & (assoc.prev_kf_slot >= 0) & gate_p
            )

        # --- carry landmark identity to this frame's keypoints
        carry_ok = mv & (pt_slot >= 0) & (obs_alive | new_mask)
        birth_of = m.point_birth[torch.clamp_min(pt_slot, 0).to(torch.int64)]
        first, written = row_select(tc, carry_ok, k_cap)
        payload = apply_row_select(first, written, torch.stack([pt_slot, birth_of], dim=1))
        assoc = AssocState(
            kp_to_point=torch.where(written, payload[:, 0], -1),
            kp_birth=torch.where(written, payload[:, 1], -1),
            prev_kf_slot=torch.where(enabled, kf_slot, neg1),
            prev_xy=xy,
        )
        outs.append((T_cur, pnp_ok, p.num_inliers, s_used, alive.sum(dtype=torch.int32),
                     need_ransac, point_count0, assoc.kp_to_point, assoc.kp_birth))
        T_prev = T_cur

    result = TrackChunkResult(*(torch.stack(parts) for parts in zip(*outs)))
    return result, m, assoc, T_prev
