"""SlamSystem: tracking, the chunk map fold, loop closure, bundle adjustment, the pose graph.

Port of ``tpuslam/model/system.py`` (``run_sequence``), for both tracking
modes:

* **tracking** — ``SlamPipeline`` (``model/slam.py``) with its features,
  matches and triangulations, in ``vo`` or ``pnp`` mode;
* **relocalization** — frames that lost tracking query the keyframe
  database by BoW and, when verified, snap to an absolute pose anchored at
  the matched keyframe (``backend/loop_closure.py``); the correction of the
  last snap carries to the chunk's later frames and its chain pose, and in
  PnP mode to the landmarks and keyframe rows the corrected frames inserted;
* **map** — in VO mode each chunk folds into the sliding keyframe window
  (``update_map_chunk_batched``, or the per-frame ``update_map_chunk``); in
  PnP mode the tracker builds the map itself, frame by frame;
* **loop closure** — BoW detection against the keyframe database, PnP
  verification, and the chunk's keyframes inserted; in VO mode the database
  stores each keypoint's pair triangulation, in PnP mode its map landmark
  in the keyframe's camera frame;
* **backend** — windowed bundle adjustment (``backend/ba.py``) once the
  keyframes since the last run reach ``ba_interval``; each run's window is
  folded into the trajectory on the host at the end, and in PnP mode the
  optimised window is also the map the next chunk tracks against;
* **pose graph** — with at least one verified loop, the keyframes and their
  loop edges are optimised (``backend/pose_graph.py``, on the system's
  device) and every frame inherits its keyframe's correction.

``run_sequence`` is a host loop over chunks, as ``process_sequence`` is.
The reference's ``lax.cond`` branches become host reads once a chunk: whether a
frame needs relocalization, and (in ``LoopClosure``) the ring's overflow
flag with the candidate mask.  Random draws depend only on (seed, global
frame index), in four streams: the two-view ranks, the tracker's
RANSAC-PnP samples, loop verification's and relocalization's.
``draw_fn``, ``pnp_draw_fn``, ``lc_draw_fn(frame_idx, valid) -> (H, 6)``
and ``reloc_draw_fn(frame_idx, pnp_valid, n_valid) -> ((H, 6), (1024, 5))``
may supply them (a test passes the reference package's).

Not in this port yet (``ROADMAP.md`` Queue 1): the streaming ``run()``,
``warm_start``, ``checkpoint_template`` and ``localization_only``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from typing import Callable

from tpuslam_torch.backend.ba import bundle_adjust
from tpuslam_torch.backend.loop_closure import RELOC_HYPOTHESES, LoopClosure, LoopResult, _rigid_inverse
from tpuslam_torch.backend.map import (
    MapState,
    _row,
    empty_assoc,
    empty_map,
    scatter_rows_dense,
    update_map_chunk,
    update_map_chunk_batched,
)
from tpuslam_torch.backend.pnp import gumbel_sample_indices, gumbel_top_indices
from tpuslam_torch.backend.pose_graph import add_edge, graph_from_trajectory, optimize_pose_graph
from tpuslam_torch.backend.vocabulary import Vocabulary
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import DrawFn, PnpDrawFn, SlamPipeline, _stream_seed

STREAMING_ITEM = "ROADMAP.md Queue 1 item 3.2 (the streaming SlamSystem.run())"
LOCALIZATION_ITEM = "ROADMAP.md Queue 1 item 4 (resume and localization)"
_LC_STREAM = 0xC2B2AE3D27D4EB4F  # xor-ed into the seed of loop verification's draws
_RELOC_STREAM = 0x165667B19E3779F9  # and of relocalization's
LcDrawFn = Callable[[int, torch.Tensor], torch.Tensor]
RelocDrawFn = Callable[[int, torch.Tensor, int], tuple]


def _map_points_per_keypoint(kps_valid, m_train, point_ok, points3d):
    """Each frame's triangulations on its keypoint slots → (mp (B, K, 3), mp_valid (B, K)), batched."""
    return scatter_rows_dense(points3d, m_train, point_ok, kps_valid.shape[-1])




@dataclass
class SlamSystem:
    camera: Camera
    config: SlamConfig
    vocabulary: object | None = None
    # "pnp" tracks each frame against the map BA optimises; every valid
    # tracked frame is then a keyframe, so keyframe_interval is VO's alone
    tracking: str = "vo"
    keyframe_interval: int = 1
    ba_window: int = 8
    ba_interval: int = 4
    ba_iterations: int = 4
    ba_active_points: int = 512  # observed points gathered into BA's dense block
    ba_rtol: float = 0.0  # > 0: LM stops early (one host read a step)
    max_map_points: int = 4096
    enable_loop_closure: bool = True  # with a vocabulary
    enable_ba: bool = True
    enable_pose_graph: bool = True
    use_batched_map: bool = True  # VO's fold: the batched one, else the per-frame scan
    # lost frames query the keyframe database; at most reloc_budget of them verify a chunk
    enable_relocalization: bool = True
    reloc_budget: int = 2
    localization_only: bool = False  # not ported yet (raises)
    device: torch.device | str = "cuda"
    draw_fn: DrawFn | None = None
    pnp_draw_fn: PnpDrawFn | None = None
    lc_draw_fn: LcDrawFn | None = None
    reloc_draw_fn: RelocDrawFn | None = None

    def __post_init__(self) -> None:
        if self.tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {self.tracking!r}")
        if self.localization_only:
            raise NotImplementedError(f"localization_only is not ported yet: {LOCALIZATION_ITEM}")
        self.device = torch.device(self.device)
        self.pipeline = SlamPipeline(
            self.camera,
            self.config,
            tracking=self.tracking,
            device=self.device,
            draw_fn=self.draw_fn,
            with_features=True,
            map_window=self.ba_window,
            max_map_points=self.max_map_points,
            pnp_draw_fn=self.pnp_draw_fn,
        )
        self._K = self.pipeline.K
        self.loop_closure = None
        if self.enable_loop_closure and self.vocabulary is not None:
            vocab = self.vocabulary
            if not isinstance(vocab, Vocabulary):
                vocab = Vocabulary.load(vocab, device=self.device)
            self.loop_closure = LoopClosure(vocab, self.config.loop_closure, self.config.matcher, self.device)

    # --- backend stages ----------------------------------------------------------
    def _bundle_adjust(self, m: MapState):
        return bundle_adjust(
            m, self._K, iterations=self.ba_iterations,
            active_points=self.ba_active_points, rtol=self.ba_rtol,
        )

    def _ba_cond(self, m: MapState, since_ba: torch.Tensor):
        """BA once ``since_ba`` reaches the interval → (map, initial_cost, final_cost, ran).

        When the interval is at most the keyframes a chunk inserts, BA is due
        every chunk anyway: it runs unconditionally and the result is
        selected on the card by ``due``.  A sparser schedule reads ``due`` on
        the host once a chunk and skips the chunks that are not due.
        """
        due = since_ba >= self.ba_interval
        kf_per_chunk = self.config.batch_size
        if self.tracking != "pnp":
            kf_per_chunk = max(self.config.batch_size // max(self.keyframe_interval, 1), 1)
        if self.ba_interval <= kf_per_chunk:
            ba = self._bundle_adjust(m)
            m2 = MapState(*(torch.where(due, new, old) for new, old in zip(ba.map, m)))
            return m2, torch.where(due, ba.initial_cost, 0.0), torch.where(due, ba.final_cost, 0.0), due
        if bool(due):
            ba = self._bundle_adjust(m)
            return ba.map, ba.initial_cost, ba.final_cost, due
        zero = torch.zeros((), device=self.device)
        return m, zero, zero, due

    @staticmethod
    def _refreshed_pose(m: MapState, ran: torch.Tensor, fallback_pose: torch.Tensor) -> torch.Tensor:
        """T_world_cam of the newest keyframe in the (BA-optimised) window, where BA ran."""
        slot = torch.remainder(m.kf_count - 1, m.window)
        R_cw = _row(m.kf_R, slot)
        C = -torch.einsum("ji,j->i", R_cw, _row(m.kf_t, slot))
        top = torch.cat([R_cw.T, C[:, None]], dim=1)
        T_opt = torch.cat([top, torch.eye(4, device=R_cw.device)[3:]], dim=0)
        return torch.where(ran & _row(m.kf_valid, slot), T_opt, fallback_pose)

    # --- draws of the loop-closure streams ------------------------------------------
    def _lc_sampler(self, fids: list[int], seed: int):
        """Loop verification's RANSAC-PnP samples: (V, H, 6) for the chunk positions given."""

        def sampler(positions, valid, H):
            out = []
            for i, p in enumerate(positions):
                if self.lc_draw_fn is not None:
                    out.append(torch.as_tensor(self.lc_draw_fn(fids[p], valid[i]), device=self.device))
                else:
                    gen = self.pipeline._generator
                    gen.manual_seed(_stream_seed(seed, fids[p], _LC_STREAM))
                    out.append(gumbel_sample_indices(valid[i], H, 6, gen))
            return torch.stack(out).to(torch.int64)

        return sampler

    def _reloc_draws(self, fids: list[int], need: list[bool], seed: int):
        """Relocalization's draws for the frames ``sel`` (a device tensor): RANSAC-PnP samples and
        five-point ranks.  By default each needy frame's uniforms are drawn up front, so picking the
        ``sel`` rows needs no host read; ``reloc_draw_fn`` reads ``sel`` on the host."""
        if self.reloc_draw_fn is not None:

            def hooked(sel, pnp_valid, n_valid, H):
                pairs = [self.reloc_draw_fn(fids[b], pnp_valid[i], int(n_valid[i])) for i, b in enumerate(sel.tolist())]
                return tuple(torch.stack([torch.as_tensor(p[k], device=self.device) for p in pairs]).to(torch.int64)
                             for k in (0, 1))

            return hooked
        K = self.config.detector.max_keypoints
        H = self.loop_closure.verify_hypotheses
        B = len(fids)
        u_pnp = torch.zeros((B, H, K), device=self.device)
        u_rank = torch.zeros((B, RELOC_HYPOTHESES, 5), device=self.device)
        gen = self.pipeline._generator
        for b in range(B):
            if need[b]:
                gen.manual_seed(_stream_seed(seed, fids[b], _RELOC_STREAM))
                u_pnp[b] = torch.rand((H, K), generator=gen, device=self.device)
                u_rank[b] = torch.rand((RELOC_HYPOTHESES, 5), generator=gen, device=self.device)

        def draws(sel, pnp_valid, n_valid, H_):
            samples = gumbel_top_indices(u_pnp[sel], pnp_valid, 6)
            n = torch.clamp_min(n_valid, 1).to(torch.float32)[:, None, None]
            ranks = torch.minimum(torch.floor(u_rank[sel] * n), n - 1).to(torch.int64)
            return samples, ranks

        return draws

    # --- loop closure and relocalization stages ------------------------------------
    def _lc_chunk(self, db, fids_d, fids: list[int], kf_enabled, result, seed: int, m=None, bow=None):
        """Detect loops of the chunk's keyframes and insert them → (db', LoopResult (B,))."""
        if m is not None and result.pnp_kp_to_point is not None:
            # PnP mode: each keypoint's map landmark in the keyframe's camera frame
            slot = torch.clamp_min(result.pnp_kp_to_point, 0).to(torch.int64)  # (B, K)
            okp = ((result.pnp_kp_to_point >= 0) & (m.point_birth[slot] == result.pnp_kp_birth)
                   & m.point_valid[slot] & result.kps_valid)
            X = m.points[slot]  # (B, K, 3) world
            R_cw = result.poses[:, :3, :3].transpose(-1, -2)
            C = result.poses[:, :3, 3]
            Xc = torch.einsum("bij,bkj->bki", R_cw, X - C[:, None, :])
            mp = torch.where(okp[..., None], Xc, 0.0)
            mpv = okp
        else:
            mp, mpv = _map_points_per_keypoint(result.kps_valid, result.m_train, result.point_ok, result.points3d)
        return self.loop_closure._process_chunk_impl(
            db, fids_d, kf_enabled, result.desc, result.kps_xy, result.kps_valid, mp, mpv, self._K,
            self._lc_sampler(fids, seed), poses=result.poses, bow=bow,
        )

    def _relocalize(self, db, result, need, fids: list[int], need_host: list[bool], seed: int, bow):
        """(r_ok (B,), Msnap (B, 4, 4)): each rescued frame's correction T_reloc · T_f⁻¹."""
        r_ok, T_reloc, _, _ = self.loop_closure._relocalize_impl(
            db, need, result.desc, result.kps_xy, result.kps_valid, self._K,
            self._reloc_draws(fids, need_host, seed), budget=self.reloc_budget, bow=bow,
        )
        return r_ok, T_reloc @ _rigid_inverse(result.poses)

    def _reloc_chunk(self, db, result, valid, fids_d, fids: list[int], seed: int, bow=None):
        """Relocalize lost frames of a VO chunk → (result', M_last, r_ok).

        One host read of ``need``; without a needy frame nothing else runs.
        A snap at frame i overrides every earlier correction, so the
        correction of each frame is the last snap at or before it.
        """
        B = result.poses.shape[0]
        need = valid & ~result.pose_ok & (fids_d > 0)
        need_host = need.cpu().tolist()
        eye = torch.eye(4, device=self.device)
        if not any(need_host):
            return result, eye, torch.zeros(B, dtype=torch.bool, device=self.device)
        r_ok, Msnap = self._relocalize(db, result, need, fids, need_host, seed, bow)
        tri = torch.arange(B, device=self.device)
        last = torch.cummax(torch.where(r_ok, tri, -1), 0).values
        M = torch.where((last >= 0)[:, None, None], Msnap[torch.clamp_min(last, 0)], eye)
        return result._replace(poses=M @ result.poses, pose_ok=result.pose_ok | r_ok), M[-1], r_ok

    def _reloc_chunk_pnp(self, db, result, m: MapState, valid, fids_d, fids: list[int], seed: int, bow=None):
        """Relocalize lost frames of a PnP chunk and re-anchor what the corrected frames inserted
        → (result', map', M_last, r_ok).

        The correction of frame f is the latest event at or before it: a
        snap applies M = T_reloc · T_f⁻¹, and a frame that solved an
        absolute pose against the map resets it to the identity.  The
        landmarks frame f inserted are those born at or after its
        ``pnp_point_count0``; keyframe rows map back to frames by ``kf_id``.
        A world-frame update X' = M X takes a keyframe's (R, t) to
        (R·M_Rᵀ, t − R·M_Rᵀ·M_t).
        """
        B = result.poses.shape[0]
        need = valid & ~result.pose_ok & (fids_d > 0)
        need_host = need.cpu().tolist()
        eye = torch.eye(4, device=self.device)
        if not any(need_host):
            return result, m, eye, torch.zeros(B, dtype=torch.bool, device=self.device)
        r_ok, Msnap = self._relocalize(db, result, need, fids, need_host, seed, bow)
        tri = torch.arange(B, device=self.device)
        last_snap = torch.cummax(torch.where(r_ok, tri, -1), 0).values
        last_anchor = torch.cummax(torch.where(result.pnp_absolute_ok, tri, -1), 0).values
        live = (last_snap >= 0) & (last_snap > last_anchor)
        M = torch.where(live[:, None, None], Msnap[torch.clamp_min(last_snap, 0)], eye)

        # landmarks born at corrected frames
        count0 = result.pnp_point_count0
        fidx = (m.point_birth[:, None] >= count0[None, :]).sum(dim=1) - 1  # owning frame, −1 = before the chunk
        Mp = M[torch.clamp(fidx, 0, B - 1)]
        corr_pt = (fidx >= 0) & m.point_valid
        pts = torch.einsum("pij,pj->pi", Mp[:, :3, :3], m.points) + Mp[:, :3, 3]
        points2 = torch.where(corr_pt[:, None], pts, m.points)
        # keyframe-window rows inserted this chunk
        kidx = (m.kf_id - fids[0]).to(torch.int64)
        in_chunk = (kidx >= 0) & (kidx < B) & m.kf_valid
        Mk = M[torch.clamp(kidx, 0, B - 1)]
        R2 = m.kf_R @ Mk[:, :3, :3].transpose(-1, -2)
        t2 = m.kf_t - torch.einsum("wij,wj->wi", R2, Mk[:, :3, 3])
        m2 = m._replace(
            points=points2,
            kf_R=torch.where(in_chunk[:, None, None], R2, m.kf_R),
            kf_t=torch.where(in_chunk[:, None], t2, m.kf_t),
        )
        return result._replace(poses=M @ result.poses, pose_ok=result.pose_ok | r_ok), m2, M[-1], r_ok

    def _step(self, carry: tuple, frames: torch.Tensor, valid: torch.Tensor, seed: int):
        """One chunk: tracking, relocalization, the map (VO: the fold), loop closure, BA when due."""
        B = frames.shape[0]
        pnp_mode = self.tracking == "pnp"
        lc = self.loop_closure
        valid_d = valid.to(self.device)
        reloc_ok = torch.zeros(B, dtype=torch.bool, device=self.device)
        if pnp_mode:
            st, db, since_ba = carry
            fids = [st.vo.frame_idx + i for i in range(B)]
            fids_d = st.vo.frame_idx + torch.arange(B, dtype=torch.int32, device=self.device)
            result, st2 = self.pipeline.process_chunk_pnp(frames, valid, st, seed)
            bow = None if lc is None else lc.vocabulary.transform(result.desc, result.kps_valid)
            if lc is not None and self.enable_relocalization:
                result, m_fix, M_last, reloc_ok = self._reloc_chunk_pnp(
                    db, result, st2.map, valid_d, fids_d, fids, seed, bow)
                st2 = st2._replace(map=m_fix, vo=st2.vo._replace(pose=M_last @ st2.vo.pose))
            # every valid tracked frame is a keyframe (after relocalization: rescued frames insert)
            kf_enabled = valid_d & (result.pose_ok | (fids_d == 0))
            m2 = st2.map
        else:
            vo, m, a, db, since_ba = carry
            fids = [vo.frame_idx + i for i in range(B)]
            fids_d = vo.frame_idx + torch.arange(B, dtype=torch.int32, device=self.device)
            result, vo2 = self.pipeline.process_chunk(frames, valid, vo, seed)
            bow = None if lc is None else lc.vocabulary.transform(result.desc, result.kps_valid)
            if lc is not None and self.enable_relocalization:
                result, M_last, reloc_ok = self._reloc_chunk(db, result, valid_d, fids_d, fids, seed, bow)
                vo2 = vo2._replace(pose=M_last @ vo2.pose)
            kf_mask = ((fids_d % self.keyframe_interval) == 0) & valid_d
            fold = update_map_chunk_batched if self.use_batched_map else update_map_chunk
            m2, a2 = fold(
                m, a, self._K, fids_d, kf_mask, result.poses, result.pose_ok,
                result.kps_xy, result.m_query, result.m_train,
                result.m_valid, result.points3d, result.point_ok,
                gate_px=self.config.map.assoc_gate_px,
                min_cand_depth=self.config.map.min_candidate_depth,
            )
            kf_enabled = kf_mask & (result.pose_ok | (fids_d == 0))
        out = {
            "poses": result.poses,
            "pose_ok": result.pose_ok,
            "num_matches": result.num_matches,
            "num_inliers": result.num_inliers,
            "kf_enabled": kf_enabled,
            "reloc_ok": reloc_ok,
        }
        if lc is not None:
            db, out["loop"] = self._lc_chunk(db, fids_d, fids, kf_enabled, result, seed,
                                             m=m2 if pnp_mode else None, bow=bow)
        since_ba = since_ba + kf_enabled.sum(dtype=torch.int32)
        if self.enable_ba:
            m2, c0, c1, ran = self._ba_cond(m2, since_ba)
            since_ba = torch.where(ran, 0, since_ba)
            out.update(
                ba_ran=ran, ba_costs=torch.stack([c0, c1]), ba_kf_id=m2.kf_id,
                ba_kf_valid=m2.kf_valid & ran, ba_kf_R=m2.kf_R, ba_kf_t=m2.kf_t,
            )
        if pnp_mode:
            # the optimised window is the map the next chunk tracks against, and
            # the chain continues from its newest keyframe
            if self.enable_ba:
                pose2 = self._refreshed_pose(m2, ran, st2.vo.pose)
                st2 = st2._replace(map=m2, vo=st2.vo._replace(pose=pose2))
            return (st2, db, since_ba), out
        return (vo2, m2, a2, db, since_ba), out

    def new_db(self):
        """An empty keyframe database (None without loop closure)."""
        if self.loop_closure is None:
            return None
        det = self.config.detector
        return self.loop_closure.new_db(det.max_keypoints, det.descriptor_bytes)

    def initial_carry(self) -> tuple:
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.tracking == "pnp":
            return (self.pipeline.initial_pnp_state(), self.new_db(), zero)
        return (
            self.pipeline.initial_state(),
            empty_map(self.ba_window, self.max_map_points, self.device),
            empty_assoc(self.config.detector.max_keypoints, self.device),
            self.new_db(),
            zero,
        )

    def run_sequence(self, frames: np.ndarray, seed: int = 0, warm_start: dict | None = None) -> dict:
        """SLAM over a pre-staged (N, H, W) uint8 frame array, on ``device``.

        The frames go to the device once; chunks run in order; the outputs
        come back once; the BA windows and then the pose graph fold into the
        trajectory on the host.  Returns the reference's keys: ``poses``
        (N, 4, 4), ``loops`` (``frame_id``, ``matched_keyframe_id``,
        ``num_inliers``, ``relative_transform``), ``ba_events``, ``map``,
        ``db`` (None without loop closure), ``pose_graph_applied``,
        ``num_matches``, ``num_inliers``, ``pose_ok`` and ``reloc_ok``.
        """
        if warm_start is not None:
            raise NotImplementedError(f"warm_start is not ported yet: {LOCALIZATION_ITEM}")
        B = self.config.batch_size
        frames = np.asarray(frames)
        n = len(frames)
        n_chunks = -(-n // B)
        pad = n_chunks * B - n
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
        valid = torch.from_numpy(np.arange(n_chunks * B) < n).reshape(n_chunks, B)
        chunks = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        chunks = chunks.reshape(n_chunks, B, *frames.shape[1:])

        carry = self.initial_carry()
        outs: dict[str, list] = {}
        for c in range(n_chunks):
            carry, out = self._step(carry, chunks[c], valid[c], seed)
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        loop_parts = outs.pop("loop", None)
        host = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}

        poses = host["poses"].reshape(-1, 4, 4)[:n]
        kf_fids = [int(f) for f in np.nonzero(host["kf_enabled"].reshape(-1)[:n])[0]]
        loops: list[dict] = []
        if loop_parts is not None:
            lres = LoopResult(*(torch.stack(parts).cpu().numpy() for parts in zip(*loop_parts)))
            succ = lres.success.reshape(-1)[:n]
            matched = lres.matched_keyframe_id.reshape(-1)[:n]
            n_inl = lres.num_inliers.reshape(-1)[:n]
            T_rel = lres.relative_transform.reshape(-1, 4, 4)[:n]
            loops = [
                {"frame_id": int(f), "matched_keyframe_id": int(matched[f]), "num_inliers": int(n_inl[f]),
                 "relative_transform": T_rel[f]}
                for f in np.nonzero(succ)[0]
            ]
        ba_events: list[dict] = []
        if self.enable_ba:
            for c in np.nonzero(host["ba_ran"])[0]:
                snapshot = {k: host[f"ba_{k}"][c] for k in ("kf_id", "kf_valid", "kf_R", "kf_t")}
                ba_events.append({
                    "frame_id": int(min((c + 1) * B, n) - 1),
                    "initial_cost": float(host["ba_costs"][c, 0]),
                    "final_cost": float(host["ba_costs"][c, 1]),
                })
                poses = self._apply_ba_snapshot(snapshot, poses)
        pose_graph_applied = False
        if self.enable_pose_graph and loops and len(kf_fids) >= 2:
            poses = self._apply_pose_graph(poses, kf_fids, loops)
            pose_graph_applied = True
        pnp_mode = self.tracking == "pnp"
        return {
            "poses": poses,
            "loops": loops,
            "ba_events": ba_events,
            "map": carry[0].map if pnp_mode else carry[1],
            "db": carry[1] if pnp_mode else carry[3],
            "pose_graph_applied": pose_graph_applied,
            "num_matches": host["num_matches"].reshape(-1)[:n],
            "num_inliers": host["num_inliers"].reshape(-1)[:n],
            "pose_ok": host["pose_ok"].reshape(-1)[:n],
            "reloc_ok": host["reloc_ok"].reshape(-1)[:n],
        }

    def run(self, *args, **kwargs):
        raise NotImplementedError(f"the streaming SlamSystem.run() is not ported yet: {STREAMING_ITEM}")

    def _loop_graph(self, all_poses: np.ndarray, kf_fids: list[int], loops: list[dict]):
        """The keyframes' chain graph on ``device`` with one edge a loop (None without a usable loop)."""
        fid_to_node = {fid: i for i, fid in enumerate(kf_fids)}
        kf_poses = torch.as_tensor(all_poses[np.asarray(kf_fids)], dtype=torch.float32).to(self.device)
        n_edges = len(kf_fids) - 1 + len(loops)
        g = graph_from_trajectory(kf_poses, max_edges=max(2 * n_edges, 8))
        slot = len(kf_fids) - 1
        for lp in loops:
            cand = fid_to_node.get(lp["matched_keyframe_id"])
            query = fid_to_node.get(lp["frame_id"])
            if cand is None or query is None or cand == query:
                continue
            # PnP gives x_query = R·X_cand + t, so T_camc_camq = [R|t]⁻¹
            T_rel = np.linalg.inv(np.asarray(lp["relative_transform"], np.float64))
            g = add_edge(g, slot, cand, query, torch.as_tensor(T_rel, dtype=torch.float32),
                         weight=self.config.map.loop_edge_weight)
            slot += 1
        return None if slot == len(kf_fids) - 1 else g

    def _apply_pose_graph(self, all_poses: np.ndarray, kf_fids: list[int], loops: list[dict]) -> np.ndarray:
        """Optimise the keyframes with their loop edges on ``device`` (12 GN steps); every frame
        between keyframe k and k + 1 inherits k's rigid correction T_f ← T_k_opt · T_k_orig⁻¹ · T_f
        (float64 on the host)."""
        g = self._loop_graph(all_poses, kf_fids, loops)
        if g is None:
            return all_poses
        kf_opt = optimize_pose_graph(g, iterations=12).nodes[: len(kf_fids)].cpu().numpy().astype(np.float64)
        kf_arr = np.asarray(kf_fids)
        corrs = np.einsum("nij,njk->nik", kf_opt, np.linalg.inv(np.asarray(all_poses, np.float64)[kf_arr]))
        seg = np.searchsorted(kf_arr, np.arange(len(all_poses)), side="right") - 1
        covered = seg >= 0  # frames before the first keyframe keep their poses
        corrected = all_poses.copy()
        corrected[covered] = np.einsum(
            "fij,fjk->fik", corrs[seg[covered]], np.asarray(all_poses, np.float64)[covered]
        ).astype(all_poses.dtype)
        return corrected

    @staticmethod
    def _apply_ba_snapshot(snapshot: dict, all_poses: np.ndarray) -> np.ndarray:
        """Fold optimised keyframe poses into the trajectory, corrections carried forward.

        Each optimised keyframe overwrites its own entry, and every frame after
        it, up to the next optimised keyframe (or the end for the newest),
        inherits its rigid correction ``T_f ← T_k_opt · T_k_orig⁻¹ · T_f``.
        Float64 on the host, as the reference.
        """
        kf_ids = np.asarray(snapshot["kf_id"])
        kf_valid = np.asarray(snapshot["kf_valid"])
        R = np.asarray(snapshot["kf_R"])
        t = np.asarray(snapshot["kf_t"])
        n = len(all_poses)
        items = sorted((int(kf_ids[s]), int(s)) for s in np.nonzero(kf_valid)[0] if 0 <= kf_ids[s] < n)
        if not items:
            return all_poses
        corrected = all_poses.copy()
        for i, (fid, slot) in enumerate(items):
            end = items[i + 1][0] if i + 1 < len(items) else n
            T_opt = np.eye(4, dtype=np.float64)
            T_opt[:3, :3] = R[slot].T  # cam→world
            T_opt[:3, 3] = -R[slot].T @ t[slot]
            corr = T_opt @ np.linalg.inv(np.asarray(all_poses[fid], np.float64))
            corrected[fid:end] = np.einsum(
                "ij,fjk->fik", corr, np.asarray(all_poses[fid:end], np.float64)
            ).astype(all_poses.dtype)
        return corrected
