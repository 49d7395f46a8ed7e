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

Two drivers, as in the reference:

* ``run_sequence`` — a pre-staged (N, H, W) frame array, a host loop over
  chunks as ``process_sequence`` is, BA scheduled on the device count of
  enabled keyframes;
* ``run`` — the streaming driver over ``FrameStream.batches()``-shaped
  chunks, staged ahead on the device by ``device_prefetch``: BA scheduled on
  the host count of expected keyframes, each chunk keeping only its poses,
  stats, loops and BA snapshot, everything folded once after the last
  chunk; ``resume`` continues from a ``result["checkpoint"]`` payload
  (``checkpoint_template`` is its structure for ``utils/checkpoint.py``),
  and a split run reproduces the uninterrupted one.

Both take ``warm_start={"map", "db"}`` to start a new run against prebuilt
state; ``localization_only`` (PnP tracking) tracks against that state
frozen: no inserts, no BA, relocalization from frame 0.

The reference's ``lax.cond`` branches become host reads once a chunk: whether a
frame needs relocalization, and (in ``LoopClosure``) the ring's overflow
flag with the candidate mask.  Random draws depend only on (seed, global
frame index), in four streams: the two-view ranks, the tracker's
RANSAC-PnP samples, loop verification's and relocalization's; so restoring
the frame counter is all a resumed run needs to draw as the uninterrupted
one.  ``draw_fn``, ``pnp_draw_fn``, ``lc_draw_fn(frame_idx, valid) -> (H, 6)``
and ``reloc_draw_fn(frame_idx, pnp_valid, n_valid) -> ((H, 6), (1024, 5))``
may supply them (a test passes the reference package's).  The time-sharded
driver's cross-segment verification draws a fifth stream, by candidate
rank, or from ``cross_draw_fn(rank, n_candidates, valid) -> (H, 6)``.

``run_sequence`` is ``_sequence_raw`` (the chunk loop: the raw outputs and
the final carry, as the reference's ``_sequence_impl``) then
``_fold_sequence``; ``dist/`` runs the first on each shard or sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from typing import Callable, Iterator

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
from tpuslam_torch.pre.stream import device_prefetch
from tpuslam_torch.utils.convert import _numpy

_LC_STREAM = 0xC2B2AE3D27D4EB4F  # xor-ed into the seed of loop verification's draws
_RELOC_STREAM = 0x165667B19E3779F9  # and of relocalization's
LcDrawFn = Callable[[int, torch.Tensor], torch.Tensor]
RelocDrawFn = Callable[[int, torch.Tensor, int], tuple]
CrossDrawFn = Callable[[int, int, torch.Tensor], torch.Tensor]


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
    # track against a loaded map and DB, frozen (tracking="pnp"; the state comes in as warm_start)
    localization_only: bool = False
    device: torch.device | str = "cuda"
    draw_fn: DrawFn | None = None
    pnp_draw_fn: PnpDrawFn | None = None
    lc_draw_fn: LcDrawFn | None = None
    reloc_draw_fn: RelocDrawFn | None = None
    cross_draw_fn: CrossDrawFn | None = None  # dist/timeshard.py's cross-segment verification

    def __post_init__(self) -> None:
        if self.tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {self.tracking!r}")
        if self.localization_only:
            if self.tracking != "pnp":
                raise ValueError("localization_only requires tracking='pnp' (the map-centric tracker)")
            self.enable_ba = False  # nothing to optimise on a frozen map
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
            freeze_map=self.localization_only,
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
        (R·M_Rᵀ, t − R·M_Rᵀ·M_t).  With ``localization_only`` frame 0 may
        relocalize too (it bootstraps against the loaded DB), and the loaded
        map stays as it is: corrections touch the poses only.
        """
        B = result.poses.shape[0]
        need = valid & ~result.pose_ok
        if not self.localization_only:
            need = need & (fids_d > 0)
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
        out = result._replace(poses=M @ result.poses, pose_ok=result.pose_ok | r_ok)
        if self.localization_only:
            return out, m, M[-1], r_ok

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
        return out, m2, M[-1], r_ok

    def _track(self, state, m, a, db, frames: torch.Tensor, valid: torch.Tensor, seed: int):
        """One chunk up to BA: tracking, relocalization, the map (VO: the fold), loop closure.

        ``state`` is the tracking carry: a ``VoState`` with the window ``m``
        and association ``a`` beside it, or a ``PnpState`` holding its own
        (``m`` and ``a`` then unused).  Returns (the chunk's outputs, state',
        map', assoc', db').
        """
        B = frames.shape[0]
        pnp_mode = self.tracking == "pnp"
        lc = self.loop_closure
        relocalize = lc is not None and self.enable_relocalization
        valid_d = valid.to(self.device)
        frame_idx = (state.vo if pnp_mode else state).frame_idx
        fids = [frame_idx + i for i in range(B)]
        fids_d = frame_idx + torch.arange(B, dtype=torch.int32, device=self.device)
        reloc_ok = torch.zeros(B, dtype=torch.bool, device=self.device)
        if pnp_mode:
            result, state = self.pipeline.process_chunk_pnp(frames, valid, state, seed)
            bow = None if lc is None else lc.vocabulary.transform(result.desc, result.kps_valid)
            if relocalize:
                result, m_fix, M_last, reloc_ok = self._reloc_chunk_pnp(
                    db, result, state.map, valid_d, fids_d, fids, seed, bow)
                state = state._replace(map=m_fix, vo=state.vo._replace(pose=M_last @ state.vo.pose))
            m = state.map
            if self.localization_only:  # the loaded map and DB are frozen: nothing inserts
                kf_enabled = torch.zeros(B, dtype=torch.bool, device=self.device)
            else:  # every valid tracked frame is a keyframe (after relocalization: rescued frames insert)
                kf_enabled = valid_d & (result.pose_ok | (fids_d == 0))
        else:
            result, state = self.pipeline.process_chunk(frames, valid, state, seed)
            bow = None if lc is None else lc.vocabulary.transform(result.desc, result.kps_valid)
            if relocalize:
                result, M_last, reloc_ok = self._reloc_chunk(db, result, valid_d, fids_d, fids, seed, bow)
                state = state._replace(pose=M_last @ state.pose)
            kf_mask = ((fids_d % self.keyframe_interval) == 0) & valid_d
            fold = update_map_chunk_batched if self.use_batched_map else update_map_chunk
            m, a = fold(
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
                                             m=m if pnp_mode else None, bow=bow)
        return out, state, m, a, db

    def _track_from(self, st, m: MapState, ran) -> tuple:
        """PnP: the optimised window is the map the next chunk tracks against, and the chain
        continues from its newest keyframe."""
        return st._replace(map=m, vo=st.vo._replace(pose=self._refreshed_pose(m, ran, st.vo.pose)))

    def _step(self, carry: tuple, frames: torch.Tensor, valid: torch.Tensor, seed: int):
        """One chunk of ``run_sequence``: ``_track``, then BA once the enabled keyframes reach the interval."""
        pnp_mode = self.tracking == "pnp"
        if pnp_mode:
            st, db, since_ba = carry
            m = a = None
        else:
            st, m, a, db, since_ba = carry
        out, st, m, a, db = self._track(st, m, a, db, frames, valid, seed)
        since_ba = since_ba + out["kf_enabled"].sum(dtype=torch.int32)
        if self.enable_ba:
            m, c0, c1, ran = self._ba_cond(m, since_ba)
            since_ba = torch.where(ran, 0, since_ba)
            out.update(
                ba_ran=ran, ba_costs=torch.stack([c0, c1]), ba_kf_id=m.kf_id,
                ba_kf_valid=m.kf_valid & ran, ba_kf_R=m.kf_R, ba_kf_t=m.kf_t,
            )
            if pnp_mode:
                st = self._track_from(st, m, ran)
        if pnp_mode:
            return (st, db, since_ba), out
        return (st, m, a, db, since_ba), out

    def new_db(self):
        """An empty keyframe database (None without loop closure)."""
        if self.loop_closure is None:
            return None
        det = self.config.detector
        return self.loop_closure.new_db(det.max_keypoints, det.descriptor_bytes)

    def _warm_start_map(self, m: MapState) -> MapState:
        """A loaded map made ready for a new run that starts at frame 0.

        Its keyframe rows carry the frame ids of the run that built them,
        which the new run issues again; ``_reloc_chunk_pnp`` (``kf_id −
        fids[0]``) and ``_apply_ba_snapshot`` (``kf_id`` indexes the
        trajectory) would take them for this run's frames.  So valid rows
        are re-stamped, in order, to ids ≤ −2, below the empty sentinel −1.
        In localization mode the map stays as loaded (it is never corrected).
        """
        if self.localization_only:
            return m
        max_id = torch.where(m.kf_valid, m.kf_id, -1).max()
        return m._replace(kf_id=torch.where(m.kf_valid, m.kf_id - (max_id + 2), m.kf_id))

    def _start(self, warm_start: dict | None) -> tuple:
        """(tracking state, map, association, DB) of a new run, with ``warm_start``'s map and DB where given."""
        if self.localization_only and (warm_start is None or "map" not in warm_start):
            raise ValueError("localization_only needs warm_start={'map': ..., 'db': ...} "
                             "(a previous run's checkpoint carries both)")
        pnp_mode = self.tracking == "pnp"
        state = self.pipeline.initial_pnp_state() if pnp_mode else self.pipeline.initial_state()
        m = empty_map(self.ba_window, self.max_map_points, self.device)
        a = empty_assoc(self.config.detector.max_keypoints, self.device)
        db = self.new_db()
        if warm_start is not None:
            if "db" in warm_start and db is not None:
                db = warm_start["db"]
            if "map" in warm_start:
                m = self._warm_start_map(warm_start["map"])
                if pnp_mode:
                    state = state._replace(map=m)
        return state, m, a, db

    def initial_carry(self, warm_start: dict | None = None) -> tuple:
        """``run_sequence``'s carry: (state, db, since_ba) in PnP mode, (state, map, assoc, db, since_ba) in VO."""
        state, m, a, db = self._start(warm_start)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.tracking == "pnp":
            return (state, db, zero)
        return (state, m, a, db, zero)

    def run_sequence(self, frames: np.ndarray, seed: int = 0, warm_start: dict | None = None) -> dict:
        """SLAM over a pre-staged (N, H, W) uint8 frame array, on ``device``.

        The frames go to the device once; chunks run in order; the outputs
        come back once; the BA windows and then the pose graph fold into the
        trajectory on the host.  ``warm_start``: ``{"map": MapState, "db":
        KeyframeDB}`` to start from prebuilt state (``localization_only``
        needs it).  Returns the reference's keys: ``poses``
        (N, 4, 4), ``loops`` (``frame_id``, ``matched_keyframe_id``,
        ``num_inliers``, ``relative_transform``), ``ba_events``, ``map``,
        ``db`` (None without loop closure), ``pose_graph_applied``,
        ``num_matches``, ``num_inliers``, ``pose_ok`` and ``reloc_ok``.
        """
        carry = self.initial_carry(warm_start)
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
        carry, raw = self._sequence_raw(chunks, valid, carry, seed)
        return self._fold_sequence(raw, n, carry)

    def _sequence_raw(self, chunks: torch.Tensor, chunk_valid: torch.Tensor, carry: tuple, seed: int = 0):
        """``run_sequence``'s chunk loop → (final carry, raw outputs), as the reference's ``_sequence_impl``.

        ``chunks`` (C, B, H, W) uint8 on ``device``; ``chunk_valid`` (C, B)
        bool on the host; ``carry`` from ``initial_carry``.  The outputs are
        read back once, stacked along the chunk axis as numpy: ``poses``,
        ``pose_ok``, ``num_matches``, ``num_inliers``, ``kf_enabled``,
        ``reloc_ok``; with BA ``ba_ran``, ``ba_costs`` and the window
        snapshot ``ba_kf_id``, ``ba_kf_valid``, ``ba_kf_R``, ``ba_kf_t``;
        with loop closure ``loop``, a ``LoopResult`` of (C, B) arrays.
        Nothing is folded.
        """
        outs: dict[str, list] = {}
        for c in range(chunks.shape[0]):
            carry, out = self._step(carry, chunks[c], chunk_valid[c], seed)
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        loop_parts = outs.pop("loop", None)
        raw = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}
        if loop_parts is not None:
            raw["loop"] = LoopResult(*(torch.stack(parts).cpu().numpy() for parts in zip(*loop_parts)))
        return carry, raw

    def _fold_sequence(self, host: dict, n: int, carry: tuple) -> dict:
        """``run_sequence``'s result from ``_sequence_raw``'s outputs over ``n`` real frames: the BA
        snapshots and then the pose graph folded into the trajectory on the host."""
        B = self.config.batch_size
        poses = host["poses"].reshape(-1, 4, 4)[:n]
        kf_fids = [int(f) for f in np.nonzero(host["kf_enabled"].reshape(-1)[:n])[0]]
        loops: list[dict] = []
        if "loop" in host:
            lres = host["loop"]
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

    def checkpoint_template(self) -> dict:
        """The structure of ``run()``'s ``result["checkpoint"]``, for ``utils.checkpoint.load_state``.

        Shapes are placeholders: the file's own shapes are what loads.  The
        DB is a 0-d float32 zero without loop closure, as in the reference.
        """
        pnp_mode = self.tracking == "pnp"
        state = self.pipeline.initial_pnp_state() if pnp_mode else self.pipeline.initial_state()
        db = self.new_db()
        W = self.ba_window
        z = np.zeros
        return {
            "carry_state": state,
            "world_map": empty_map(W, self.max_map_points, self.device),
            "assoc": empty_assoc(self.config.detector.max_keypoints, self.device),
            "db": z((), np.float32) if db is None else db,
            "counters": z(3, np.int64),
            "raw_poses": z((0, 4, 4), np.float32),
            "stats_matches": z(0, np.int32),
            "stats_inliers": z(0, np.int32),
            "stats_pose_ok": z(0, bool),
            "stats_reloc_ok": z(0, bool),
            "kf_fids": z(0, np.int32),
            "loops_frame": z(0, np.int32),
            "loops_matched": z(0, np.int32),
            "loops_ninl": z(0, np.int32),
            "loops_T": z((0, 4, 4), np.float32),
            "ba_frame": z(0, np.int32),
            "ba_costs": z((0, 2), np.float32),
            "ba_kf_id": z((0, W), np.int32),
            "ba_kf_valid": z((0, W), bool),
            "ba_kf_R": z((0, W, 3, 3), np.float32),
            "ba_kf_t": z((0, W, 3), np.float32),
        }

    def run(self, frame_batches: Iterator[tuple], seed: int = 0, resume: dict | None = None,
            warm_start: dict | None = None) -> dict:
        """Stream ``(frames (B, H, W) uint8, stamps, valid (B,) bool)`` chunks through SLAM.

        The chunks are staged on ``device`` ahead of use (``device_prefetch``).
        Each runs ``_track``; BA is scheduled on the host count of *expected*
        keyframes and runs when due, with no read of the device; a chunk
        keeps only its poses, stats, loop results and BA snapshot.  After
        the last chunk everything is read back once and folded: the BA
        snapshots in event order, then the pose graph.

        ``resume``: a ``result["checkpoint"]`` payload of an earlier run
        (``load_state`` against ``checkpoint_template()``).  The stream
        continues at its frame counter (``counters[0]``) with the same batch
        size; its raw trajectory, stats, keyframes, loops and BA snapshots
        are prepended before the fold, so a split run reproduces the
        uninterrupted one.  ``warm_start``: ``{"map", "db"}`` to start a new
        stream (frame ids from 0) against prebuilt state; required with
        ``localization_only``; exclusive with ``resume``.

        Returns ``poses``, ``loops``, ``ba_events``, ``map``,
        ``pose_graph_applied``, ``checkpoint``, ``num_matches``,
        ``num_inliers``, ``pose_ok`` and ``reloc_ok``.
        """
        if resume is not None and warm_start is not None:
            raise ValueError("resume and warm_start are mutually exclusive (a resume payload carries its own "
                             "map and DB)")
        pnp_mode = self.tracking == "pnp"
        if resume is not None:
            state, world_map, assoc = resume["carry_state"], resume["world_map"], resume["assoc"]
            db = resume["db"] if self.loop_closure is not None else None
            frame_id, chunk_idx, kf_since_ba = (int(x) for x in _numpy(resume["counters"]))
        else:
            state, world_map, assoc, db = self._start(warm_start)
            frame_id = chunk_idx = kf_since_ba = 0

        records: list[dict] = []
        for frames, _stamps, valid in device_prefetch(frame_batches, self.device):
            valid = np.asarray(valid, dtype=bool)
            B, n = len(valid), int(valid.sum())
            fids = np.arange(frame_id, frame_id + B, dtype=np.int32)
            out, state, world_map, assoc, db = self._track(
                state, world_map, assoc, db, frames, torch.from_numpy(valid), seed)
            if pnp_mode:
                kf_mask = np.zeros(B, bool) if self.localization_only else np.arange(B) < n
            else:
                kf_mask = (fids % self.keyframe_interval == 0) & (np.arange(B) < n)
            # only what the fold reads: a whole ChunkResult would pin its features for the whole stream
            rec = {k: out[k] for k in ("poses", "num_matches", "num_inliers", "pose_ok", "reloc_ok")}
            rec.update(n=n, fids=fids, kf_mask=kf_mask)
            if "loop" in out:
                lres = out["loop"]
                rec["loop"] = (lres.success, lres.matched_keyframe_id, lres.num_inliers, lres.relative_transform)
            kf_since_ba += int(kf_mask.sum())
            if self.enable_ba and kf_since_ba >= self.ba_interval:
                ba = self._bundle_adjust(world_map)
                world_map = ba.map
                if pnp_mode:
                    state = self._track_from(state, world_map, True)
                rec["ba"] = {"initial_cost": ba.initial_cost, "final_cost": ba.final_cost,
                             **{k: getattr(world_map, k) for k in ("kf_id", "kf_valid", "kf_R", "kf_t")}}
                kf_since_ba = 0
            records.append(rec)
            frame_id += n
            chunk_idx += 1

        # ---- the one read-back, then the fold -------------------------------------------------
        poses_np: list[np.ndarray] = []
        stats: dict[str, list] = {"num_matches": [], "num_inliers": [], "pose_ok": [], "reloc_ok": []}
        kf_fids: list[int] = []
        loops: list[dict] = []
        ba_events: list[dict] = []
        ba_snaps: list[dict] = []
        for rec in records:
            n, fids = rec["n"], rec["fids"]
            poses_np.append(_numpy(rec["poses"])[:n])
            pose_ok = _numpy(rec["pose_ok"])
            for k in stats:
                stats[k].append(_numpy(rec[k])[:n])
            kf_enabled = rec["kf_mask"] & (pose_ok | (fids == 0))
            kf_fids.extend(int(f) for f in fids[kf_enabled])
            if "loop" in rec:
                success, matched, n_inl, T_rel = (_numpy(x) for x in rec["loop"])
                loops.extend(
                    {"frame_id": int(fids[b]), "matched_keyframe_id": int(matched[b]),
                     "num_inliers": int(n_inl[b]), "relative_transform": T_rel[b]}
                    for b in np.nonzero(success)[0]
                )
            if "ba" in rec:
                snap = {k: _numpy(v) for k, v in rec["ba"].items()}
                ba_events.append({"frame_id": kf_fids[-1] if kf_fids else 0,
                                  "initial_cost": float(snap["initial_cost"]),
                                  "final_cost": float(snap["final_cost"])})
                ba_snaps.append(snap)

        if resume is not None:  # the resumed segment's raw accumulations go first
            r = {k: _numpy(v) for k, v in resume.items() if k not in ("carry_state", "world_map", "assoc", "db")}
            poses_np.insert(0, r["raw_poses"].astype(np.float32))
            for k, saved in (("num_matches", "stats_matches"), ("num_inliers", "stats_inliers"),
                             ("pose_ok", "stats_pose_ok"), ("reloc_ok", "stats_reloc_ok")):
                stats[k].insert(0, r[saved])
            kf_fids = [int(f) for f in r["kf_fids"]] + kf_fids
            loops = [
                {"frame_id": int(f), "matched_keyframe_id": int(m), "num_inliers": int(k), "relative_transform": T}
                for f, m, k, T in zip(r["loops_frame"], r["loops_matched"], r["loops_ninl"], r["loops_T"])
            ] + loops
            ba_snaps = [{k: r[f"ba_{k}"][e] for k in ("kf_id", "kf_valid", "kf_R", "kf_t")}
                        for e in range(len(r["ba_frame"]))] + ba_snaps
            ba_events = [{"frame_id": int(f), "initial_cost": float(c[0]), "final_cost": float(c[1])}
                         for f, c in zip(r["ba_frame"], r["ba_costs"])] + ba_events

        raw_poses = np.concatenate(poses_np) if poses_np else np.zeros((0, 4, 4), np.float32)
        all_poses = raw_poses
        for snap in ba_snaps:  # in event order, so each window's correction reaches the frames after it
            all_poses = self._apply_ba_snapshot(snap, all_poses)
        pose_graph_applied = False
        if self.enable_pose_graph and loops and len(kf_fids) >= 2:
            all_poses = self._apply_pose_graph(all_poses, kf_fids, loops)
            pose_graph_applied = True

        W = self.ba_window

        def snaps(key: str, shape: tuple, dtype) -> np.ndarray:
            return np.stack([s[key] for s in ba_snaps]) if ba_snaps else np.zeros((0, *shape), dtype)

        stats_np = {k: np.concatenate(v) if v else np.zeros((0,)) for k, v in stats.items()}
        checkpoint = {
            "carry_state": state,
            "world_map": world_map,
            "assoc": assoc,
            "db": np.zeros((), np.float32) if db is None else db,
            "counters": np.asarray([frame_id, chunk_idx, kf_since_ba], np.int64),
            "raw_poses": raw_poses.astype(np.float32),
            "stats_matches": np.asarray(stats_np["num_matches"], np.int32),
            "stats_inliers": np.asarray(stats_np["num_inliers"], np.int32),
            "stats_pose_ok": np.asarray(stats_np["pose_ok"], bool),
            "stats_reloc_ok": np.asarray(stats_np["reloc_ok"], bool),
            "kf_fids": np.asarray(kf_fids, np.int32),
            "loops_frame": np.asarray([lp["frame_id"] for lp in loops], np.int32),
            "loops_matched": np.asarray([lp["matched_keyframe_id"] for lp in loops], np.int32),
            "loops_ninl": np.asarray([lp["num_inliers"] for lp in loops], np.int32),
            "loops_T": (np.stack([np.asarray(lp["relative_transform"], np.float32) for lp in loops])
                        if loops else np.zeros((0, 4, 4), np.float32)),
            "ba_frame": np.asarray([ev["frame_id"] for ev in ba_events], np.int32),
            "ba_costs": np.asarray([[ev["initial_cost"], ev["final_cost"]] for ev in ba_events],
                                   np.float32).reshape(-1, 2),
            "ba_kf_id": snaps("kf_id", (W,), np.int32),
            "ba_kf_valid": snaps("kf_valid", (W,), bool),
            "ba_kf_R": snaps("kf_R", (W, 3, 3), np.float32),
            "ba_kf_t": snaps("kf_t", (W, 3), np.float32),
        }
        return {
            "poses": all_poses,
            "loops": loops,
            "ba_events": ba_events,
            "map": world_map,
            "pose_graph_applied": pose_graph_applied,
            "checkpoint": checkpoint,
            **stats_np,
        }

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
