"""SlamSystem: tracking, the chunk map fold and windowed bundle adjustment.

Port of ``tpuslam/model/system.py`` with loop closure off
(``vocabulary=None``), for both tracking modes:

* **tracking** — ``SlamPipeline`` (``model/slam.py``) with its features,
  matches and triangulations, in ``vo`` or ``pnp`` mode;
* **map** — in VO mode each chunk folds into the sliding keyframe window
  (``update_map_chunk_batched``, or the per-frame ``update_map_chunk``):
  landmark identity chains through the match indices, so keyframes
  re-observe persistent points; in PnP mode the tracker builds the map
  itself, frame by frame;
* **backend** — windowed bundle adjustment (``backend/ba.py``) once the
  keyframes since the last run reach ``ba_interval``.  Each run's window
  is folded into the trajectory on the host at the end; in PnP mode the
  optimised window is also the map the next chunk tracks against, and the
  chain continues from its newest keyframe.

``run_sequence`` is a host loop over chunks, as ``process_sequence`` is.
Random draws follow the pipeline's rule: they depend only on (seed, global
frame index), and ``draw_fn`` / ``pnp_draw_fn`` may supply them.

Not in this port yet (ROADMAP Queue 1 item 3): the vocabulary, loop
closure, relocalization, the pose graph (and their options
``enable_pose_graph``, ``enable_relocalization``, ``reloc_budget``) and the
streaming ``run()``; and (item 4) ``warm_start``, resume and localization.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpuslam_torch.backend.ba import bundle_adjust
from tpuslam_torch.backend.map import (
    MapState,
    _row,
    empty_assoc,
    empty_map,
    update_map_chunk,
    update_map_chunk_batched,
)
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import DrawFn, PnpDrawFn, SlamPipeline

LOOP_CLOSURE_ITEM = "ROADMAP.md Queue 1 item 3 (vocabulary, loop closure, relocalization, pose graph)"
LOCALIZATION_ITEM = "ROADMAP.md Queue 1 item 4 (resume and localization)"


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
    enable_loop_closure: bool = True  # with a vocabulary: not ported yet (raises)
    enable_ba: bool = True
    use_batched_map: bool = True  # VO's fold: the batched one, else the per-frame scan
    localization_only: bool = False  # not ported yet (raises)
    device: torch.device | str = "cuda"
    draw_fn: DrawFn | None = None
    pnp_draw_fn: PnpDrawFn | None = None

    def __post_init__(self) -> None:
        if self.tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {self.tracking!r}")
        if self.localization_only:
            raise NotImplementedError(f"localization_only is not ported yet: {LOCALIZATION_ITEM}")
        if self.enable_loop_closure and self.vocabulary is not None:
            raise NotImplementedError(
                f"loop closure (a vocabulary with enable_loop_closure=True) is not ported yet: {LOOP_CLOSURE_ITEM}"
            )
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

    def _step(self, carry: tuple, frames: torch.Tensor, valid: torch.Tensor, seed: int):
        """One chunk: tracking, the map (VO: the fold), BA when due → (carry, outputs)."""
        B = frames.shape[0]
        pnp_mode = self.tracking == "pnp"
        if pnp_mode:
            st, since_ba = carry
            fids = st.vo.frame_idx + torch.arange(B, dtype=torch.int32, device=self.device)
            result, st2 = self.pipeline.process_chunk_pnp(frames, valid, st, seed)
            valid_d = valid.to(self.device)
            kf_enabled = valid_d & (result.pose_ok | (fids == 0))
            m2 = st2.map
        else:
            vo, m, a, since_ba = carry
            fids = vo.frame_idx + torch.arange(B, dtype=torch.int32, device=self.device)
            result, vo2 = self.pipeline.process_chunk(frames, valid, vo, seed)
            kf_mask = ((fids % self.keyframe_interval) == 0) & valid.to(self.device)
            fold = update_map_chunk_batched if self.use_batched_map else update_map_chunk
            m2, a2 = fold(
                m, a, self._K, fids, kf_mask, result.poses, result.pose_ok,
                result.kps_xy, result.m_query, result.m_train,
                result.m_valid, result.points3d, result.point_ok,
                gate_px=self.config.map.assoc_gate_px,
                min_cand_depth=self.config.map.min_candidate_depth,
            )
            kf_enabled = kf_mask & (result.pose_ok | (fids == 0))
        out = {
            "poses": result.poses,
            "pose_ok": result.pose_ok,
            "num_matches": result.num_matches,
            "num_inliers": result.num_inliers,
            "kf_enabled": kf_enabled,
        }
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
            return (st2, since_ba), out
        return (vo2, m2, a2, since_ba), out

    def initial_carry(self) -> tuple:
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.tracking == "pnp":
            return (self.pipeline.initial_pnp_state(), zero)
        return (
            self.pipeline.initial_state(),
            empty_map(self.ba_window, self.max_map_points, self.device),
            empty_assoc(self.config.detector.max_keypoints, self.device),
            zero,
        )

    def run_sequence(self, frames: np.ndarray, seed: int = 0, warm_start: dict | None = None) -> dict:
        """SLAM over a pre-staged (N, H, W) uint8 frame array, on ``device``.

        The frames go to the device once; chunks run in order; the outputs
        come back once, and the BA windows fold into the trajectory on the
        host.  Returns the reference's keys: ``poses`` (N, 4, 4),
        ``ba_events``, ``map``, ``num_matches``, ``num_inliers``, ``pose_ok``,
        and, with loop closure off, ``loops`` empty, ``reloc_ok`` all false,
        ``pose_graph_applied`` False and ``db`` None.
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
        outs: dict[str, list[torch.Tensor]] = {}
        for c in range(n_chunks):
            carry, out = self._step(carry, chunks[c], valid[c], seed)
            for k, v in out.items():
                outs.setdefault(k, []).append(v)
        host = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}

        poses = host["poses"].reshape(-1, 4, 4)[:n]
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
        return {
            "poses": poses,
            "loops": [],
            "ba_events": ba_events,
            "map": carry[0].map if self.tracking == "pnp" else carry[1],
            "db": None,
            "pose_graph_applied": False,
            "num_matches": host["num_matches"].reshape(-1)[:n],
            "num_inliers": host["num_inliers"].reshape(-1)[:n],
            "pose_ok": host["pose_ok"].reshape(-1)[:n],
            "reloc_ok": np.zeros(n, bool),
        }

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
