"""SlamPipeline: the batched monocular pipeline, in VO and PnP tracking modes.

Port of ``tpuslam/model/slam.py``.  One chunk of B frames runs, in order:
undistort gather; detector (kernels 1-3, or 5, 2 and 3, on each pyramid
level); matching of consecutive pairs; two-view RANSAC (kernel 4);
triangulation.  Then, with ``tracking="vo"``, depth-ratio scale
propagation and relative transforms chained into global poses (the carry
holds the last frame's features, its global pose and its keypoint depths);
with ``tracking="pnp"``, the per-frame tracker of ``model/tracking.py``
against a persistent landmark map (the carry adds the map and the landmark
association; ``process_chunk_pnp``, ``process_sequence_pnp``, ``run_pnp``).

VO also runs S independent sequences as one batched chunk step
(``process_chunks``), the reference's ``jax.vmap`` of its chunk program:
the front end and the two-view stage run once over the S·B frames, the
scale and the chaining per sequence along B; every sequence keeps its own
carry, seed and draws.  ``process_chunk`` is its batch of one.

Random draws depend only on (seed, global frame index), never on where
chunk boundaries fall, in two streams: the two-view ranks and the RANSAC-PnP
samples.  ``draw_fn(frame_idx, n_valid, H, S)`` and ``pnp_draw_fn(frame_idx,
valid) -> (H, 6)`` may supply them (a test passes the reference package's
draws); by default each comes from the pipeline's ``torch.Generator``
reseeded from ``(seed, frame_idx)`` and the stream.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

from tpuslam_torch.backend.map import AssocState, MapState, empty_assoc, empty_map
from tpuslam_torch.backend.pnp import gumbel_sample_indices
from tpuslam_torch.common.camera import Camera, undistort_batch
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.frontend.detector import FeatureDetector
from tpuslam_torch.frontend.fast import KeypointSet
from tpuslam_torch.frontend.matcher import match_descriptors
from tpuslam_torch.frontend.pose import (
    draw_ranks,
    estimate_relative_pose,
    triangulate_matched_points,
)
from tpuslam_torch.pre.stream import device_prefetch
from tpuslam_torch.utils import profiling

DrawFn = Callable[[int, torch.Tensor, int, int], torch.Tensor]
PnpDrawFn = Callable[[int, torch.Tensor], torch.Tensor]
PNP_HYPOTHESES = 64  # RANSAC-PnP fallback hypotheses (the reference tracker's default)
_PNP_STREAM = 0x9E3779B97F4A7C15  # xor-ed into the seed of the RANSAC-PnP draws


def _stream_seed(seed: int, frame_idx: int, stream: int = 0) -> int:
    """64-bit generator seed of one frame's draws in one stream."""
    return (((seed & 0xFFFFFFFF) << 32) | (frame_idx & 0xFFFFFFFF)) ^ stream


class VoState(NamedTuple):
    """Cross-chunk carry: previous frame's features and global pose."""

    prev_kps: KeypointSet  # (K, ...)
    prev_desc: torch.Tensor  # (K, D) uint8
    prev_exists: torch.Tensor  # () bool — false before the first frame
    pose: torch.Tensor  # (4, 4) float32 — T_world_cam of the last frame
    frame_idx: int  # global index of the next frame (host counter)
    prev_depth: torch.Tensor  # (K,) float32 — global-scale depths of the last frame's keypoints
    prev_depth_valid: torch.Tensor  # (K,) bool


class ChunkResult(NamedTuple):
    poses: torch.Tensor  # (B, 4, 4) — T_world_cam per frame
    num_matches: torch.Tensor  # (B,) int32
    num_inliers: torch.Tensor  # (B,) int32
    pose_ok: torch.Tensor  # (B,) bool
    # with_features=True (for the full SLAM system):
    kps_xy: torch.Tensor | None = None  # (B, K, 2)
    kps_valid: torch.Tensor | None = None  # (B, K)
    desc: torch.Tensor | None = None  # (B, K, D) uint8
    m_query: torch.Tensor | None = None  # (B, M) int32 — into the previous frame's keypoints
    m_train: torch.Tensor | None = None  # (B, M) int32 — into the current frame's keypoints
    m_valid: torch.Tensor | None = None  # (B, M)
    points3d: torch.Tensor | None = None  # (B, M, 3) — current-camera coordinates, global scale
    point_ok: torch.Tensor | None = None  # (B, M)
    # PnP tracking (see model/tracking.py):
    pnp_used_ransac: torch.Tensor | None = None  # (B,) the RANSAC-PnP fallback ran
    pnp_absolute_ok: torch.Tensor | None = None  # (B,) the pose was solved against the map
    pnp_point_count0: torch.Tensor | None = None  # (B,) int32 — landmark-birth watermark
    pnp_kp_to_point: torch.Tensor | None = None  # (B, K) int32 — map slot per keypoint
    pnp_kp_birth: torch.Tensor | None = None  # (B, K) int32 — its allocation guard


class PnpState(NamedTuple):
    """Carry of PnP tracking: the VO carry, the persistent map and the landmark association."""

    vo: VoState
    map: MapState
    assoc: AssocState


def _stack_results(results: list[ChunkResult]) -> ChunkResult:
    """Chunk results stacked along a leading chunk axis (absent fields stay None)."""
    return ChunkResult(*(
        None if parts[0] is None else torch.stack(parts) for parts in zip(*results)
    ))


def _invert_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R|t] (cam2 ← cam1) → 4×4 T_cam1_cam2, batched."""
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., :, None])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim ignoring NaN, averaging the two middle values.

    ``torch.nanmedian`` returns the lower middle value; ``jnp.nanmedian``
    interpolates (lo·½ + hi·½ for an even count), which is what this does.
    All-NaN rows give NaN.
    """
    s = torch.sort(x, dim=-1).values  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=-1)
    q = 0.5 * (n.to(x.dtype) - 1.0)
    lo_i = torch.floor(q)
    hi_w = q - lo_i
    lo_w = 1.0 - hi_w
    lo = torch.clamp(lo_i.to(torch.int64), 0, x.shape[-1] - 1)
    hi = torch.clamp(torch.ceil(q).to(torch.int64), 0, x.shape[-1] - 1)
    lo_v = torch.gather(s, -1, lo[..., None])[..., 0]
    hi_v = torch.gather(s, -1, hi[..., None])[..., 0]
    out = lo_v * lo_w + hi_v * hi_w
    return torch.where(n > 0, out, float("nan"))


def _prefix_products(T: torch.Tensor) -> torch.Tensor:
    """(..., B, 4, 4) → cumulative products T_0, T_0·T_1, … along B (batched doubling scan)."""
    out = T.clone()
    step = 1
    while step < T.shape[-3]:
        out = torch.cat([out[..., :step, :, :], out[..., :-step, :, :] @ out[..., step:, :, :]], dim=-3)
        step *= 2
    return out


def _scatter_max(idx: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    """(B, M) values scattered by max into (B, size); index ``size`` is dropped."""
    buf = torch.zeros((idx.shape[0], size + 1), dtype=val.dtype, device=val.device)
    return buf.scatter_reduce(1, idx, val, "amax", include_self=True)[:, :size]


class SlamPipeline:
    """Batched monocular tracking on ``device`` (the card by default).

    ``tracking``: ``"vo"`` chains scaled two-view poses; ``"pnp"`` tracks
    each frame absolutely against a landmark map of ``map_window``
    keyframes and ``max_map_points`` points (``pnp_gn_iters`` motion-model
    Gauss-Newton rounds a frame; ``freeze_map`` for localization against a
    loaded map).  ``with_features`` adds the features, matches and
    triangulations to every ``ChunkResult``.  ``nms_fused`` is passed to the
    detector: kernel 5 (blur + FAST + NMS in one pass) on every level whose
    shape allows it, instead of kernel 1 and the separate NMS.  The
    keypoints are the same either way.
    """

    def __init__(
        self,
        camera: Camera,
        config: SlamConfig,
        tracking: str = "vo",
        device: torch.device | str = "cuda",
        draw_fn: DrawFn | None = None,
        with_features: bool = False,
        nms_fused: bool = False,
        map_window: int = 8,
        max_map_points: int = 8192,
        pnp_gn_iters: int = 3,
        freeze_map: bool = False,
        pnp_draw_fn: PnpDrawFn | None = None,
    ):
        if tracking not in ("vo", "pnp"):
            raise ValueError(f"unknown tracking mode {tracking!r}")
        self.camera = camera
        self.config = config
        self.tracking = tracking
        self.device = torch.device(device)
        self.draw_fn = draw_fn
        self.pnp_draw_fn = pnp_draw_fn
        self.with_features = with_features
        self.map_window = map_window
        self.max_map_points = max_map_points
        self.pnp_gn_iters = pnp_gn_iters
        self.freeze_map = freeze_map
        self.detector = FeatureDetector(config.detector, device=self.device, nms_fused=nms_fused)
        self.K = torch.as_tensor(camera.K, dtype=torch.float32).to(self.device)
        self.undistort_idx, self.undistort_valid = camera.device_undistort_map(self.device)
        self._generator = torch.Generator(device=self.device)

    # --- state ----------------------------------------------------------------
    def initial_state(self) -> VoState:
        k = self.config.detector.max_keypoints  # the pyramid's level capacities sum to it
        d = self.config.detector.descriptor_bytes
        dev = self.device
        empty = KeypointSet(
            xy=torch.zeros((k, 2), device=dev),
            response=torch.zeros((k,), device=dev),
            angle=torch.zeros((k,), device=dev),
            valid=torch.zeros((k,), dtype=torch.bool, device=dev),
        )
        return VoState(
            prev_kps=empty,
            prev_desc=torch.zeros((k, d), dtype=torch.uint8, device=dev),
            prev_exists=torch.tensor(False, device=dev),
            pose=torch.eye(4, device=dev),
            frame_idx=0,
            prev_depth=torch.zeros((k,), device=dev),
            prev_depth_valid=torch.zeros((k,), dtype=torch.bool, device=dev),
        )

    def initial_pnp_state(self) -> PnpState:
        return PnpState(
            vo=self.initial_state(),
            map=empty_map(self.map_window, self.max_map_points, self.device),
            assoc=empty_assoc(self.config.detector.max_keypoints, self.device),
        )

    # --- random draws ----------------------------------------------------------
    def _draws(self, fids: list[list[int]], n_valid: torch.Tensor, seeds: list[int], H: int,
               draw_fns: list[DrawFn | None]) -> torch.Tensor:
        """(S·B, H, S) two-view ranks, each frame's from its sequence's (seed, its global index) alone, or
        from that sequence's draw function."""
        S = self.config.pose.sample_size
        out = []
        for fs, seed, draw_fn in zip(fids, seeds, draw_fns):
            for f in fs:
                i = len(out)
                if draw_fn is not None:
                    r = draw_fn(f, n_valid[i], H, S)
                else:
                    self._generator.manual_seed(_stream_seed(seed, f))
                    r = draw_ranks(n_valid[i : i + 1], H, S, self._generator)[0]
                out.append(torch.as_tensor(r, device=self.device).to(torch.int64))
        return torch.stack(out)

    def _pnp_samples(self, fids: list[int], seed: int):
        """The tracker's RANSAC-PnP sampler: (H, 6) indices of chunk frame b from (seed, its index)."""

        def samples(b: int, valid: torch.Tensor) -> torch.Tensor:
            if self.pnp_draw_fn is not None:
                return torch.as_tensor(self.pnp_draw_fn(fids[b], valid), device=self.device)
            self._generator.manual_seed(_stream_seed(seed, fids[b], _PNP_STREAM))
            return gumbel_sample_indices(valid, PNP_HYPOTHESES, 6, self._generator)

        return samples

    # --- the chunk program -----------------------------------------------------
    def _two_view_stage(self, frames: torch.Tensor, frame_valid: torch.Tensor, states: list[VoState],
                        seeds: list[int], draw_fns: list[DrawFn | None] | None = None):
        """Undistort, detect, match consecutive pairs, RANSAC, triangulate: S sequences' (S, B, H, W)
        frames, (S, B) mask, carries, seeds and draw functions (default the pipeline's) → the S·B
        frames' outputs, sequence-major."""
        n_seq, B = frames.shape[:2]
        mcfg = self.config.matcher
        pcfg = self.config.pose
        with profiling.span("vo.undistort"):
            und = undistort_batch(frames.reshape(n_seq * B, *frames.shape[2:]), self.undistort_idx,
                                  self.undistort_valid)
        with profiling.span("vo.detect"):
            kps, desc = self.detector.detect_and_compute_batch(und)

        # consecutive pairs of each sequence: (prev, f0), (f0, f1), …, (f_{B-2}, f_{B-1})
        def pairs(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
            cur = cur.reshape(n_seq, B, *cur.shape[1:])
            return torch.cat([prev[:, None], cur[:, :-1]], dim=1).reshape(n_seq * B, *cur.shape[2:])

        with profiling.span("vo.match"):
            kps_q = KeypointSet(*(pairs(torch.stack(p), c)
                                  for p, c in zip(zip(*(st.prev_kps for st in states)), kps)))
            desc_q = pairs(torch.stack([st.prev_desc for st in states]), desc)
            frame_valid = frame_valid.reshape(n_seq * B)
            pair_ok = pairs(torch.stack([st.prev_exists for st in states]), frame_valid) & frame_valid

            match = match_descriptors(
                desc_q, desc, kps_q.valid, kps.valid, kps_q.xy, kps.xy,
                ratio_threshold=mcfg.ratio_test_threshold,
                max_jump_radius=mcfg.max_jump_radius,
                use_ratio_test=mcfg.use_ratio_test,
                filter_matches=False,
                use_spatial_penalty=True,
            )
            q = torch.clamp_min(match.query_idx, 0)
            t = torch.clamp_min(match.train_idx, 0)
            pts1 = torch.gather(kps_q.xy, 1, q[..., None].expand(*q.shape, 2))
            pts2 = torch.gather(kps.xy, 1, t[..., None].expand(*t.shape, 2))
            mvalid = match.valid & pair_ok[:, None]

        # In PnP mode the two-view pose only seeds the tracker, so it may run
        # at the smaller SeedNumHypotheses budget.
        n_hyp = pcfg.num_hypotheses
        if self.tracking == "pnp" and pcfg.seed_num_hypotheses:
            n_hyp = min(pcfg.seed_num_hypotheses, pcfg.num_hypotheses)
        with profiling.span("vo.draws"):
            fids = [[st.frame_idx + i for i in range(B)] for st in states]
            draws = self._draws(fids, mvalid.sum(dim=-1), seeds, n_hyp, draw_fns or [self.draw_fn] * n_seq)
        with profiling.span("vo.pose"):
            res = estimate_relative_pose(
                pts1, pts2, mvalid, self.K,
                draws=draws,
                num_hypotheses=n_hyp,
                sample_size=pcfg.sample_size,
                inlier_threshold_px=pcfg.inlier_threshold_px,
                min_matches=pcfg.min_matches,
            )

        with profiling.span("vo.triangulate"):
            X_prev = triangulate_matched_points(self.K, res.R, res.t, pts1, pts2)  # (B, M, 3)
            X_cur = torch.einsum("bij,bmj->bmi", res.R, X_prev) + res.t[:, None, :]
            z_prev = X_prev[..., 2]
            z_cur = X_cur[..., 2]
            mapc = self.config.map
            point_ok = (
                res.inliers
                & mvalid
                & (z_prev > mapc.min_triangulation_depth)
                & (z_prev < mapc.max_triangulation_depth)
                & (z_cur > mapc.min_triangulation_depth)
                & res.success[:, None]
            )
        return kps, desc, match, mvalid, res, X_prev, X_cur, point_ok

    def _to_device(self, frames, frame_valid) -> tuple[torch.Tensor, torch.Tensor, list[int]]:
        """Frames and mask on the pipeline's device, and the count of real frames along the last axis."""
        frame_valid = torch.as_tensor(frame_valid, dtype=torch.bool)
        n_real = frame_valid.sum(dim=-1).tolist()  # host knowledge when the mask comes from the host
        return torch.as_tensor(frames).to(self.device), frame_valid.to(self.device), n_real

    def _features(self, kps, desc, match, mvalid, points3d, point_ok) -> dict:
        if not self.with_features:
            return {}
        return dict(
            kps_xy=kps.xy, kps_valid=kps.valid, desc=desc,
            m_query=match.query_idx, m_train=match.train_idx, m_valid=mvalid,
            points3d=points3d, point_ok=point_ok,
        )

    def process_chunk(
        self, frames: torch.Tensor, frame_valid: torch.Tensor, state: VoState, seed: int = 0
    ) -> tuple[ChunkResult, VoState]:
        """One VO chunk: (B, H, W) uint8 frames, (B,) bool validity → (result, new carry)."""
        results, states = self.process_chunks(torch.as_tensor(frames)[None],
                                              torch.as_tensor(frame_valid, dtype=torch.bool)[None], [state], [seed])
        return results[0], states[0]

    def process_chunks(
        self,
        frames: torch.Tensor,  # (S, B, H, W) uint8
        frame_valid: torch.Tensor,  # (S, B) bool, a host mask
        states: list[VoState],
        seeds: list[int],
        draw_fns: list[DrawFn | None] | None = None,
    ) -> tuple[list[ChunkResult], list[VoState]]:
        """One VO chunk of each of S independent sequences as one batched step → (results, carries) by
        sequence; sequence s as ``process_chunk`` of its frames, carry and seed would give it, drawing
        from ``draw_fns[s]`` where given (default the pipeline's ``draw_fn``).

        While a ``torch.profiler`` session records, the step is a ``vo.step`` span tree in
        ``utils/profiling.py``'s recorder (``vo.upload``, ``vo.undistort``, ``vo.detect``, ``vo.match``,
        ``vo.draws``, ``vo.pose``, ``vo.triangulate``, ``vo.chain``) and, on a card, counts its
        synchronising CUDA calls under ``vo.host_syncs``."""
        syncs = "vo.host_syncs" if self.device.type == "cuda" else None
        with profiling.step("vo.step", sync_counter=syncs, S=len(states), B=frames.shape[1]):
            with profiling.span("vo.upload"):
                frames, frame_valid, n_real = self._to_device(frames, frame_valid)
            two_view = self._two_view_stage(frames, frame_valid, states, seeds, draw_fns)
            with profiling.span("vo.chain"):
                return self._scale_and_chain(states, n_real, *two_view)

    def _scale_and_chain(self, states: list[VoState], n_real: list[int], kps, desc, match, mvalid, res, X_prev,
                         X_cur, point_ok) -> tuple[list[ChunkResult], list[VoState]]:
        """VO after the two-view stage of S sequences' S·B frames: monocular scale from depth ratios, then
        the chained poses, each along its sequence's B frames."""
        n_seq = len(states)
        B = mvalid.shape[0] // n_seq
        z_prev = X_prev[..., 2]
        z_cur = X_cur[..., 2]

        # Monocular scale: depth ratios of keypoints shared by consecutive pairs.
        K_cap = kps.valid.shape[1]
        q_idx = torch.clamp_min(match.query_idx, 0)
        t_idx = torch.clamp_min(match.train_idx, 0)
        d_query = _scatter_max(torch.where(point_ok, q_idx, K_cap), torch.where(point_ok, z_prev, 0.0), K_cap)
        d_cur = _scatter_max(torch.where(point_ok, t_idx, K_cap), torch.where(point_ok, z_cur, 0.0), K_cap)
        d_prev = torch.stack([torch.where(st.prev_depth_valid, st.prev_depth, 0.0) for st in states])
        d_cur = d_cur.reshape(n_seq, B, K_cap)
        d_ref = torch.cat([d_prev[:, None], d_cur[:, :-1]], dim=1).reshape(n_seq * B, K_cap)
        common = (d_ref > 0) & (d_query > 0)
        ratio_kp = torch.where(common, d_ref / torch.clamp_min(d_query, 1e-9), float("nan"))
        n_common = common.sum(dim=1)
        ratios = torch.clamp(torch.nan_to_num(_nanmedian(ratio_kp), nan=1.0), 0.1, 10.0)
        ratios = torch.where((n_common >= 10) & res.success, ratios, 1.0)
        cumscale = torch.cumprod(ratios.reshape(n_seq, B), dim=1)  # (S, B)

        # Relative transforms with scaled baselines; failures → identity.
        eye4 = torch.eye(4, device=self.device)
        T_rel = _invert_rt(res.R, res.t * cumscale.reshape(-1)[:, None])
        T_rel = torch.where(res.success[:, None, None], T_rel, eye4)
        pose0 = torch.stack([st.pose for st in states])
        poses = pose0[:, None] @ _prefix_products(T_rel.reshape(n_seq, B, 4, 4))  # (S, B, 4, 4)

        points3d = X_cur * cumscale.reshape(-1)[:, None, None]
        features = self._features(kps, desc, match, mvalid, points3d, point_ok)
        num_matches = mvalid.sum(dim=-1, dtype=torch.int32)
        results, new_states = [], []
        with profiling.span("vo.split"):
            for s, (state, n) in enumerate(zip(states, n_real)):
                rows = slice(s * B, (s + 1) * B)
                i = max(n - 1, 0)  # the sequence's last real frame
                last = s * B + i
                carry_depth = d_cur[s, i] * cumscale[s, i]
                ok_last = res.success[last]
                new_states.append(VoState(
                    prev_kps=KeypointSet(*(a[last] for a in kps)),
                    prev_desc=desc[last],
                    prev_exists=state.prev_exists | (n > 0),
                    pose=poses[s, i],
                    frame_idx=state.frame_idx + n,
                    prev_depth=torch.where(ok_last, carry_depth, state.prev_depth),
                    prev_depth_valid=torch.where(ok_last, carry_depth > 0, state.prev_depth_valid),
                ))
                results.append(ChunkResult(
                    poses=poses[s],
                    num_matches=num_matches[rows],
                    num_inliers=res.num_inliers[rows],
                    pose_ok=res.success[rows],
                    **{k: v[rows] for k, v in features.items()},
                ))
        return results, new_states

    def process_chunk_pnp(
        self, frames: torch.Tensor, frame_valid: torch.Tensor, state: PnpState, seed: int = 0
    ) -> tuple[ChunkResult, PnpState]:
        """One PnP-tracking chunk: the two-view stage, then the tracker frame by frame."""
        from tpuslam_torch.model.tracking import pnp_track_chunk

        frames, frame_valid, n_real = self._to_device(frames, frame_valid)
        vo = state.vo
        kps, desc, match, mvalid, res, X_prev, X_cur, point_ok = self._two_view_stage(
            frames[None], frame_valid[None], [vo], [seed]
        )
        fids = [vo.frame_idx + i for i in range(frames.shape[0])]
        track, m_out, a_out, _ = pnp_track_chunk(
            state.map, state.assoc, self.K, vo.pose, fids, frame_valid, self._pnp_samples(fids, seed),
            res.R, res.t, res.success, kps.xy, match.query_idx, match.train_idx, mvalid,
            X_cur, X_prev[..., 2], point_ok,
            pnp_hypotheses=PNP_HYPOTHESES,
            gate_px=self.config.map.assoc_gate_px,
            min_cand_depth=self.config.map.min_candidate_depth,
            gn_iters=self.pnp_gn_iters,
            freeze_map=self.freeze_map,
        )
        last = max(n_real - 1, 0)
        new_vo = vo._replace(  # prev_depth is unused in PnP mode
            prev_kps=KeypointSet(*(a[last] for a in kps)),
            prev_desc=desc[last],
            prev_exists=vo.prev_exists | (n_real > 0),
            pose=track.poses[last],
            frame_idx=vo.frame_idx + n_real,
        )
        result = ChunkResult(
            poses=track.poses,
            num_matches=mvalid.sum(dim=-1, dtype=torch.int32),
            num_inliers=torch.where(track.pnp_ok, track.num_pnp_inliers, res.num_inliers),
            pose_ok=track.pnp_ok | res.success,
            # current-camera coordinates at the metric baseline the tracker applied
            **self._features(kps, desc, match, mvalid, X_cur * track.scale[:, None, None], point_ok),
            pnp_used_ransac=track.used_ransac,
            pnp_absolute_ok=track.pnp_ok,
            pnp_point_count0=track.point_count0,
            pnp_kp_to_point=track.kp_to_point,
            pnp_kp_birth=track.kp_birth,
        )
        return result, PnpState(vo=new_vo, map=m_out, assoc=a_out)

    def process_sequence(
        self,
        chunks: torch.Tensor,  # (C, B, H, W) uint8
        chunk_valid: torch.Tensor,  # (C, B) bool
        state: VoState,
        seed: int = 0,
    ) -> tuple[ChunkResult, VoState]:
        """Run every VO chunk in order; results are stacked along a leading chunk axis."""
        results = []
        for frames, valid in zip(chunks, chunk_valid):
            result, state = self.process_chunk(frames, valid, state, seed)
            results.append(result)
        return _stack_results(results), state

    def process_sequence_pnp(
        self,
        chunks: torch.Tensor,  # (C, B, H, W) uint8
        chunk_valid: torch.Tensor,  # (C, B) bool
        state: PnpState,
        seed: int = 0,
    ) -> tuple[ChunkResult, PnpState]:
        """Run every PnP-tracking chunk in order; results stacked along a leading chunk axis."""
        results = []
        for frames, valid in zip(chunks, chunk_valid):
            result, state = self.process_chunk_pnp(frames, valid, state, seed)
            results.append(result)
        return _stack_results(results), state

    def _drive(self, chunk_fn, frame_batches, seed: int, state) -> dict:
        """Chunks staged ahead on the device (``device_prefetch``); the outputs read back once at the end."""
        out: dict[str, list[torch.Tensor]] = {"poses": [], "num_matches": [], "num_inliers": [], "pose_ok": []}
        for frames, _stamps, valid in device_prefetch(frame_batches, self.device):
            result, state = chunk_fn(frames, torch.from_numpy(np.asarray(valid, dtype=bool)), state, seed)
            n = int(np.sum(valid))
            for k in out:
                out[k].append(getattr(result, k)[:n])
        merged = {
            k: torch.cat(v).cpu().numpy() if v else np.zeros((0, 4, 4) if k == "poses" else (0,))
            for k, v in out.items()
        }
        return {**merged, "state": state}

    def run(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        initial_state: VoState | None = None,
    ) -> dict:
        """Consume ``FrameStream.batches()`` → VO trajectory + per-frame stats (numpy)."""
        state = initial_state if initial_state is not None else self.initial_state()
        return self._drive(self.process_chunk, frame_batches, seed, state)

    def run_pnp(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        initial_state: PnpState | None = None,
    ) -> dict:
        """PnP tracking over ``FrameStream.batches()`` → trajectory, stats, ``map`` and ``state``."""
        state = initial_state if initial_state is not None else self.initial_pnp_state()
        out = self._drive(self.process_chunk_pnp, frame_batches, seed, state)
        return {**out, "map": out["state"].map}
