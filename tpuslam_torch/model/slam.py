"""SlamPipeline, VO mode: the batched monocular visual-odometry pipeline.

Port of ``tpuslam/model/slam.py`` (``VoState``, ``ChunkResult``,
``initial_state``, ``_two_view_stage``, ``_process_chunk``,
``process_sequence``, ``run``).  One chunk of B frames runs, in order:
undistort gather; detector (kernels 1-3, or 5, 2 and 3, on each pyramid
level); matching of consecutive pairs;
two-view RANSAC (kernel 4); triangulation; depth-ratio scale propagation;
relative transforms chained into global poses.  The carry between chunks
holds the last frame's features, its global pose and its keypoint depths.

Random draws depend only on (seed, global frame index), never on where
chunk boundaries fall.  ``draw_fn(frame_idx, n_valid, H, S)`` may supply
them (a test passes the reference package's draws); by default each frame's
(H, S) ranks come from the pipeline's ``torch.Generator`` reseeded with
``(seed, frame_idx)``.

Not ported yet: PnP tracking (``tracking="pnp"``) and ``with_features``.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple

import numpy as np
import torch

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

DrawFn = Callable[[int, torch.Tensor, int, int], torch.Tensor]


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
    """(B, 4, 4) → cumulative products T_0, T_0·T_1, … (batched doubling scan)."""
    out = T.clone()
    step = 1
    while step < T.shape[0]:
        out = torch.cat([out[:step], out[:-step] @ out[step:]], dim=0)
        step *= 2
    return out


def _scatter_max(idx: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    """(B, M) values scattered by max into (B, size); index ``size`` is dropped."""
    buf = torch.zeros((idx.shape[0], size + 1), dtype=val.dtype, device=val.device)
    return buf.scatter_reduce(1, idx, val, "amax", include_self=True)[:, :size]


class SlamPipeline:
    """Batched monocular visual odometry (``tracking="vo"``) on ``device`` (the card by default).

    ``nms_fused`` is passed to the detector: kernel 5 (blur + FAST + NMS in
    one pass) on every level whose shape allows it, instead of kernel 1 and
    the separate NMS.  The keypoints are the same either way.
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
    ):
        if tracking != "vo":
            raise NotImplementedError(f"tracking={tracking!r} is not ported yet (only 'vo')")
        if with_features:
            raise NotImplementedError("with_features=True (the full SLAM system) is not ported yet")
        self.camera = camera
        self.config = config
        self.device = torch.device(device)
        self.draw_fn = draw_fn
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

    # --- random draws ----------------------------------------------------------
    def _draws(self, fids: list[int], n_valid: torch.Tensor, seed: int) -> torch.Tensor:
        """(B, H, S) ranks, each frame's from (seed, its global index) alone."""
        pcfg = self.config.pose
        H, S = pcfg.num_hypotheses, pcfg.sample_size
        out = []
        for i, f in enumerate(fids):
            if self.draw_fn is not None:
                r = self.draw_fn(f, n_valid[i], H, S)
            else:
                self._generator.manual_seed(((seed & 0xFFFFFFFF) << 32) | (f & 0xFFFFFFFF))
                r = draw_ranks(n_valid[i : i + 1], H, S, self._generator)[0]
            out.append(torch.as_tensor(r, device=self.device).to(torch.int64))
        return torch.stack(out)

    # --- the chunk program -----------------------------------------------------
    def _two_view_stage(self, frames: torch.Tensor, frame_valid: torch.Tensor, state: VoState, seed: int):
        """Undistort, detect, match consecutive pairs, RANSAC, triangulate."""
        B = frames.shape[0]
        mcfg = self.config.matcher
        pcfg = self.config.pose
        und = undistort_batch(frames, self.undistort_idx, self.undistort_valid)
        kps, desc = self.detector.detect_and_compute_batch(und)

        # consecutive pairs: (prev, f0), (f0, f1), …, (f_{B-2}, f_{B-1})
        kps_q = KeypointSet(*(torch.cat([p[None], c[:-1]]) for p, c in zip(state.prev_kps, kps)))
        desc_q = torch.cat([state.prev_desc[None], desc[:-1]])
        pair_ok = torch.cat([state.prev_exists[None], frame_valid[:-1]]) & frame_valid

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

        fids = [state.frame_idx + i for i in range(B)]
        draws = self._draws(fids, mvalid.sum(dim=-1), seed)
        res = estimate_relative_pose(
            pts1, pts2, mvalid, self.K,
            draws=draws,
            num_hypotheses=pcfg.num_hypotheses,
            sample_size=pcfg.sample_size,
            inlier_threshold_px=pcfg.inlier_threshold_px,
            min_matches=pcfg.min_matches,
        )

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
        return kps, desc, match, mvalid, res, z_prev, z_cur, point_ok

    def process_chunk(
        self, frames: torch.Tensor, frame_valid: torch.Tensor, state: VoState, seed: int = 0
    ) -> tuple[ChunkResult, VoState]:
        """One chunk: (B, H, W) uint8 frames, (B,) bool validity → (result, new carry)."""
        frame_valid = torch.as_tensor(frame_valid, dtype=torch.bool)
        n_real = int(frame_valid.sum())  # host knowledge when the mask comes from the host
        frames = torch.as_tensor(frames).to(self.device)
        frame_valid = frame_valid.to(self.device)
        kps, desc, match, mvalid, res, z_prev, z_cur, point_ok = self._two_view_stage(
            frames, frame_valid, state, seed
        )

        # Monocular scale: depth ratios of keypoints shared by consecutive pairs.
        K_cap = kps.valid.shape[1]
        q_idx = torch.clamp_min(match.query_idx, 0)
        t_idx = torch.clamp_min(match.train_idx, 0)
        d_query = _scatter_max(torch.where(point_ok, q_idx, K_cap), torch.where(point_ok, z_prev, 0.0), K_cap)
        d_cur = _scatter_max(torch.where(point_ok, t_idx, K_cap), torch.where(point_ok, z_cur, 0.0), K_cap)
        d_ref = torch.cat(
            [torch.where(state.prev_depth_valid, state.prev_depth, 0.0)[None], d_cur[:-1]]
        )
        common = (d_ref > 0) & (d_query > 0)
        ratio_kp = torch.where(common, d_ref / torch.clamp_min(d_query, 1e-9), float("nan"))
        n_common = common.sum(dim=1)
        ratios = torch.clamp(torch.nan_to_num(_nanmedian(ratio_kp), nan=1.0), 0.1, 10.0)
        ratios = torch.where((n_common >= 10) & res.success, ratios, 1.0)
        cumscale = torch.cumprod(ratios, dim=0)

        # Relative transforms with scaled baselines; failures → identity.
        eye4 = torch.eye(4, device=self.device)
        T_rel = _invert_rt(res.R, res.t * cumscale[:, None])
        T_rel = torch.where(res.success[:, None, None], T_rel, eye4)
        poses = state.pose[None] @ _prefix_products(T_rel)

        last = max(n_real - 1, 0)
        carry_depth = d_cur[last] * cumscale[last]
        ok_last = res.success[last]
        new_state = VoState(
            prev_kps=KeypointSet(*(a[last] for a in kps)),
            prev_desc=desc[last],
            prev_exists=state.prev_exists | (n_real > 0),
            pose=poses[last],
            frame_idx=state.frame_idx + n_real,
            prev_depth=torch.where(ok_last, carry_depth, state.prev_depth),
            prev_depth_valid=torch.where(ok_last, carry_depth > 0, state.prev_depth_valid),
        )
        result = ChunkResult(
            poses=poses,
            num_matches=mvalid.sum(dim=-1, dtype=torch.int32),
            num_inliers=res.num_inliers,
            pose_ok=res.success,
        )
        return result, new_state

    def process_sequence(
        self,
        chunks: torch.Tensor,  # (C, B, H, W) uint8
        chunk_valid: torch.Tensor,  # (C, B) bool
        state: VoState,
        seed: int = 0,
    ) -> tuple[ChunkResult, VoState]:
        """Run every chunk in order; results are stacked along a leading chunk axis."""
        results = []
        for frames, valid in zip(chunks, chunk_valid):
            result, state = self.process_chunk(frames, valid, state, seed)
            results.append(result)
        return ChunkResult(*(torch.stack(parts) for parts in zip(*results))), state

    def run(
        self,
        frame_batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
        seed: int = 0,
        initial_state: VoState | None = None,
    ) -> dict:
        """Consume ``FrameStream.batches()`` → trajectory + per-frame stats (numpy)."""
        state = initial_state if initial_state is not None else self.initial_state()
        out: dict[str, list[np.ndarray]] = {
            "poses": [], "num_matches": [], "num_inliers": [], "pose_ok": []
        }
        for frames, _stamps, valid in frame_batches:
            result, state = self.process_chunk(
                torch.from_numpy(np.ascontiguousarray(frames)), torch.from_numpy(valid), state, seed
            )
            n = int(valid.sum())
            for k in out:
                out[k].append(getattr(result, k)[:n].cpu().numpy())
        merged = {
            k: np.concatenate(v) if v else np.zeros((0, 4, 4) if k == "poses" else (0,))
            for k, v in out.items()
        }
        return {**merged, "state": state}
