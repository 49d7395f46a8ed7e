"""Reference of one batched VO step: S sequences' chunks of B frames, each sequence carrying the
previous frame's features, its global pose and its keypoint depths.

``ReferenceVO.step`` takes the frames of the chunk, the frame before it,
and the carry (pose and depths at global scale, which depend on the whole
history), and returns every stage's output and the next carry.  Random
ranks come from a ``torch.Generator`` on the reference's device, seeded
from (sequence seed, global frame index) alone, as the configuration's
sampling rule states.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frontend import Detector, Keypoints, match, undistort, undistort_map
from portbench.reference.pose import draw_ranks, relative_pose, triangulate


class Carry(NamedTuple):
    pose: torch.Tensor  # (S, 4, 4) T_world_cam of the frame before the chunk
    depth: torch.Tensor  # (S, K) its keypoints' depths at global scale
    depth_valid: torch.Tensor  # (S, K) bool


class StepOut(NamedTuple):
    kps: Keypoints  # (S, B, K)
    desc: torch.Tensor  # (S, B, K, D)
    train_idx: torch.Tensor  # (S, B, K) int64, −1 where no match
    mvalid: torch.Tensor  # (S, B, K)
    R: torch.Tensor  # (S, B, 3, 3)
    t: torch.Tensor  # (S, B, 3)
    num_inliers: torch.Tensor  # (S, B)
    success: torch.Tensor  # (S, B)
    T_rel: torch.Tensor  # (S, B, 4, 4) scaled relative transforms (identity on failure)
    poses: torch.Tensor  # (S, B, 4, 4)
    carry: Carry


def stream_seed(seed: int, frame_idx: int) -> int:
    """The 64-bit generator seed of one frame's two-view draws."""
    return ((seed & 0xFFFFFFFF) << 32) | (frame_idx & 0xFFFFFFFF)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median over the last dim ignoring NaN, the two middle values averaged; all-NaN gives NaN."""
    s = torch.sort(x, dim=-1).values
    n = (~torch.isnan(x)).sum(dim=-1)
    q = 0.5 * (n.to(x.dtype) - 1.0)
    lo_i = torch.floor(q)
    hi_w = q - lo_i
    lo = torch.clamp(lo_i.to(torch.int64), 0, x.shape[-1] - 1)
    hi = torch.clamp(torch.ceil(q).to(torch.int64), 0, x.shape[-1] - 1)
    out = torch.gather(s, -1, lo[..., None])[..., 0] * (1.0 - hi_w) + torch.gather(s, -1, hi[..., None])[..., 0] * hi_w
    return torch.where(n > 0, out, float("nan"))


def _scatter_max(idx: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    buf = torch.zeros((idx.shape[0], size + 1), dtype=val.dtype, device=val.device)
    return buf.scatter_reduce(1, idx, val, "amax", include_self=True)[:, :size]


def _invert_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., :, None])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _prefix_products(T: torch.Tensor) -> torch.Tensor:
    out = T.clone()
    step = 1
    while step < T.shape[-3]:
        out = torch.cat([out[..., :step, :, :], out[..., :-step, :, :] @ out[..., step:, :, :]], dim=-3)
        step *= 2
    return out


class ReferenceVO:
    """The plain VO step of one configuration (its JSON's ``params``) on ``device``.  ``msac_operands``
    (the control only) rounds the hypothesis scores' operands to a lower precision."""

    def __init__(self, params: dict, device: torch.device | str, msac_operands: torch.dtype | None = None):
        self.p = params
        self.msac_operands = msac_operands
        self.device = torch.device(device)
        cam = params["camera"]
        K = np.asarray(cam["K"], dtype=np.float64).reshape(3, 3)
        flat, valid = undistort_map(K, np.asarray(cam["D"], dtype=np.float64), cam["width"], cam["height"])
        self.und_idx = torch.from_numpy(flat).to(self.device)
        self.und_valid = torch.from_numpy(valid).to(self.device)
        self.K = torch.as_tensor(K, dtype=torch.float32).to(self.device)
        self.detector = Detector(params["detector"], self.device)
        self.generator = torch.Generator(device=self.device)

    def empty(self, n: int) -> tuple[Keypoints, torch.Tensor, torch.Tensor]:
        """Features of 'no frame before': n invalid keypoint sets, zero descriptors, exists false."""
        k = self.p["detector"]["max_keypoints"]
        d = self.p["detector"]["num_brief_pairs"] // 8
        z = torch.zeros((n, k), device=self.device)
        kps = Keypoints(torch.zeros((n, k, 2), device=self.device), z, z.clone(), z.bool())
        return kps, torch.zeros((n, k, d), dtype=torch.uint8, device=self.device), torch.zeros(n, dtype=torch.bool,
                                                                                                 device=self.device)

    def initial_carry(self, n: int) -> Carry:
        k = self.p["detector"]["max_keypoints"]
        return Carry(torch.eye(4, device=self.device).expand(n, 4, 4).clone(),
                     torch.zeros((n, k), device=self.device), torch.zeros((n, k), dtype=torch.bool, device=self.device))

    def features(self, frames: torch.Tensor) -> tuple[Keypoints, torch.Tensor]:
        """(N, H, W) uint8 raw frames → undistorted, detected and described."""
        return self.detector(undistort(frames.to(self.device), self.und_idx, self.und_valid))

    def step(self, frames: torch.Tensor, prev: tuple[Keypoints, torch.Tensor, torch.Tensor], carry: Carry,
             first_fid: list[int], seeds: list[int]) -> StepOut:
        """(S, B, H, W) frames, every one real; ``prev`` the features of each sequence's frame before
        the chunk and whether it exists; ``first_fid`` each sequence's global index of frame 0."""
        S, B = frames.shape[:2]
        mp, pose_p = self.p["matcher"], self.p["pose"]
        kps, desc = self.features(frames.reshape(S * B, *frames.shape[2:]))
        K_cap = kps.valid.shape[1]

        def pairs(prev_x: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
            cur = cur.reshape(S, B, *cur.shape[1:])
            return torch.cat([prev_x[:, None], cur[:, :-1]], dim=1).reshape(S * B, *cur.shape[2:])

        pk, pd, exists = prev
        kq = Keypoints(*(pairs(a, c) for a, c in zip(pk, kps)))
        dq = pairs(pd, desc)
        pair_ok = pairs(exists, torch.ones(S * B, dtype=torch.bool, device=self.device))
        m = match(dq, desc, kq.valid, kps.valid, kq.xy, kps.xy, mp["ratio_test_threshold"], mp["max_jump_radius"])
        mvalid = m.valid & pair_ok[:, None]
        q = torch.arange(K_cap, device=self.device).expand(S * B, K_cap)
        t_idx = torch.clamp_min(m.train_idx, 0)
        pts1 = torch.gather(kq.xy, 1, q[..., None].expand(*q.shape, 2))
        pts2 = torch.gather(kps.xy, 1, t_idx[..., None].expand(*t_idx.shape, 2))

        H, n_s = pose_p["num_hypotheses"], pose_p["sample_size"]
        n_valid = mvalid.sum(dim=-1)
        draws = []
        for s in range(S):
            for b in range(B):
                i = s * B + b
                self.generator.manual_seed(stream_seed(seeds[s], first_fid[s] + b))
                draws.append(draw_ranks(n_valid[i : i + 1], H, n_s, self.generator)[0])
        res = relative_pose(pts1, pts2, mvalid, self.K, torch.stack(draws), pose_p["inlier_threshold_px"],
                            pose_p["min_matches"], self.msac_operands)

        X_prev = triangulate(self.K, res.R, res.t, pts1, pts2)
        X_cur = torch.einsum("bij,bmj->bmi", res.R, X_prev) + res.t[:, None, :]
        z_prev, z_cur = X_prev[..., 2], X_cur[..., 2]
        mc = self.p["map"]
        point_ok = (res.inliers & mvalid & (z_prev > mc["min_triangulation_depth"])
                    & (z_prev < mc["max_triangulation_depth"]) & (z_cur > mc["min_triangulation_depth"])
                    & res.success[:, None])

        # depth-ratio scale of keypoints seen by consecutive pairs, chained along each sequence
        d_query = _scatter_max(torch.where(point_ok, q, K_cap), torch.where(point_ok, z_prev, 0.0), K_cap)
        d_cur = _scatter_max(torch.where(point_ok, t_idx, K_cap), torch.where(point_ok, z_cur, 0.0), K_cap)
        d_prev = torch.where(carry.depth_valid, carry.depth, 0.0)
        d_cur = d_cur.reshape(S, B, K_cap)
        d_ref = torch.cat([d_prev[:, None], d_cur[:, :-1]], dim=1).reshape(S * B, K_cap)
        common = (d_ref > 0) & (d_query > 0)
        ratio_kp = torch.where(common, d_ref / torch.clamp_min(d_query, 1e-9), float("nan"))
        ratios = torch.clamp(torch.nan_to_num(_nanmedian(ratio_kp), nan=1.0), 0.1, 10.0)
        ratios = torch.where((common.sum(dim=1) >= 10) & res.success, ratios, 1.0)
        cumscale = torch.cumprod(ratios.reshape(S, B), dim=1)
        T_rel = _invert_rt(res.R, res.t * cumscale.reshape(-1)[:, None])
        T_rel = torch.where(res.success[:, None, None], T_rel, torch.eye(4, device=self.device))
        poses = carry.pose[:, None] @ _prefix_products(T_rel.reshape(S, B, 4, 4))

        last_depth = d_cur[:, -1] * cumscale[:, -1:]
        ok_last = res.success.reshape(S, B)[:, -1:]
        new = Carry(poses[:, -1], torch.where(ok_last, last_depth, carry.depth),
                    torch.where(ok_last, last_depth > 0, carry.depth_valid))

        def per_frame(x):
            return x.reshape(S, B, *x.shape[1:])

        return StepOut(
            kps=Keypoints(*(per_frame(a) for a in kps)), desc=per_frame(desc), train_idx=per_frame(m.train_idx),
            mvalid=per_frame(mvalid), R=per_frame(res.R), t=per_frame(res.t),
            num_inliers=per_frame(res.num_inliers), success=per_frame(res.success),
            T_rel=T_rel.reshape(S, B, 4, 4), poses=poses, carry=new,
        )
