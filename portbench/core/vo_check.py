"""What decides ``correct`` in a fleet cell: the timed step's own outputs against the plain reference.

The window keeps, for a sample of its steps, what the step produced for
every sequence: the carry it was handed, the features, matches, pose
counts and chained poses it returned (the poses as the host read them),
and the carry it handed on.  Steps 0, 1 and 2 are always in the sample;
the reference runs them from the start with its own carry, so the start
and the chaining over three steps are checked without anything the
program made.  For later sampled steps the reference follows the program
step by step: it takes the program's carried pose and keypoint depths
(global-scale quantities that depend on the whole history) and works out
everything else again from the frames, including the features of the
frame before the chunk, which it holds against the program's carry.

``compare`` returns the numbers a cell's workload file may hold to limits:
counts of integer disagreements and the widest float gaps.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.frontend import Keypoints
from portbench.reference.vo import Carry, ReferenceVO


@dataclass
class Sample:
    k: int  # the step's index in the window
    states_in: list  # the carry each sequence was handed
    results: list  # what the step returned for each sequence
    states_out: list  # the carry it handed on
    poses: np.ndarray  # (S, B, 4, 4) the poses as read back to the host


@dataclass
class Reservoir:
    """Steps 0-2 always, and a uniform sample of ``size`` of the later ones, drawn from ``seed``."""

    size: int
    seed: int
    fixed: int = 3
    kept: list = field(default_factory=list)
    _seen: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng([self.seed, 0x5EED])

    def offer(self, make) -> None:
        """Consider the next step; ``make()`` builds its sample only when it is kept."""
        k = self._seen
        self._seen += 1
        if k < self.fixed:
            self.kept.append(make())
            return
        later = [s for s in self.kept if s.k >= self.fixed]
        if len(later) < self.size:
            self.kept.append(make())
            return
        j = int(self._rng.integers(0, k - self.fixed + 1))
        if j < self.size:
            self.kept.remove(later[j])
            self.kept.append(make())


def _angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations from the chord, 2·asin(‖Ra − Rb‖_F / √8): well conditioned near zero,
    where arccos of the trace would turn float32 round-off into 0.03°."""
    chord = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / np.sqrt(8.0)
    return np.degrees(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0)))


def _relative(poses: np.ndarray, pose0: np.ndarray) -> np.ndarray:
    """(B, 4, 4) inv(P[b−1]) · P[b] in float64, P[−1] = pose0."""
    prev = np.concatenate([pose0[None], poses[:-1]]).astype(np.float64)
    return np.linalg.inv(prev) @ poses.astype(np.float64)


def _diff(a: torch.Tensor, b: torch.Tensor, vec: bool = False) -> int:
    """Entries that differ at all; with ``vec`` an entry is a vector along the last dim."""
    ne = a != b
    return int((ne.any(dim=-1) if vec else ne).sum())


class Numbers:
    def __init__(self):
        self.v = {"frontend": 0, "matches": 0, "success": 0, "inliers": 0, "rot_deg": 0.0, "trans": 0.0,
                  "chain": 0.0, "chain_rot_deg": 0.0, "depth": 0.0, "depth_flip": 0.0}
        self.frames = 0

    def count(self, key, n):
        self.v[key] += int(n)

    def widest(self, key, x):
        if np.isfinite(x):
            self.v[key] = max(self.v[key], float(x))
        else:
            self.v[key] = float("inf")


def compare(samples: list[Sample], frames_of, ref: ReferenceVO, chunk: int, seeds: list[int],
            group: int) -> tuple[dict, int]:
    """Numbers of the sampled steps against the reference; ``frames_of(k)`` gives step k's (S, B, H, W)
    frames and ``frames_of(k, last=True)`` the (S, H, W) frame before step k+1.  Also the frames
    compared."""
    out = Numbers()
    samples = sorted(samples, key=lambda s: s.k)
    own: tuple | None = None  # the reference's own (prev features, carry) after the previous scratch step
    for smp in samples:
        k = smp.k
        S = len(smp.results)
        frames = frames_of(k)
        if k < 3 and (k == 0 or own is not None):
            prev, carry = (ref.empty(S), ref.initial_carry(S)) if k == 0 else own
        else:
            pk, pd = ref.features(frames_of(k - 1, last=True))
            prev = (pk, pd, torch.ones(S, dtype=torch.bool, device=ref.device))
            st = smp.states_in
            carry = Carry(torch.stack([s.pose for s in st]).to(ref.device),
                          torch.stack([s.prev_depth for s in st]).to(ref.device),
                          torch.stack([s.prev_depth_valid for s in st]).to(ref.device))
        parts = []
        for g in range(0, S, group):
            sl = slice(g, min(S, g + group))
            parts.append(ref.step(frames[sl], (Keypoints(*(a[sl] for a in prev[0])), prev[1][sl], prev[2][sl]),
                                  Carry(*(a[sl] for a in carry)), [k * chunk] * (sl.stop - sl.start), seeds[sl]))
        r = type(parts[0])(*(
            Keypoints(*(torch.cat([p.kps[i] for p in parts]) for i in range(4))) if f == "kps"
            else Carry(*(torch.cat([p.carry[i] for p in parts]) for i in range(3))) if f == "carry"
            else torch.cat([getattr(p, f) for p in parts])
            for f in parts[0]._fields))
        if k < 3:
            own = ((Keypoints(*(a[:, -1] for a in r.kps)), r.desc[:, -1], torch.ones(S, dtype=torch.bool,
                                                                                      device=ref.device)), r.carry)
        _compare_step(out, smp, r, prev, carry, k, chunk)
        out.frames += S * frames.shape[1]
    return out.v, out.frames


def _compare_step(out: Numbers, smp: Sample, r, prev, carry, k: int, chunk: int) -> None:
    dev = r.desc.device
    for s, (st, res, so) in enumerate(zip(smp.states_in, smp.results, smp.states_out)):
        # the carry handed in: the previous frame's features and the frame counter
        exists = k > 0
        out.count("frontend", int(bool(st.prev_exists) != exists) + int(int(st.frame_idx) != k * chunk))
        if exists:
            for i, (got, want) in enumerate(zip(st.prev_kps, (prev[0].xy[s], prev[0].response[s], prev[0].angle[s],
                                                               prev[0].valid[s]))):
                out.count("frontend", _diff(got.to(dev), want, vec=i == 0))
            out.count("frontend", _diff(st.prev_desc.to(dev), prev[1][s], vec=True))
        # features and matches of every frame
        out.count("frontend", _diff(res.kps_xy.to(dev), r.kps.xy[s], vec=True) + _diff(res.kps_valid.to(dev), r.kps.valid[s])
                  + _diff(res.desc.to(dev), r.desc[s], vec=True))
        mv_p, mv_r = res.m_valid.to(dev), r.mvalid[s]
        out.count("matches", int((mv_p != mv_r).sum()) + int(((res.m_train.to(dev) != r.train_idx[s]) & mv_p & mv_r).sum()))
        # the pose of each pair
        ok_p = res.pose_ok.cpu().numpy()
        ok_r = r.success[s].cpu().numpy()
        out.count("success", int((ok_p != ok_r).sum()))
        both = ok_p & ok_r
        if both.any():
            d_inl = np.abs(res.num_inliers.cpu().numpy().astype(np.int64) - r.num_inliers[s].cpu().numpy())
            out.widest("inliers", d_inl[both].max())
        rel_p = _relative(smp.poses[s], st.pose.double().cpu().numpy())
        rel_r = r.T_rel[s].double().cpu().numpy()
        if both.any():
            out.widest("rot_deg", _angle_deg(rel_p[both, :3, :3], rel_r[both, :3, :3]).max())
            tn = np.linalg.norm(rel_r[both, :3, 3], axis=-1)
            out.widest("trans", (np.linalg.norm(rel_p[both, :3, 3] - rel_r[both, :3, 3], axis=-1) / np.maximum(tn, 1e-9)).max())
        # the chained poses: the gap over the distance travelled since the carried pose
        pr = r.poses[s].double().cpu().numpy()
        travel = np.cumsum(np.linalg.norm(rel_r[:, :3, 3], axis=-1))
        gap = np.linalg.norm(smp.poses[s][:, :3, 3].astype(np.float64) - pr[:, :3, 3], axis=-1)
        rot = _angle_deg(smp.poses[s][:, :3, :3].astype(np.float64), pr[:, :3, :3])
        moved = travel > 0
        if moved.any():
            out.widest("chain", (gap[moved] / travel[moved]).max())
        out.widest("chain_rot_deg", rot.max())
        # the carry handed on: pose and keypoint depths
        out.widest("chain", np.linalg.norm(so.pose.double().cpu().numpy()[:3, 3] - pr[-1, :3, 3])
                   / max(travel[-1], 1e-9) if travel[-1] > 0 else 0.0)
        dp, vp = so.prev_depth.to(dev).double(), so.prev_depth_valid.to(dev)
        dr, vr = r.carry.depth[s].double(), r.carry.depth_valid[s]
        union = vp | vr
        if bool(union.any()):
            out.widest("depth_flip", float((vp != vr).sum()) / float(union.sum()))
        both_d = vp & vr
        if bool(both_d.any()):
            rel = ((dp - dr).abs() / dr.clamp_min(1e-12))[both_d]
            out.widest("depth", float(rel.median()))


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """Correct when every number held to a limit is at most it; the rows (name, number, limit)."""
    rows = [(name, float(numbers[name]), float(limit)) for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows

