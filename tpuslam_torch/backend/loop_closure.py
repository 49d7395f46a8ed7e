"""Loop closure: BoW place recognition, RANSAC DLT-PnP verification, relocalization.

Port of ``tpuslam/backend/loop_closure.py``.  The keyframe database is a
fixed-capacity ring of tensors (``KeyframeDB``); every function returns a
new one.  Detection for frame i of a chunk sees the database as of frame
i − 1 (detect, then add), computed for the whole chunk at once: the per-frame
gate state (database size, last inserted id) is a cumsum and a prefix max
over the enabled mask, and the scores are a (B, C) matrix against the
database plus a (B, B) one against the chunk's own earlier keyframes.  The
insert writes the enabled rows into B ring slots in one indexed copy:
oldest-first, or, on overflow under ``EvictionPolicy: redundancy``, the
rows the rest of the database best duplicates.

The reference skips work under three ``lax.cond`` branches.  Here each predicate
is read on the host once a chunk and only the branch needed runs:
``_process_chunk_impl`` reads the ring's overflow flag and the candidate
mask in one transfer and verifies only the candidate frames (at most
``VerifyBudget``; a non-candidate the reference verifies reports zeros, as
it does there); the relocalization caller reads ``need`` (see
``model/system.py``), and ``_relocalize_impl`` itself does not sync.

Verification and relocalization solve their V candidates together, as the
reference vmaps them: one batched ``ransac_pnp`` over the candidate axis
(and, in relocalization, one batched ``motion_pnp`` polish), each candidate
with its own samples.

Random draws are injected.  Verification takes a ``PnpSampler``:
``sampler(positions, valid, H)`` returns the (V, H, 6) RANSAC-PnP sample
indices of the chunk frames at ``positions`` given their (V, M) usable
matches.  Relocalization takes ``RelocDraws``: ``draws(sel, pnp_valid,
n_valid, H)`` returns those samples and the (V, 1024, 5) five-point ranks
of the chunk frames ``sel`` (a device tensor).  Ties break as ``lax.top_k`` and
``jnp.argsort`` break them: lowest index first, through stable sorts.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple

import torch

from tpuslam_torch.backend.pnp import gumbel_sample_indices, motion_pnp, ransac_pnp
from tpuslam_torch.backend.vocabulary import Vocabulary
from tpuslam_torch.config.schema import LoopClosureConfig, MatcherConfig
from tpuslam_torch.frontend.matcher import match_descriptors
from tpuslam_torch.frontend.pose import estimate_relative_pose, triangulate_matched_points
from tpuslam_torch.model.slam import _nanmedian

PnpSampler = Callable[[list, torch.Tensor, int], torch.Tensor]
RelocDraws = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], tuple]
RELOC_HYPOTHESES = 1024  # five-point RANSAC hypotheses of a relocalization
_INT32_MIN = torch.iinfo(torch.int32).min + 1


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe database."""

    bow: torch.Tensor  # (C, W) float32 — L2-normalised TF-IDF vectors
    xy: torch.Tensor  # (C, K, 2) float32 — keypoint pixel coords
    kp_valid: torch.Tensor  # (C, K) bool
    descriptors: torch.Tensor  # (C, K, D) uint8
    map_points: torch.Tensor  # (C, K, 3) float32 — 3D point per keypoint, keyframe camera frame
    mp_valid: torch.Tensor  # (C, K) bool
    pose: torch.Tensor  # (C, 4, 4) float32 — T_world_cam at insert (the relocalization anchor)
    ids: torch.Tensor  # (C,) int32 — keyframe ids (−1 = empty slot)
    count: torch.Tensor  # () int32 — keyframes ever stored
    last_id: torch.Tensor  # () int32 — id of the last added keyframe

    @property
    def capacity(self) -> int:
        return self.bow.shape[0]


class LoopResult(NamedTuple):
    """The reference's optional<LoopResult> as explicit flags; (B,) leading dim on the chunk path."""

    matched_keyframe_id: torch.Tensor  # int32 (−1 when no loop)
    relative_transform: torch.Tensor  # (4, 4) float32: x_query = T·x_cand
    num_inliers: torch.Tensor  # int32
    candidate_id: torch.Tensor  # int32 — the BoW candidate before verification
    bow_score: torch.Tensor  # float32
    success: torch.Tensor  # bool


def empty_db(capacity: int, num_words: int, max_keypoints: int, desc_bytes: int,
             device: torch.device | str = "cpu") -> KeyframeDB:
    dev = torch.device(device)
    return KeyframeDB(
        bow=torch.zeros((capacity, num_words), device=dev),
        xy=torch.zeros((capacity, max_keypoints, 2), device=dev),
        kp_valid=torch.zeros((capacity, max_keypoints), dtype=torch.bool, device=dev),
        descriptors=torch.zeros((capacity, max_keypoints, desc_bytes), dtype=torch.uint8, device=dev),
        map_points=torch.zeros((capacity, max_keypoints, 3), device=dev),
        mp_valid=torch.zeros((capacity, max_keypoints), dtype=torch.bool, device=dev),
        pose=torch.eye(4, device=dev).expand(capacity, 4, 4).clone(),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        last_id=torch.full((), -1, dtype=torch.int32, device=dev),
    )


def generator_sampler(seed: int = 0) -> PnpSampler:
    """Samples from a generator reseeded from (seed, chunk position): ``detect``'s default."""

    def sampler(positions, valid, H):
        gen = torch.Generator(device=valid.device)
        out = []
        for p, v in zip(positions, valid):
            gen.manual_seed((seed << 32) | int(p))
            out.append(gumbel_sample_indices(v, H, 6, gen))
        return torch.stack(out)

    return sampler


def _rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) + (…, 3) → (…, 4, 4) [R|t] with bottom row [0 0 0 1]."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first dim for a device index tensor."""
    return x.index_select(0, idx)


class LoopClosure:
    """Config-bound loop closure on ``device``, mirroring the reference's ``LoopClosure``."""

    def __init__(
        self,
        vocabulary: Vocabulary | str | Path,
        config: LoopClosureConfig | str | Path,
        matcher_config: MatcherConfig | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if not isinstance(vocabulary, Vocabulary):
            vocabulary = Vocabulary.load(vocabulary, device=self.device)
        elif vocabulary.device != self.device:
            vocabulary = vocabulary.to(self.device)
        if not isinstance(config, LoopClosureConfig):
            config = LoopClosureConfig.from_yaml(config)
        self.vocabulary = vocabulary
        self.config = config
        self.matcher_config = matcher_config or MatcherConfig()

    def new_db(self, max_keypoints: int, desc_bytes: int = 32) -> KeyframeDB:
        return empty_db(self.config.max_keyframes, self.vocabulary.num_words, max_keypoints, desc_bytes,
                        self.device)

    @property
    def verify_hypotheses(self) -> int:
        # RansacMaxIterations assumes a sequential early-exit RANSAC: a floor of 512 batched hypotheses
        return max(self.config.ransac_max_iterations, 512)

    # --- addKeyframe -----------------------------------------------------------------
    def add_keyframe(self, db: KeyframeDB, keyframe_id: int, descriptors, xy, kp_valid, map_points,
                     mp_valid=None, pose=None) -> KeyframeDB:
        """Insert one keyframe at the next ring slot (this single-keyframe API always recycles FIFO)."""
        return self._add_impl(db, keyframe_id, descriptors, xy, kp_valid, map_points,
                              kp_valid if mp_valid is None else mp_valid, pose)

    def _add_impl(self, db, keyframe_id, descriptors, xy, kp_valid, map_points, mp_valid, pose=None):
        """Ring insert of one keyframe at slot ``count mod C``."""
        dev = db.bow.device
        slot = torch.remainder(db.count, db.capacity).reshape(1).to(torch.int64)
        if pose is None:
            pose = torch.eye(4, device=dev)
        kid = torch.as_tensor(keyframe_id, dtype=torch.int32, device=dev)

        def write(buf, new):
            out = buf.clone()
            out.index_copy_(0, slot, torch.as_tensor(new, device=dev).to(buf.dtype)[None])
            return out

        return KeyframeDB(
            bow=write(db.bow, self.vocabulary.transform(descriptors, kp_valid)), xy=write(db.xy, xy),
            kp_valid=write(db.kp_valid, kp_valid), descriptors=write(db.descriptors, descriptors),
            map_points=write(db.map_points, map_points), mp_valid=write(db.mp_valid, mp_valid),
            pose=write(db.pose, pose), ids=write(db.ids, kid),
            count=db.count + 1, last_id=kid,
        )

    # --- detect ----------------------------------------------------------------------
    def _gates_impl(self, db: KeyframeDB, bow_q: torch.Tensor):
        """BoW gates of one query against the database → (best_slot, cand_id, candidate_ok, max_score)."""
        cfg = self.config
        scores = db.bow @ bow_q
        occupied = db.ids >= 0
        eligible = occupied & ((db.last_id - db.ids).abs() >= cfg.min_frames_difference)
        masked = torch.where(eligible, scores, -torch.inf)
        best_slot = torch.argmax(masked)
        max_score = masked[best_slot]
        if cfg.second_best_grouped:
            near_best = (db.ids - db.ids[best_slot]).abs() < cfg.min_frames_difference
        else:
            near_best = torch.arange(db.capacity, device=db.bow.device) == best_slot
        second = torch.clamp_min(torch.where(eligible & ~near_best, scores, -torch.inf).max(), 0.0)
        candidate_ok = (
            (db.count >= cfg.min_db_size)
            & (bow_q.sum() > 0)
            & eligible.any()
            & (max_score >= cfg.min_absolute_score)
            & (max_score >= cfg.relative_score_factor * second)
        )
        cand_id = torch.where(candidate_ok, db.ids[best_slot], -1)
        return best_slot, cand_id, candidate_ok, max_score

    def detect(self, db: KeyframeDB, descriptors, xy, kp_valid, K, sampler: PnpSampler | None = None) -> LoopResult:
        """One query frame against the database; verification runs only when the gates pass (one host read)."""
        bow_q = self.vocabulary.transform(descriptors, kp_valid)
        best_slot, cand_id, candidate_ok, max_score = self._gates_impl(db, bow_q)
        dev = db.bow.device
        eye = torch.eye(4, device=dev)
        if bool(candidate_ok):
            cand = [x[best_slot][None] for x in self._gather_candidate(db)]
            ok, T, ni, _ = self._verify_impl(
                descriptors[None], xy[None], kp_valid[None], *cand, candidate_ok[None], K, [0],
                sampler or generator_sampler(),
            )
            verified, T, num_inliers = ok[0], T[0], ni[0]
        else:
            verified, T, num_inliers = torch.zeros((), dtype=torch.bool, device=dev), eye, torch.zeros(
                (), dtype=torch.int32, device=dev)
        success = candidate_ok & verified
        return LoopResult(
            matched_keyframe_id=torch.where(success, cand_id, -1).to(torch.int32),
            relative_transform=torch.where(success, T, eye),
            num_inliers=num_inliers,
            candidate_id=cand_id.to(torch.int32),
            bow_score=torch.where(torch.isfinite(max_score), max_score, 0.0),
            success=success,
        )

    @staticmethod
    def _gather_candidate(db: KeyframeDB):
        return db.descriptors, db.xy, db.kp_valid, db.map_points, db.mp_valid

    # --- geometric verification --------------------------------------------------------
    def _match(self, descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid, candidate_ok, ratio):
        """Re-match (V, K) queries against their candidates' full descriptor sets (spatial penalty, no filter)."""
        mcfg = self.matcher_config
        return match_descriptors(
            descriptors, cand_desc, kp_valid, cand_kp_valid & candidate_ok[:, None], xy, cand_xy,
            ratio_threshold=ratio, max_jump_radius=mcfg.max_jump_radius, use_ratio_test=mcfg.use_ratio_test,
            filter_matches=False, use_spatial_penalty=True,
        )

    def _pnp_inputs(self, xy, cand_mp, cand_mp_valid, match):
        """The matched 2D (query) and 3D (candidate) points and the usable mask → (pts2d, pts3d, usable, enough)."""
        q = torch.clamp_min(match.query_idx, 0)
        t = torch.clamp_min(match.train_idx, 0)
        usable = match.valid & torch.gather(cand_mp_valid, 1, t)
        enough = usable.sum(dim=-1) >= self.config.min_matches_for_pnp
        pts2d = torch.gather(xy, 1, q[..., None].expand(*q.shape, 2))
        pts3d = torch.gather(cand_mp, 1, t[..., None].expand(*t.shape, 3))
        return pts2d, pts3d, usable, enough

    def _ransac(self, pts3d, pts2d, valid, K, samples):
        """One batched RANSAC DLT-PnP of the V problems → (success (V,), T (V, 4, 4), num_inliers (V,))."""
        cfg = self.config
        r = ransac_pnp(pts3d, pts2d, valid, K, samples, num_hypotheses=samples.shape[1], sample_size=6,
                       reproj_threshold=cfg.ransac_reprojection_threshold, min_inliers=cfg.min_inliers_for_pnp,
                       hyp_sweeps=6, lo_rounds=2, refine="gn")
        return r.success, _rt(r.R, r.t), r.num_inliers

    def _verify_impl(self, descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid, cand_mp, cand_mp_valid,
                     candidate_ok, K, positions, sampler: PnpSampler, ratio_threshold=None):
        """Re-match each of V queries against its candidate, then RANSAC DLT-PnP of the candidate's
        3D points against the query's pixels → (ok (V,), T (V, 4, 4), num_inliers (V,), match)."""
        ratio = self.matcher_config.ratio_test_threshold if ratio_threshold is None else ratio_threshold
        match = self._match(descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid, candidate_ok, ratio)
        pts2d, pts3d, usable, enough = self._pnp_inputs(xy, cand_mp, cand_mp_valid, match)
        valid = usable & enough[:, None]
        samples = sampler(positions, valid, self.verify_hypotheses)
        success, T, ni = self._ransac(pts3d, pts2d, valid, K, samples)
        return candidate_ok & enough & success, T, ni, match

    # --- relocalization --------------------------------------------------------------
    def _reloc_verify_impl(self, descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid, cand_mp,
                           cand_mp_valid, candidate_ok, K, sel, draws: RelocDraws):
        """Two-view verification of V lost frames against their candidates: RANSAC-PnP on the stored
        points and five-point essential RANSAC with a depth-ratio metric scale, Huber-GN polished; the
        PnP result where its inliers hold at least 0.75 of the essential path's → (ok, T, num_inliers)."""
        cfg = self.config
        ratio = cfg.reloc_ratio_threshold
        match = self._match(descriptors, xy, kp_valid, cand_desc, cand_xy, cand_kp_valid, candidate_ok, ratio)
        pts2d, pts3d, usable, enough = self._pnp_inputs(xy, cand_mp, cand_mp_valid, match)
        pnp_valid = usable & enough[:, None]
        samples, ranks = draws(sel, pnp_valid, match.valid.sum(dim=-1), self.verify_hypotheses)
        success, T_pnp, ni_pnp = self._ransac(pts3d, pts2d, pnp_valid, K, samples)
        ok_pnp = candidate_ok & enough & success

        t_i = torch.clamp_min(match.train_idx, 0)
        pts_c = torch.gather(cand_xy, 1, t_i[..., None].expand(*t_i.shape, 2))
        res = estimate_relative_pose(
            pts_c, pts2d, match.valid, K, draws=ranks, num_hypotheses=RELOC_HYPOTHESES, sample_size=5,
            inlier_threshold_px=cfg.ransac_reprojection_threshold, min_matches=cfg.min_matches_for_pnp,
        )
        X_unit = triangulate_matched_points(K, res.R, res.t, pts_c, pts2d)
        z_unit = X_unit[..., 2]
        mp_ok = torch.gather(cand_mp_valid, 1, t_i)
        z_stored = pts3d[..., 2]
        scale_ok = match.valid & res.inliers & mp_ok & (z_unit > 1e-3) & (z_stored > 1e-3)
        ratio_z = torch.where(scale_ok, z_stored / torch.clamp_min(z_unit, 1e-6), torch.nan)
        scale = _nanmedian(ratio_z)
        finite = torch.isfinite(scale)
        ok = (candidate_ok & res.success & (scale_ok.sum(dim=-1) >= cfg.min_inliers_for_pnp) & finite
              & (scale > 0))
        T = _rt(res.R, res.t * torch.where(finite, scale, 1.0)[:, None])
        # Huber-IRLS Gauss-Newton over all matched stored points, seeded by the scaled essential pose
        gn_valid = match.valid & mp_ok & (z_stored > 1e-3)
        gn = motion_pnp(K, T[:, :3, :3], T[:, :3, 3], pts3d, pts2d, gn_valid, iters=6,
                        min_inliers=cfg.min_inliers_for_pnp, huber_schedule=(32.0, 16.0, 8.0, 4.0, 2.0, 2.0),
                        reproj_threshold=cfg.ransac_reprojection_threshold)
        T = torch.where(gn.success[:, None, None], _rt(gn.R, gn.t), T)
        use_pnp = ok_pnp & (~ok | (ni_pnp.float() >= 0.75 * res.num_inliers.float()))
        return (ok_pnp | ok, torch.where(use_pnp[:, None, None], T_pnp, T),
                torch.where(use_pnp, ni_pnp, res.num_inliers).to(torch.int32))

    def relocalize_chunk(self, db, need, descriptors, xy, kp_valid, K, draws: RelocDraws, budget: int = 2):
        return self._relocalize_impl(db, need, descriptors, xy, kp_valid, K, draws, budget)

    def _relocalize_impl(self, db: KeyframeDB, need, descriptors, xy, kp_valid, K, draws: RelocDraws,
                         budget: int = 2, bow=None):
        """Global relocalization of the ``need`` frames of a chunk against the whole database.

        The best-scoring stored keyframe by BoW (no temporal gates), the
        first ``budget`` candidates by descending score verified, and
        ``T_world_cam = db.pose[best] · T⁻¹`` where verified.  ``bow``: the
        frames' BoW over all their keypoints, if the caller has it.  No host
        sync.  Returns ``(ok (B,), T_world_cam (B, 4, 4), num_inliers (B,),
        matched_id (B,))``.
        """
        cfg = self.config
        B = descriptors.shape[0]
        dev = descriptors.device
        kpv = kp_valid & need[:, None]
        bow = self.vocabulary.transform(descriptors, kpv) if bow is None else torch.where(need[:, None], bow, 0.0)
        occupied = db.ids >= 0
        scores = torch.where(occupied[None, :], bow @ db.bow.T, -torch.inf)
        best = torch.argmax(scores, dim=1)
        score = torch.gather(scores, 1, best[:, None])[:, 0]
        cand_ok = need & occupied.any() & (bow.sum(dim=1) > 0) & (score >= cfg.min_absolute_score)
        # budget by descending score: a blind span's garbage frames must not crowd out a real revisit
        V = max(1, min(budget, B))
        sel = torch.sort(torch.where(cand_ok, -score, torch.inf), stable=True).indices[:V]
        best_sel = best[sel]
        cands = [_rows(x, best_sel) for x in self._gather_candidate(db)]
        ok_v, T_v, ni_v = self._reloc_verify_impl(
            _rows(descriptors, sel), _rows(xy, sel), _rows(kpv, sel), *cands, cand_ok[sel], K, sel, draws
        )
        eyeB = torch.eye(4, device=dev).expand(B, 4, 4)
        ok = torch.zeros(B, dtype=torch.bool, device=dev).index_copy(0, sel, ok_v) & cand_ok
        T_rel = eyeB.clone().index_copy(0, sel, T_v)
        num_inliers = torch.zeros(B, dtype=torch.int32, device=dev).index_copy(0, sel, ni_v)
        T_reloc = torch.where(ok[:, None, None], _rows(db.pose, best) @ _rigid_inverse(T_rel), eyeB)
        matched = torch.where(ok, db.ids[best], -1).to(torch.int32)
        return ok, T_reloc, num_inliers, matched

    # --- the whole chunk ------------------------------------------------------------
    def process_chunk(self, db, frame_ids, enabled, descriptors, xy, kp_valid, map_points, mp_valid, K,
                      sampler: PnpSampler, poses=None, bow=None):
        """Detect and insert every keyframe of a chunk → (db', LoopResult with a (B,) leading dim)."""
        return self._process_chunk_impl(db, frame_ids, enabled, descriptors, xy, kp_valid, map_points, mp_valid,
                                        K, sampler, poses, bow)

    def _evict_idx(self, db: KeyframeDB, B: int) -> torch.Tensor:
        """The B rows to overwrite on overflow: empties first, then the most redundant (max BoW
        similarity to any other row); rows within ``EvictionProtectRecent`` of the newest last,
        oldest first among them."""
        cfg = self.config
        C = db.capacity
        occupied = db.ids >= 0
        R = db.bow @ db.bow.T
        pair_ok = occupied[:, None] & occupied[None, :] & ~torch.eye(C, dtype=torch.bool, device=R.device)
        red = torch.where(pair_ok, R, -torch.inf).amax(dim=1)
        red = torch.where(torch.isfinite(red), red, 0.0)
        protect = occupied & (db.ids > db.last_id - cfg.eviction_protect_recent)
        score = torch.where(occupied, red, torch.inf)
        age = (db.last_id - db.ids).to(torch.float32)
        score = torch.where(protect, -1e30 + age, score)  # float32: -1e30 + age rounds as the reference's
        return torch.sort(score, descending=True, stable=True).indices[:B]

    def _process_chunk_impl(self, db: KeyframeDB, frame_ids, enabled, descriptors, xy, kp_valid, map_points,
                            mp_valid, K, sampler: PnpSampler, poses=None, bow=None):
        """Detection against the pre-chunk database and the chunk's own earlier keyframes, the batched
        ring insert and the verification of the candidate frames (see the module docstring).

        Within a chunk that overflows the ring, later frames may still match keyframes that earlier
        frames of the chunk recycled (the scored snapshot is per chunk), as in the reference.
        """
        cfg = self.config
        B = descriptors.shape[0]
        C = db.capacity
        dev = descriptors.device
        if C < B:
            raise ValueError(f"keyframe DB capacity {C} < chunk size {B}: the ring insert needs one window a chunk")
        frame_ids = torch.as_tensor(frame_ids, device=dev).to(torch.int32)
        enabled = torch.as_tensor(enabled, device=dev)
        bow_add = self.vocabulary.transform(descriptors, kp_valid) if bow is None else bow
        bow_det = torch.where(enabled[:, None], bow_add, 0.0)

        # per-frame sequential gate state, batched
        en_i32 = enabled.to(torch.int32)
        count_i = db.count + torch.cumsum(en_i32, 0) - en_i32
        fid_en = torch.where(enabled, frame_ids, _INT32_MIN)
        cummax = torch.cummax(fid_en, 0).values
        prev_cummax = torch.cat([torch.full((1,), _INT32_MIN, dtype=torch.int32, device=dev), cummax[:-1]])
        last_id_i = torch.maximum(db.last_id, prev_cummax)

        # BoW scores and eligibility: the database, then the chunk's earlier enabled frames
        mfd = cfg.min_frames_difference
        occupied = db.ids >= 0
        tri = torch.arange(B, device=dev)
        elig_db = occupied[None, :] & ((last_id_i[:, None] - db.ids[None, :]).abs() >= mfd)
        elig_in = enabled[None, :] & (tri[None, :] < tri[:, None]) & (
            (last_id_i[:, None] - frame_ids[None, :]).abs() >= mfd)
        all_scores = torch.cat([bow_det @ db.bow.T, bow_det @ bow_add.T], dim=1)  # (B, C + B)
        all_ids = torch.cat([db.ids, frame_ids])
        elig = torch.cat([elig_db, elig_in], dim=1)
        masked = torch.where(elig, all_scores, -torch.inf)
        best = torch.argmax(masked, dim=1)
        max_score = torch.gather(masked, 1, best[:, None])[:, 0]
        best_ids = all_ids[best]
        if cfg.second_best_grouped:
            near_best = (all_ids[None, :] - best_ids[:, None]).abs() < mfd
        else:
            near_best = torch.arange(C + B, device=dev)[None, :] == best[:, None]
        second = torch.clamp_min(torch.where(elig & ~near_best, all_scores, -torch.inf).amax(dim=1), 0.0)
        cand_oks = (
            enabled
            & (count_i >= cfg.min_db_size)
            & (bow_det.sum(dim=1) > 0)
            & elig.any(dim=1)
            & (max_score >= cfg.min_absolute_score)
            & (max_score >= cfg.relative_score_factor * second)
        )
        cand_ids = torch.where(cand_oks, best_ids, -1).to(torch.int32)
        bow_scores = torch.where(torch.isfinite(max_score), max_score, 0.0)

        # the candidates' data: the database snapshot or the chunk's own frame
        from_db = best < C
        slot = torch.clamp(best, 0, C - 1)
        j_in = torch.clamp(best - C, 0, B - 1)

        def pick(db_arr, chunk_arr):
            sel = from_db.reshape((B,) + (1,) * (db_arr.ndim - 1))
            return torch.where(sel, _rows(db_arr, slot), _rows(chunk_arr, j_in))

        cands = (pick(db.descriptors, descriptors), pick(db.xy, xy), pick(db.kp_valid, kp_valid),
                 pick(db.map_points, map_points), pick(db.mp_valid, mp_valid))

        # the chunk's one host read: the ring's overflow flag and the candidate mask
        n_en = en_i32.sum()
        flags = torch.cat([(db.count + n_en > C).reshape(1), cand_oks]).cpu()
        overflow, cand_host = bool(flags[0]), flags[1:]

        # batched ring insert: the enabled rows, in order, into B slots
        if cfg.eviction_policy == "redundancy" and overflow:
            ins_idx = self._evict_idx(db, B)
        else:
            ins_idx = torch.remainder(db.count + tri, C)
        order = torch.sort(torch.where(enabled, tri, B + tri), stable=True).indices
        written = tri < n_en

        def blit(target, block):
            w = written.reshape((B,) + (1,) * (target.ndim - 1))
            out = target.clone()
            out.index_copy_(0, ins_idx, torch.where(w, _rows(block, order), _rows(target, ins_idx)))
            return out

        if poses is None:
            poses = torch.eye(4, device=dev).expand(B, 4, 4)
        new_db = KeyframeDB(
            bow=blit(db.bow, bow_add), xy=blit(db.xy, xy), kp_valid=blit(db.kp_valid, kp_valid),
            descriptors=blit(db.descriptors, descriptors), map_points=blit(db.map_points, map_points),
            mp_valid=blit(db.mp_valid, mp_valid), pose=blit(db.pose, poses.float()),
            ids=blit(db.ids, frame_ids), count=db.count + n_en, last_id=torch.maximum(db.last_id, cummax[-1]),
        )

        # geometric verification of the candidate frames, at most VerifyBudget of them
        V = cfg.verify_budget
        cap = V if 0 < V < B else B
        positions = [b for b in range(B) if bool(cand_host[b])][:cap]
        verified = torch.zeros(B, dtype=torch.bool, device=dev)
        T = torch.eye(4, device=dev).expand(B, 4, 4).clone()
        num_inliers = torch.zeros(B, dtype=torch.int32, device=dev)
        if positions:  # the same rows on the device, without a host-to-device copy
            sel = torch.sort(torch.where(cand_oks, tri, B + tri), stable=True).indices[: len(positions)]
            kpv_en = kp_valid & enabled[:, None]
            ok_v, T_v, ni_v, _ = self._verify_impl(
                _rows(descriptors, sel), _rows(xy, sel), _rows(kpv_en, sel), *(_rows(c, sel) for c in cands),
                cand_oks[sel], K, positions, sampler,
            )
            verified = verified.index_copy(0, sel, ok_v)
            T = T.index_copy(0, sel, T_v)
            num_inliers = num_inliers.index_copy(0, sel, ni_v.to(torch.int32))
        success = cand_oks & verified
        results = LoopResult(
            matched_keyframe_id=torch.where(success, cand_ids, -1).to(torch.int32),
            relative_transform=torch.where(success[:, None, None], T, torch.eye(4, device=dev)),
            num_inliers=num_inliers,
            candidate_id=cand_ids,
            bow_score=bow_scores,
            success=success,
        )
        return new_db, results
