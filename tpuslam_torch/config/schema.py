"""Typed configuration schema with reference-compatible validation.

Each dataclass mirrors one of the reference's per-component OpenCV-YAML config
files, keeping the same key names and the same eager validation rules so that
reference config files load unchanged:

  * detector keys/validation  — reference ``feature_detector.hpp:53-107``
  * matcher keys/validation   — reference ``feature_matcher.cpp:18-59``
  * loop-closure keys/rules   — reference ``loop_closure.cpp:30-94``

On top of the reference keys, each config carries TPU-specific *capacity*
fields (fixed-shape buffer sizes).  They have defaults and may be overridden
by extra YAML keys the reference would simply ignore.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from tpuslam_torch.config.yaml_io import load_opencv_yaml


def _get(doc: dict[str, Any], key: str, default: Any = None) -> Any:
    return doc.get(key, default)


@dataclass(frozen=True)
class DetectorConfig:
    """FAST + steered-BRIEF detector configuration.

    Reference keys: ``IntensityThreshold``, ``ContiguousPixelsThreshold``,
    ``NonMaxSuppression``, ``SuppressionWindowSize``, ``PatchSize``,
    ``NumBRIEFPairs`` (reference ``test/data/feature_detector.yml``).
    """

    intensity_threshold: int = 20
    contiguous_pixels_threshold: int = 12
    non_max_suppression: bool = True
    suppression_window_size: int = 12
    patch_size: int = 31
    num_brief_pairs: int = 256
    # TPU capacity fields (not in the reference — fixed-shape buffer sizes).
    max_keypoints: int = 1024
    brief_seed: int = 42
    # 0 = exact continuous-angle BRIEF (reference parity); >0 quantises the
    # orientation to this many bins so description runs as one int8 MXU
    # matmul (~7× faster; ≤ 360/bins deg quantisation).
    brief_quantized_bins: int = 0
    # Multi-scale (ORB-style) pyramid: 1 = single scale (reference parity).
    # Levels are detected/described on successively 1/scale_factor-resized
    # images; keypoint capacity splits across levels by image area.
    num_levels: int = 1
    scale_factor: float = 1.2

    def __post_init__(self) -> None:
        if not 0 <= self.intensity_threshold <= 255:
            raise ValueError("Intensity threshold must be in the range [0, 255].")
        if not 0 <= self.contiguous_pixels_threshold <= 16:
            raise ValueError("Contiguous pixels threshold must be in the range [0, 16].")
        if self.suppression_window_size <= 0:
            raise ValueError("Suppression window size must be a positive integer.")
        if self.patch_size <= 0 or self.patch_size % 2 == 0:
            raise ValueError("Patch size must be a positive odd integer.")
        if self.num_brief_pairs <= 0 or self.num_brief_pairs % 8 != 0:
            raise ValueError("Number of BRIEF pairs must be a positive multiple of 8.")
        if self.max_keypoints <= 0:
            raise ValueError("MaxKeypoints must be a positive integer.")
        if self.num_levels < 1:
            raise ValueError("NumLevels must be >= 1.")
        if self.num_levels > 1 and self.scale_factor <= 1.0:
            raise ValueError("ScaleFactor must be > 1.0 for a multi-level pyramid.")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "DetectorConfig":
        doc = load_opencv_yaml(path)
        nms = _get(doc, "NonMaxSuppression", 1)
        if nms not in (0, 1):
            raise ValueError("Non-max suppression must be either 0 (false) or 1 (true).")
        return cls(
            intensity_threshold=int(_get(doc, "IntensityThreshold", 20)),
            contiguous_pixels_threshold=int(_get(doc, "ContiguousPixelsThreshold", 12)),
            non_max_suppression=bool(nms),
            suppression_window_size=int(_get(doc, "SuppressionWindowSize", 12)),
            patch_size=int(_get(doc, "PatchSize", 31)),
            num_brief_pairs=int(_get(doc, "NumBRIEFPairs", 256)),
            max_keypoints=int(_get(doc, "MaxKeypoints", 1024)),
            brief_seed=int(_get(doc, "BriefSeed", 42)),
            brief_quantized_bins=int(_get(doc, "BriefQuantizedBins", 0)),
            num_levels=int(_get(doc, "NumLevels", 1)),
            scale_factor=float(_get(doc, "ScaleFactor", 1.2)),
        )

    @property
    def descriptor_bytes(self) -> int:
        return self.num_brief_pairs // 8


@dataclass(frozen=True)
class MatcherConfig:
    """Brute-force matcher configuration.

    Reference keys: ``DistanceType``, ``FilterMatches``, ``GoodMatchesCount``,
    ``UseRatioTest``, ``RatioTestThreshold``
    (reference ``test/data/feature_matcher.yml``).
    """

    distance_type: str = "HAMMING"
    filter_matches: bool = True
    good_matches_count: int = 20
    use_ratio_test: bool = True
    ratio_test_threshold: float = 0.5
    # Spatial-jump penalty radius; a named constant in the reference
    # (``feature_matcher.hpp:12`` MAX_JUMP_RADIUS = 500).
    max_jump_radius: float = 500.0

    def __post_init__(self) -> None:
        if self.distance_type not in ("HAMMING", "L2"):
            raise ValueError("Invalid distance type. Must be 'HAMMING' or 'L2'.")
        if self.filter_matches and self.good_matches_count <= 0:
            raise ValueError("GoodMatchesCount must be positive when filtering is enabled.")
        if not 0.0 <= self.ratio_test_threshold <= 1.0:
            raise ValueError("RatioTestThreshold must be in the range [0, 1].")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "MatcherConfig":
        doc = load_opencv_yaml(path)
        fm = _get(doc, "FilterMatches", 0)
        if fm not in (0, 1):
            raise ValueError("FilterMatches must be either 0 (false) or 1 (true).")
        rt = _get(doc, "UseRatioTest", 0)
        if rt not in (0, 1):
            raise ValueError("UseRatioTest must be either 0 (false) or 1 (true).")
        return cls(
            distance_type=str(_get(doc, "DistanceType", "HAMMING")),
            filter_matches=bool(fm),
            good_matches_count=int(_get(doc, "GoodMatchesCount", 0)),
            use_ratio_test=bool(rt),
            ratio_test_threshold=float(_get(doc, "RatioTestThreshold", 0.0)),
            max_jump_radius=float(_get(doc, "MaxJumpRadius", 500.0)),
        )


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure configuration.

    Reference keys and validation: ``loop_closure.cpp:30-94``.
    """

    min_db_size: int = 2
    min_frames_difference: int = 2
    min_absolute_score: float = 0.005
    # Re-baselined for cosine BoW scores (reference fbow default was 1.5).
    relative_score_factor: float = 1.1
    min_matches_for_pnp: int = 20
    min_inliers_for_pnp: int = 5
    ransac_max_iterations: int = 100
    ransac_reprojection_threshold: float = 2.0
    # Second-best gate: the reference compares the best BoW score against
    # the raw runner-up (loop_closure.cpp:137-141); on self-similar
    # sequences the runner-up is the true loop's own temporal neighbour,
    # which rejects every correct loop.  True (default) groups keyframes
    # within MinFramesDifference of the best candidate out of the
    # runner-up pool — the gate's intent (reject matches ambiguous across
    # *distinct* places) without punishing neighbours of the true match.
    # False reproduces the reference's literal gate.
    second_best_grouped: bool = True
    # Geometric-verification budget per chunk: at most this many frames of
    # a chunk run the re-match + RANSAC-PnP verification (frames with BoW
    # candidates first, in frame order).  Candidates are rare — paying the
    # full per-frame verification program for all batch_size frames is the
    # single largest loop-closure cost; a small budget keeps the semantics
    # on realistic sequences (consecutive over-budget candidates are
    # temporally redundant for the pose graph) at a fraction of the cost.
    # 0 (default) verifies every frame — exact sequential semantics.
    verify_budget: int = 0
    # Descriptor ratio test for RELOCALIZATION matching only: a lost frame
    # re-matches a keyframe several baselines away, where the shipped
    # consecutive-frame ratio (0.5) leaves too few matches to verify
    # (measured: 17 matches on a 3-frame gap, below the 20-match floor);
    # the classic Lowe 0.8 recovers the pool.  Loop verification keeps the
    # matcher's ratio (the reference reuses the matcher there,
    # loop_closure.cpp:156-158).
    reloc_ratio_threshold: float = 0.8
    # TPU capacity fields.
    max_keyframes: int = 512
    # Ring-overflow eviction policy.  The reference's keyframe DB is
    # unbounded (``loop_closure.cpp:96-109``); a fixed-capacity DB must
    # pick victims.  "fifo" recycles oldest-first — on any sequence longer
    # than the ring it evicts exactly the early keyframes loops close
    # against.  "redundancy" (default) evicts the rows whose content the
    # rest of the DB best duplicates (max BoW similarity to any other
    # row), so self-similar stretches collapse to a few representatives
    # while distinctive places survive arbitrarily long — the bounded-
    # memory analog of ORB-SLAM's redundant-keyframe culling.  Runs under
    # a cond only on overflowing chunks (pre-overflow cost: none).
    eviction_policy: str = "redundancy"
    # Rows with ids within this many frames of the newest keyframe are
    # never evicted (tracking/relocalization needs the recent past; recent
    # rows are also transiently "redundant" with each other, which would
    # otherwise make them the first victims).
    eviction_protect_recent: int = 64

    def __post_init__(self) -> None:
        if self.eviction_policy not in ("fifo", "redundancy"):
            raise ValueError(
                "'EvictionPolicy' must be 'fifo' or 'redundancy'."
            )
        if self.eviction_protect_recent < 0:
            raise ValueError(
                "'EvictionProtectRecent' must be non-negative."
            )
        if (
            self.eviction_policy == "redundancy"
            and self.eviction_protect_recent >= self.max_keyframes
        ):
            # With dense keyframes the protect window (frame-id recency)
            # can cover the whole ring; victim selection then has no
            # unprotected candidates and would silently evict protected
            # rows (see LoopClosure._evict_idx).  The chunk-size-aware
            # bound lives in SlamConfig (batch_size is known there).
            raise ValueError(
                "'EvictionProtectRecent' must be smaller than "
                "'MaxKeyframes' under the redundancy eviction policy."
            )
        if self.min_db_size < 0:
            raise ValueError("'MinDbSize' must be a non-negative integer.")
        if self.min_frames_difference <= 0:
            raise ValueError("'MinFramesDifference' must be a positive integer.")
        if self.min_absolute_score < 0.0:
            raise ValueError("'MinAbsoluteScore' must be non-negative.")
        if self.relative_score_factor < 0.0:
            raise ValueError("'RelativeScoreFactor' must be non-negative.")
        if self.min_matches_for_pnp <= 3:
            raise ValueError("'MinMatchesForPnP' must be greater than 3 for PnP.")
        if self.min_inliers_for_pnp <= 3:
            raise ValueError("'MinInliersForPnP' must be greater than 3 for PnP.")
        if self.min_inliers_for_pnp > self.min_matches_for_pnp:
            raise ValueError("'MinInliersForPnP' cannot be greater than 'MinMatchesForPnP'.")
        if self.ransac_max_iterations <= 0:
            raise ValueError("'RansacMaxIterations' must be a positive integer.")
        if self.ransac_reprojection_threshold <= 0.0:
            raise ValueError("'RansacReprojectionThreshold' must be a positive value.")
        if self.verify_budget < 0:
            raise ValueError("'VerifyBudget' must be a non-negative integer.")
        if not (0.0 < self.reloc_ratio_threshold <= 1.0):
            raise ValueError("'RelocRatioThreshold' must be in (0, 1].")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "LoopClosureConfig":
        doc = load_opencv_yaml(path)
        return cls(
            min_db_size=int(_get(doc, "MinDbSize", 0)),
            min_frames_difference=int(_get(doc, "MinFramesDifference", 1)),
            min_absolute_score=float(_get(doc, "MinAbsoluteScore", 0.0)),
            relative_score_factor=float(_get(doc, "RelativeScoreFactor", 0.0)),
            min_matches_for_pnp=int(_get(doc, "MinMatchesForPnP", 20)),
            min_inliers_for_pnp=int(_get(doc, "MinInliersForPnP", 5)),
            ransac_max_iterations=int(_get(doc, "RansacMaxIterations", 100)),
            ransac_reprojection_threshold=float(
                _get(doc, "RansacReprojectionThreshold", 2.0)
            ),
            second_best_grouped=bool(int(_get(doc, "SecondBestGrouped", 1))),
            verify_budget=int(_get(doc, "VerifyBudget", 0)),
            reloc_ratio_threshold=float(_get(doc, "RelocRatioThreshold", 0.8)),
            max_keyframes=int(_get(doc, "MaxKeyframes", 512)),
            eviction_policy=str(_get(doc, "EvictionPolicy", "redundancy")),
            eviction_protect_recent=int(
                _get(doc, "EvictionProtectRecent", 64)
            ),
        )


@dataclass(frozen=True)
class PoseConfig:
    """Two-view pose estimation (batched essential-matrix RANSAC).

    The reference delegates to ``cv::findEssentialMat(..., cv::RANSAC)``
    (``pose_estimator.cpp:42``) with OpenCV defaults (1.0 px threshold,
    0.999 confidence).  The TPU version scores a fixed batch of hypotheses in
    one shot instead of iterating adaptively.
    """

    num_hypotheses: int = 1024
    sample_size: int = 8
    inlier_threshold_px: float = 1.0
    min_matches: int = 8  # reference pose_estimator.cpp:22-26
    seed: int = 0
    # Hypothesis budget when the two-view solve only SEEDS map-centric PnP
    # tracking (tracking="pnp").  0 (default) = use num_hypotheses.  A
    # halved budget measured +1.1 ms/chunk on the bench clip with
    # identical fixture TRAJECTORIES — but the two-view solve also feeds
    # the pair TRIANGULATIONS that become map landmarks and keyframe-DB
    # depths, and there a 512-budget draw measured 75 essential inliers
    # vs 102 at 1024 on one fixture pair, with depth spread bad enough to
    # break relocalization's depth-ratio scale (snap 1.8 units short).
    # Trajectory parity alone is NOT sufficient evidence to lower this;
    # set it explicitly only for deployments that don't rely on
    # relocalization/loop-closure depth quality.
    seed_num_hypotheses: int = 0

    def __post_init__(self) -> None:
        if self.num_hypotheses <= 0:
            raise ValueError("'NumHypotheses' must be a positive integer.")
        if self.seed_num_hypotheses < 0:
            raise ValueError("'SeedNumHypotheses' must be >= 0.")
        if self.sample_size != 5 and self.sample_size < 8:
            raise ValueError(
                "'SampleSize' must be 5 (Nistér minimal solver, the "
                "reference's cv::findEssentialMat algorithm) or >= 8 "
                "(8-point least-squares samples)."
            )
        if self.inlier_threshold_px <= 0.0:
            raise ValueError("'InlierThresholdPx' must be positive.")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "PoseConfig":
        doc = load_opencv_yaml(path)
        return cls(
            num_hypotheses=int(_get(doc, "NumHypotheses", 1024)),
            sample_size=int(_get(doc, "SampleSize", 8)),
            inlier_threshold_px=float(_get(doc, "InlierThresholdPx", 1.0)),
            min_matches=int(_get(doc, "MinMatches", 8)),
            seed=int(_get(doc, "Seed", 0)),
            seed_num_hypotheses=int(_get(doc, "SeedNumHypotheses", 0)),
        )


@dataclass(frozen=True)
class MapConfig:
    """Map / landmark-association / backend gating configuration (``map.yml``).

    The reference's ``Map`` is a header-only skeleton with no parameters
    (``include/slam/backend/map.hpp:9-21``), so these keys are TPU-side
    additions following the reference's YAML-everything discipline.  The
    defaults are tuned for KITTI-scale outdoor forward motion; indoor or
    synthetic scenes (different flow magnitudes, different depth ranges in
    unit-baseline triangulation units) should ship their own ``map.yml``.
    """

    # Reprojection gate (px) for trusting a chained landmark association.
    assoc_gate_px: float = 8.0
    # Unit-baseline triangulation depth window for creating new landmarks.
    min_triangulation_depth: float = 0.5
    max_triangulation_depth: float = 80.0
    # Cheirality floor for association candidates (predicted camera-frame z).
    min_candidate_depth: float = 0.2
    # Pose-graph weight of a loop edge relative to odometry edges.
    loop_edge_weight: float = 10.0

    def __post_init__(self) -> None:
        if self.assoc_gate_px <= 0.0:
            raise ValueError("'AssocGatePx' must be positive.")
        if self.min_triangulation_depth <= 0.0:
            raise ValueError("'MinTriangulationDepth' must be positive.")
        if self.max_triangulation_depth <= self.min_triangulation_depth:
            raise ValueError(
                "'MaxTriangulationDepth' must exceed 'MinTriangulationDepth'."
            )
        if self.min_candidate_depth <= 0.0:
            raise ValueError("'MinCandidateDepth' must be positive.")
        if self.loop_edge_weight <= 0.0:
            raise ValueError("'LoopEdgeWeight' must be positive.")

    @classmethod
    def from_yaml(cls, path: str | Path) -> "MapConfig":
        doc = load_opencv_yaml(path)
        return cls(
            assoc_gate_px=float(_get(doc, "AssocGatePx", 8.0)),
            min_triangulation_depth=float(_get(doc, "MinTriangulationDepth", 0.5)),
            max_triangulation_depth=float(_get(doc, "MaxTriangulationDepth", 80.0)),
            min_candidate_depth=float(_get(doc, "MinCandidateDepth", 0.2)),
            loop_edge_weight=float(_get(doc, "LoopEdgeWeight", 10.0)),
        )


@dataclass(frozen=True)
class SlamConfig:
    """Top-level pipeline configuration bundling all component configs."""

    detector: DetectorConfig = field(default_factory=DetectorConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    loop_closure: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    pose: PoseConfig = field(default_factory=PoseConfig)
    map: MapConfig = field(default_factory=MapConfig)
    frame_skip: int = 0
    batch_size: int = 16
    max_map_points: int = 8192

    def __post_init__(self) -> None:
        lc = self.loop_closure
        if (
            lc.eviction_policy == "redundancy"
            and lc.max_keyframes - lc.eviction_protect_recent
            < self.batch_size
        ):
            # Redundancy eviction snapshots its B victims from the rows
            # that are occupied AND unprotected; with dense keyframes
            # (PnP mode inserts every frame) the protect window can
            # shrink that pool below B, and lax.top_k over the -inf
            # scores would silently evict protected rows.  Eager,
            # reference-style validation (cf. MinInliersForPnP ≤
            # MinMatchesForPnP, loop_closure.cpp:67-69).
            raise ValueError(
                "'MaxKeyframes' - 'EvictionProtectRecent' must be at "
                "least the chunk batch size under the redundancy "
                "eviction policy (victim selection needs that many "
                "unprotected rows per chunk)."
            )

    @classmethod
    def from_yaml_dir(cls, config_dir: str | Path, **overrides: Any) -> "SlamConfig":
        """Load from a directory of reference-style per-component YAML files."""
        config_dir = Path(config_dir)

        def maybe(name: str, loader, default):
            p = config_dir / name
            return loader(p) if p.is_file() else default

        return cls(
            detector=maybe("feature_detector.yml", DetectorConfig.from_yaml, DetectorConfig()),
            matcher=maybe("feature_matcher.yml", MatcherConfig.from_yaml, MatcherConfig()),
            loop_closure=maybe(
                "loop_closure.yml", LoopClosureConfig.from_yaml, LoopClosureConfig()
            ),
            pose=maybe("pose_estimator.yml", PoseConfig.from_yaml, PoseConfig()),
            map=maybe("map.yml", MapConfig.from_yaml, MapConfig()),
            **overrides,
        )
