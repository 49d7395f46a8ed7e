"""FeatureDetector: FAST detect + quantised steered-BRIEF compute, batched.

Port of the single-level path of ``tpuslam/frontend/detector.py``
(``FeatureDetector``, ``_level_batch``, ``_compute_batch_fused``).  One
batch runs kernel 1 (blur + FAST), packed-key NMS and the tile-pooled
top-k, kernel 2 (patch extraction), the int8 moment orientation, kernel 3
(own-bin BRIEF dots) and bit packing.  On CPU tensors the kernels' plain
twins run instead.

Not ported yet: the image pyramid (``NumLevels > 1``) and the exact
continuous-angle BRIEF (``BriefQuantizedBins: 0``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.config.schema import DetectorConfig
from tpuslam_torch.frontend.brief import (
    BriefPattern,
    bin_rotated_offsets,
    brief_bits_from_dots,
    build_brief_bin_weights,
    disc_moment_weights,
    gaussian_kernel,
    generate_brief_pattern_numpy,
    orientations_from_patches,
    quantize_angles,
)
from tpuslam_torch.frontend.fast import KeypointSet, select_keypoints
from tpuslam_torch.kernels.brief import brief_own_bin_dots, extract_brief_patches
from tpuslam_torch.kernels.frontend import fused_frontend_batch


def detector_arrays_numpy(config: DetectorConfig) -> dict[str, np.ndarray]:
    """The detector's constant arrays, built on the host from the config.

    Keys follow the reference package's ``FeatureDetector`` attributes:
    the BRIEF pattern fields, ``blur_kernel`` (5, 5) float32,
    ``bin_weights_3d`` (bins, S2p, P) int8 and ``moment_weights`` (S2p, 2) int8.
    """
    pattern = generate_brief_pattern_numpy(
        config.num_brief_pairs, config.patch_size, seed=config.brief_seed
    )
    bins = config.brief_quantized_bins
    W, _ = build_brief_bin_weights(pattern, config.patch_size, bins)
    s2p = W.shape[0]
    return {
        **pattern,
        "blur_kernel": gaussian_kernel().astype(np.float32),
        "bin_weights_3d": np.ascontiguousarray(W.reshape(s2p, bins, -1).transpose(1, 0, 2)),
        "moment_weights": disc_moment_weights(config.patch_size),
    }


class FeatureDetector:
    """Batched detector holding its constant arrays on ``device``."""

    def __init__(
        self,
        config: DetectorConfig | str | Path,
        device: torch.device | str = "cpu",
        arrays: dict[str, torch.Tensor] | None = None,
    ):
        if not isinstance(config, DetectorConfig):
            config = DetectorConfig.from_yaml(config)
        if config.num_levels > 1:
            raise NotImplementedError("NumLevels > 1 (the image pyramid) is not ported yet")
        if config.brief_quantized_bins <= 0:
            raise NotImplementedError(
                "BriefQuantizedBins: 0 (exact continuous-angle BRIEF) is not ported yet"
            )
        self.config = config
        self.device = torch.device(device)
        if arrays is None:
            from tpuslam_torch.utils.convert import detector_arrays_from_numpy

            arrays = detector_arrays_from_numpy(detector_arrays_numpy(config))
        self.pattern = BriefPattern(
            *(arrays[f].to(self.device) for f in BriefPattern._fields)
        )
        # Kernel 1 reads the taps on the host before each launch: keep them on the CPU.
        self.blur_kernel = arrays["blur_kernel"].to("cpu")
        self.bin_weights_3d = arrays["bin_weights_3d"].to(self.device)
        self.moment_weights = arrays["moment_weights"].to(self.device)
        self.rotated_offsets = bin_rotated_offsets(
            self.pattern.p1, self.pattern.p2, config.brief_quantized_bins
        ).to(self.device)

    def detect_and_compute_batch(self, images: torch.Tensor) -> tuple[KeypointSet, torch.Tensor]:
        """(B, H, W) uint8 frames → (KeypointSet (B, K), descriptors (B, K, D) uint8)."""
        c = self.config
        images = images.to(self.device)
        blur, corner, score = fused_frontend_batch(
            images,
            threshold=c.intensity_threshold,
            contiguous=c.contiguous_pixels_threshold,
            taps=self.blur_kernel,
        )
        kps = select_keypoints(
            corner, score, nms=c.non_max_suppression,
            window=c.suppression_window_size, max_keypoints=c.max_keypoints,
        )
        return self.compute_from_blurred(blur, kps)

    def compute_from_blurred(
        self, blurred: torch.Tensor, kps: KeypointSet
    ) -> tuple[KeypointSet, torch.Tensor]:
        """Orientation + quantised BRIEF sharing one patch extraction."""
        c = self.config
        h, w = blurred.shape[-2:]
        patches = extract_brief_patches(blurred, kps.xy, c.patch_size)
        angles = orientations_from_patches(
            patches, self.moment_weights, kps, c.patch_size, (h, w)
        )
        bin_idx = quantize_angles(angles, c.brief_quantized_bins)
        own = brief_own_bin_dots(patches, bin_idx, self.bin_weights_3d)
        desc = brief_bits_from_dots(
            own, bin_idx, kps, self.pattern, self.rotated_offsets,
            c.num_brief_pairs, c.patch_size, (h, w),
        )
        return kps._replace(angle=angles), desc
