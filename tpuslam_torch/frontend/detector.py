"""FeatureDetector: FAST detect + steered-BRIEF compute, batched and single-image.

Port of ``tpuslam/frontend/detector.py`` (``FeatureDetector``,
``_level_batch``, ``_feasible_levels``, ``_pyramid_batch``,
``_resize_batch_u8``, ``_compute_batch_fused``, ``_compute_from_blurred``).
One level of one batch runs either kernel 1 (blur + FAST), packed-key NMS
and the tile-pooled top-k, or — with ``nms_fused`` where the level's shape
allows it — kernel 5 (blur + FAST + NMS in one pass) and the top-k over its
key plane.  With ``BriefQuantizedBins > 0`` kernel 2 (patch extraction),
the int8 moment orientation, kernel 3 (own-bin BRIEF dots) and bit packing
follow; with 0, the exact continuous-angle orientation and BRIEF, plain
torch as in the reference (``frontend/brief.py``).  With ``NumLevels > 1``
every level is resized from level 0 and detected on; its keypoints map back
to level-0 pixels.  ``detect``, ``compute`` and ``detect_and_compute`` take
one (H, W) image through the batch path at B = 1, as the reference does on
its accelerator.  On CPU tensors the kernels' plain twins run instead.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.config.schema import DetectorConfig
from tpuslam_torch.frontend.brief import (
    BriefPattern,
    bin_rotated_offsets,
    brief_bits_from_dots,
    build_brief_bin_weights,
    compute_brief_descriptors,
    compute_orientations,
    disc_moment_weights,
    gaussian_kernel,
    generate_brief_pattern_numpy,
    orientations_from_patches,
    quantize_angles,
)
from tpuslam_torch.frontend.fast import (
    BORDER,
    KeypointSet,
    select_from_key,
    select_keypoints,
    tile_pool_exact,
)
from tpuslam_torch.kernels.brief import (
    brief_own_bin_dots,
    extract_brief_patches,
    pack_bin_weights,
)
from tpuslam_torch.kernels.frontend import (
    NMS_HALO,
    fused_frontend_batch,
    fused_frontend_nms_batch,
)
from tpuslam_torch.utils import profiling


def detector_arrays_numpy(config: DetectorConfig) -> dict[str, np.ndarray]:
    """The detector's constant arrays, built on the host from the config.

    Keys follow the reference package's ``FeatureDetector`` attributes:
    the BRIEF pattern fields, ``blur_kernel`` (5, 5) float32,
    ``bin_weights_3d`` (bins, S2p, P) int8 (only with ``BriefQuantizedBins
    > 0``: the exact path has no bin weights) and ``moment_weights``
    (S2p, 2) int8.  The pyramid adds none: its resize weights depend on the
    level shapes alone (:func:`resize_weights_numpy`), so the same arrays
    serve every ``NumLevels``.
    """
    pattern = generate_brief_pattern_numpy(
        config.num_brief_pairs, config.patch_size, seed=config.brief_seed
    )
    arrays = {
        **pattern,
        "blur_kernel": gaussian_kernel().astype(np.float32),
        "moment_weights": disc_moment_weights(config.patch_size),
    }
    bins = config.brief_quantized_bins
    if bins > 0:
        W, _ = build_brief_bin_weights(pattern, config.patch_size, bins)
        arrays["bin_weights_3d"] = np.ascontiguousarray(W.reshape(W.shape[0], bins, -1).transpose(1, 0, 2))
    return arrays


class FeatureDetector:
    """Batched detector holding its constant arrays on ``device`` (the card by default).

    ``nms_fused`` asks for kernel 5 (blur + FAST + NMS in one pass) on every
    level whose shape allows it (:meth:`_fused_nms_ok`); the others, and
    every level when it is off (the default, as in the reference), run
    kernel 1 and the separate NMS.  Both give the same keypoints.
    """

    def __init__(
        self,
        config: DetectorConfig | str | Path,
        device: torch.device | str = "cuda",
        arrays: dict[str, torch.Tensor] | None = None,
        nms_fused: bool = False,
    ):
        if not isinstance(config, DetectorConfig):
            config = DetectorConfig.from_yaml(config)
        self.config = config
        self.device = torch.device(device)
        self.nms_fused = nms_fused
        if arrays is None:
            from tpuslam_torch.utils.convert import detector_arrays_from_numpy

            arrays = detector_arrays_from_numpy(detector_arrays_numpy(config))
        bins = config.brief_quantized_bins
        required = [*BriefPattern._fields, "blur_kernel", "moment_weights"]
        required += ["bin_weights_3d"] if bins > 0 else []
        missing = [k for k in required if k not in arrays]
        if missing:
            raise KeyError(f"missing detector arrays for BriefQuantizedBins {bins}: {missing}")
        self.pattern = BriefPattern(
            *(arrays[f].to(self.device) for f in BriefPattern._fields)
        )
        # Kernels 1 and 5 read the taps on the host before each launch: keep them on the CPU.
        self.blur_kernel = arrays["blur_kernel"].to("cpu")
        self.moment_weights = arrays["moment_weights"].to(self.device)
        # The exact path (bins 0) has no bin weights, as in the reference.
        self.bin_weights = self.bin_weights_3d = self.rotated_offsets = None
        if bins > 0:
            # Kernel 3's (bins, P, S2p) layout, built once here; the twin reads the (bins, S2p, P) view.
            self.bin_weights = pack_bin_weights(arrays["bin_weights_3d"].to(self.device))
            self.bin_weights_3d = self.bin_weights.as_3d()
            self.rotated_offsets = bin_rotated_offsets(
                self.pattern.p1, self.pattern.p2, bins
            ).to(self.device)

    # --- single image (the reference's detect / compute / detect_and_compute) ---------------------
    def detect(self, image: torch.Tensor) -> KeypointSet:
        """FAST + NMS on one (H, W) uint8 image → a (K,) KeypointSet, single-scale."""
        _, kps = self._detect_level(image.to(self.device)[None], self.config.max_keypoints)
        return _row0(kps)

    def compute(self, image: torch.Tensor, kps: KeypointSet) -> tuple[KeypointSet, torch.Tensor]:
        """Blur (kernel 1's) + orientation + BRIEF of one (H, W) image's (K,) keypoints.

        Returns (keypoints with angles, (K, NumBRIEFPairs/8) uint8
        descriptors); rows of invalid keypoints are all zero.
        """
        c = self.config
        blur, _, _ = fused_frontend_batch(
            image.to(self.device)[None], threshold=c.intensity_threshold,
            contiguous=c.contiguous_pixels_threshold, taps=self.blur_kernel,
        )
        kps, desc = self.compute_from_blurred(blur, KeypointSet(*(f.to(self.device)[None] for f in kps)))
        return _row0(kps), desc[0]

    def detect_and_compute(self, image: torch.Tensor) -> tuple[KeypointSet, torch.Tensor]:
        """Row 0 of :meth:`detect_and_compute_batch` on the one (H, W) image."""
        kps, desc = self.detect_and_compute_batch(image[None])
        return _row0(kps), desc[0]

    def detect_and_compute_batch(self, images: torch.Tensor) -> tuple[KeypointSet, torch.Tensor]:
        """(B, H, W) uint8 frames → (KeypointSet (B, K), descriptors (B, K, D) uint8).

        With ``NumLevels > 1`` the K slots split across the pyramid levels
        (level 0 first) and every coordinate is in level-0 pixels.
        """
        images = images.to(self.device)
        if self.config.num_levels <= 1:
            return self._level_batch(images, self.config.max_keypoints)
        return self._pyramid_batch(images)

    def _fused_nms_ok(self, h: int, w: int, max_keypoints: int) -> bool:
        """Whether kernel 5 runs on an (h, w) level of capacity ``max_keypoints``.

        The reference's rule: fused NMS asked for, NMS on, the tile-pooled
        top-k exact on the key plane, and the window within kernel 5's halo.
        """
        c = self.config
        window = c.suppression_window_size
        return (
            self.nms_fused
            and c.non_max_suppression
            and window - 1 + BORDER <= NMS_HALO
            and tile_pool_exact(h, w, window, max_keypoints)
        )

    def _detect_level(self, images: torch.Tensor, max_keypoints: int) -> tuple[torch.Tensor, KeypointSet]:
        """Blur + keypoints of (B, H, W) images with an explicit capacity (kernel 5 or kernel 1)."""
        c = self.config
        args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold,
                    taps=self.blur_kernel)
        window = c.suppression_window_size
        if self._fused_nms_ok(*images.shape[-2:], max_keypoints):
            blur, key = fused_frontend_nms_batch(images, window=window, **args)
            return blur, select_from_key(key, window=window, max_keypoints=max_keypoints)
        blur, corner, score = fused_frontend_batch(images, **args)
        return blur, select_keypoints(corner, score, nms=c.non_max_suppression,
                                      window=window, max_keypoints=max_keypoints)

    def _level_batch(
        self, images: torch.Tensor, max_keypoints: int
    ) -> tuple[KeypointSet, torch.Tensor]:
        """Single-scale batched detect + compute with an explicit capacity (spans ``detect.corners`` and
        ``detect.describe``)."""
        with profiling.span("detect.corners"):
            blur, kps = self._detect_level(images, max_keypoints)
        with profiling.span("detect.describe"):
            return self.compute_from_blurred(blur, kps)

    def _feasible_levels(self, h: int, w: int) -> list[tuple[int, int, int]]:
        """(level, h_l, w_l) for every level large enough to detect on."""
        c = self.config
        out = []
        for level in range(c.num_levels):
            s = c.scale_factor**level
            h_l, w_l = int(round(h / s)), int(round(w / s))
            if min(h_l, w_l) < 4 * c.patch_size:
                break
            out.append((level, h_l, w_l))
        return out

    def _level_capacities(self, levels: list[tuple[int, int, int]]) -> list[int]:
        """Keypoint slots of each level: ∝ its area, summing exactly to ``max_keypoints``."""
        c = self.config
        weights = [w_l * h_l for (_, h_l, w_l) in levels]
        total = float(sum(weights))
        caps = [max(32, int(round(c.max_keypoints * wt / total))) for wt in weights]
        caps[0] += c.max_keypoints - sum(caps)
        return caps

    def _pyramid_batch(self, images: torch.Tensor) -> tuple[KeypointSet, torch.Tensor]:
        """Detect on every level (each resized from level 0, span ``detect.resize``), concatenated along K."""
        c = self.config
        levels = self._feasible_levels(*images.shape[-2:])
        caps = self._level_capacities(levels)
        kp_parts: list[KeypointSet] = []
        desc_parts: list[torch.Tensor] = []
        for (level, h_l, w_l), cap in zip(levels, caps):
            img = images
            if level > 0:
                with profiling.span("detect.resize"):
                    img = resize_batch_u8(images, h_l, w_l)
            kps, desc = self._level_batch(img, cap)
            # float32 scale, as jnp.float32(scale_factor**level)
            scale = torch.tensor(c.scale_factor**level, dtype=torch.float32, device=images.device)
            kp_parts.append(kps._replace(xy=kps.xy * scale))
            desc_parts.append(desc)
        kps = KeypointSet(*(torch.cat(parts, dim=1) for parts in zip(*kp_parts)))
        return kps, torch.cat(desc_parts, dim=1)

    def compute_from_blurred(
        self, blurred: torch.Tensor, kps: KeypointSet
    ) -> tuple[KeypointSet, torch.Tensor]:
        """Orientation + BRIEF of (B, K) keypoints on (B, H, W) blurred images.

        Quantised (bins > 0): kernel 2's patches serve the int8 moment
        orientation and kernel 3.  Exact (bins 0): the moment maps and the
        continuous-angle BRIEF, plain torch (no kernel in the reference either).
        """
        c = self.config
        if c.brief_quantized_bins <= 0:
            angles = compute_orientations(blurred, kps, c.patch_size)
            desc = compute_brief_descriptors(blurred, kps, angles, self.pattern, c.num_brief_pairs, c.patch_size)
            return kps._replace(angle=angles), desc
        h, w = blurred.shape[-2:]
        patches = extract_brief_patches(blurred, kps.xy, c.patch_size)
        angles = orientations_from_patches(
            patches, self.moment_weights, kps, c.patch_size, (h, w)
        )
        bin_idx = quantize_angles(angles, c.brief_quantized_bins)
        own = brief_own_bin_dots(patches, bin_idx, self.bin_weights)
        desc = brief_bits_from_dots(
            own, bin_idx, kps, self.pattern, self.rotated_offsets,
            c.num_brief_pairs, c.patch_size, (h, w),
        )
        return kps._replace(angle=angles), desc


def _row0(kps: KeypointSet) -> KeypointSet:
    return KeypointSet(*(f[0] for f in kps))


def resize_weights_numpy(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize(method="linear")`` along one axis.

    ``jax._src.image.scale.compute_weight_mat`` step by step in float32:
    sample positions ``(i + ½)·inv_scale − ½`` (XLA's CPU compiler fuses
    this multiply-add into one FMA; computing it in float64 and rounding
    once does the same), the triangle kernel widened by
    ``max(inv_scale, 1)`` (antialias; XLA multiplies by the float32
    reciprocal of that constant), each column normalised to sum 1 (guarded
    by 1000·eps), and zero where the sample lies outside the input.
    """
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = f32(max(1.0 / scale, 1.0))
    pos = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (pos.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist * (f32(1) / kernel_scale))  # (n_in, n_out)
    total = np.zeros((1, n_out), f32)
    for row in w:  # the column sums, in input order
        total = total + row
    w = np.where(np.abs(total) > f32(1000 * np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0)).T, dtype=f32)


@lru_cache(maxsize=None)
def _resize_taps(n_in: int, n_out: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The band of :func:`resize_weights_numpy`: (T, n_out) input indices and weights.

    Tap t of output o is its t-th nonzero weight in ascending input order;
    rows with fewer than T taps are padded with weight 0.
    """
    wm = resize_weights_numpy(n_in, n_out)
    nz = wm != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), 0)
    taps = int(nz.sum(axis=1).max())
    idx = np.minimum(first[None, :] + np.arange(taps)[:, None], n_in - 1)
    wt = np.take_along_axis(wm, idx.T, axis=1).T
    wt = np.where(first[None, :] + np.arange(taps)[:, None] < n_in, wt, 0).astype(np.float32)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device)


def resize_batch_u8(images: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Bilinear (B, H, W) uint8 resize with antialias — the pyramid downscale.

    The weights of the reference's CPU path (``jax.image.resize``, full
    float32), applied as banded sums: rows first, then columns, each output
    adding its taps in ascending input order as a separate multiply and
    add, then round half to even, clip and cast.  The same elementwise
    operations on the card and on the CPU give the same bits.
    """
    b, h, w = images.shape
    dev = str(images.device)
    x = images.to(torch.float32)
    idx, wt = _resize_taps(h, h_out, dev)
    rows = torch.zeros((b, h_out, w), dtype=torch.float32, device=images.device)
    for t in range(idx.shape[0]):
        rows = rows + wt[t][None, :, None] * x[:, idx[t], :]
    idx, wt = _resize_taps(w, w_out, dev)
    out = torch.zeros((b, h_out, w_out), dtype=torch.float32, device=images.device)
    for t in range(idx.shape[0]):
        out = out + wt[t][None, None, :] * rows[:, :, idx[t]]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
