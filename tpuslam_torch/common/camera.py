"""Camera model: intrinsics, distortion, and undistortion as a device gather.

Port of ``tpuslam/common/camera.py``.  The calibration loader and the host
gather map are the reference package's numpy code, copied; per-frame
undistortion is one index gather on the device (plain torch indexing — it
is not a kernel in the reference package either).

Behavioural contract: each output pixel maps through the forward radial
(k1, k2) + tangential (p1, p2) polynomial (k3 is read but unused, a quirk
kept from the reference), rounds half away from zero to a source pixel and
samples it; out-of-bounds samples become 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.config.yaml_io import load_opencv_yaml


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """std::round semantics: round half away from zero (np.round is half-even)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


@dataclass(frozen=True)
class Camera:
    """Pinhole camera with radial-tangential distortion."""

    K: np.ndarray  # (3, 3) float64 intrinsics
    D: np.ndarray  # (n,) float64 distortion [k1, k2, p1, p2, k3]
    width: int
    height: int

    @classmethod
    def from_yaml(cls, config_path: str | Path, camera_index: int = 0) -> "Camera":
        doc = load_opencv_yaml(config_path)
        k_key = f"K{camera_index}"
        d_key = f"D{camera_index}"
        if k_key not in doc or d_key not in doc:
            raise ValueError(f"Could not find keys {k_key} or {d_key} in file.")
        K = np.asarray(doc[k_key], dtype=np.float64).reshape(3, 3)
        D = np.asarray(doc[d_key], dtype=np.float64).reshape(-1)
        size = doc.get("ImageSize", None)
        if size is None:
            raise ValueError("Could not find key ImageSize in file.")
        width, height = int(size[0]), int(size[1])
        return cls(K=K, D=D, width=width, height=height)

    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def cx(self) -> float:
        return float(self.K[0, 2])

    @property
    def cy(self) -> float:
        return float(self.K[1, 2])

    def dist_coeff(self, i: int) -> float:
        return float(self.D[i]) if self.D.size > i else 0.0

    def undistort_map(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Inverse-sampling gather map (host, once per camera).

        Returns ``(v_src, u_src, valid)``, each (H, W): int32 source
        coordinates and a bool in-bounds mask.
        """
        h, w = self.height, self.width
        u = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0)
        v = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)

        x = (u - self.cx) / self.fx
        y = (v - self.cy) / self.fy
        r2 = x * x + y * y
        k1, k2 = self.dist_coeff(0), self.dist_coeff(1)
        p1, p2 = self.dist_coeff(2), self.dist_coeff(3)
        # NOTE: k3 = D[4] intentionally unused, matching the reference quirk.
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x_dist = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        y_dist = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
        u_dist = self.fx * x_dist + self.cx
        v_dist = self.fy * y_dist + self.cy

        u_src = _round_half_away(u_dist).astype(np.int64)
        v_src = _round_half_away(v_dist).astype(np.int64)
        valid = (u_src >= 0) & (u_src < w) & (v_src >= 0) & (v_src < h)
        u_src = np.clip(u_src, 0, w - 1).astype(np.int32)
        v_src = np.clip(v_src, 0, h - 1).astype(np.int32)
        return v_src, u_src, valid

    def device_undistort_map(
        self, device: torch.device | str = "cpu"
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather map on ``device``: flat int64 source indices + validity mask."""
        v_src, u_src, valid = self.undistort_map()
        flat_idx = v_src.astype(np.int64) * self.width + u_src
        return (
            torch.from_numpy(flat_idx).to(device),
            torch.from_numpy(valid).to(device),
        )


def undistort_batch(
    images: torch.Tensor, flat_idx: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Undistort (B, H, W) uint8 frames with one shared gather map → uint8.

    The detector consumes the uint8 scale directly (nearest-neighbour
    sampling preserves the reference's /255 quantisation).
    """
    b, h, w = images.shape
    gathered = images.reshape(b, h * w)[:, flat_idx.reshape(-1)].reshape(b, h, w)
    return torch.where(valid, gathered, torch.zeros((), dtype=images.dtype, device=images.device))
