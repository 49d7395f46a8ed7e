"""Carry the reference package's fixed arrays across as the port's tensors.

The system has no learned weights; its parameters are fixed arrays built
from the config: the BRIEF pattern, the ±1 bin weights, the disc moment
weights, the blur taps, the undistortion gather map and ``K``.  These
functions take those arrays as numpy (for example read off a
``tpuslam`` ``FeatureDetector`` / ``SlamPipeline``) and return the
port's tensors, with the port's dtypes: indices become int64.

Detector keys: ``p1``, ``p2``, ``pair_valid``, ``slot_to_pair``,
``slot_used``, ``blur_kernel``, ``bin_weights_3d``, ``moment_weights``.
Pipeline keys: those, plus ``K``, ``undistort_idx`` and ``undistort_valid``.
The image pyramid (``NumLevels > 1``, ``configs/multiscale``) adds no
arrays: its resize weights are a function of the level shapes alone, so
the same keys carry a multi-level detector across unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

_DETECTOR_DTYPES = {
    "p1": torch.int32,
    "p2": torch.int32,
    "pair_valid": torch.bool,
    "slot_to_pair": torch.int64,
    "slot_used": torch.bool,
    "blur_kernel": torch.float32,
    "bin_weights_3d": torch.int8,
    "moment_weights": torch.int8,
}
_PIPELINE_DTYPES = {
    "K": torch.float32,
    "undistort_idx": torch.int64,
    "undistort_valid": torch.bool,
}


def _convert(arrays: dict, dtypes: dict) -> dict[str, torch.Tensor]:
    missing = sorted(set(dtypes) - set(arrays))
    if missing:
        raise KeyError(f"missing arrays: {missing}")
    return {
        k: torch.from_numpy(np.array(arrays[k])).to(dt)  # a private, writable copy
        for k, dt in dtypes.items()
    }


def detector_arrays_from_numpy(arrays: dict) -> dict[str, torch.Tensor]:
    """Detector constants (numpy) → CPU tensors."""
    return _convert(arrays, _DETECTOR_DTYPES)


def pipeline_arrays_from_numpy(arrays: dict) -> dict[str, torch.Tensor]:
    """Pipeline constants (detector keys + ``K``, undistort map) → CPU tensors."""
    return _convert(arrays, {**_DETECTOR_DTYPES, **_PIPELINE_DTYPES})
