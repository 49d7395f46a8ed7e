"""Carry the reference package's fixed arrays across as the port's tensors.

The system has no learned weights; its parameters are fixed arrays built
from the config: the BRIEF pattern, the ±1 bin weights, the disc moment
weights, the blur taps, the undistortion gather map and ``K``.  These
functions take those arrays as numpy (for example read off a
``tpuslam`` ``FeatureDetector`` / ``SlamPipeline``) and return the
port's tensors, with the port's dtypes: indices become int64.

Detector keys: ``p1``, ``p2``, ``pair_valid``, ``slot_to_pair``,
``slot_used``, ``blur_kernel``, ``bin_weights_3d`` (absent with
``BriefQuantizedBins: 0``, the exact path), ``moment_weights``.
Pipeline keys: those, plus ``K``, ``undistort_idx`` and ``undistort_valid``.
The image pyramid (``NumLevels > 1``, ``configs/multiscale``) adds no
arrays: its resize weights are a function of the level shapes alone, so
the same keys carry a multi-level detector across unchanged.

The PnP tracker's state crosses the same way: ``map_state_from_numpy``,
``assoc_state_from_numpy`` and ``pnp_state_from_numpy`` take the
reference's ``MapState``, ``AssocState`` and ``PnpState`` (named tuples, or
mappings of their field names, holding array-likes) and return the port's,
so both packages can start from one map.  ``fold_inputs_from_numpy`` takes
the arguments of a chunk fold (``update_map_chunk``'s, ``frame_ids`` to
``point_ok``), and ``sequence_result_to_numpy`` turns either package's
``SlamSystem.run_sequence`` output into numpy for comparison.

Loop closure's state crosses too: ``vocabulary_from_numpy`` builds the
port's ``Vocabulary`` from the arrays of a ``.npz`` both packages read,
``keyframe_db_from_numpy`` takes the reference's ``KeyframeDB``, and
``loop_result_to_numpy`` turns either package's ``LoopResult`` into numpy.
``checkpoint_to_numpy`` turns either package's ``SlamSystem.run()``
checkpoint payload into nested dicts of numpy for comparison; carrying a
checkpoint across needs no converter, since both packages' ``load_state``
read the same file.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpuslam_torch.backend.loop_closure import KeyframeDB
from tpuslam_torch.backend.map import AssocState, MapState
from tpuslam_torch.backend.vocabulary import Vocabulary
from tpuslam_torch.frontend.fast import KeypointSet

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
    """The known keys that ``arrays`` holds (not None), as tensors; the consumer checks what it needs."""
    return {
        k: torch.from_numpy(np.array(arrays[k])).to(dt)  # a private, writable copy
        for k, dt in dtypes.items() if arrays.get(k) is not None
    }


def detector_arrays_from_numpy(arrays: dict) -> dict[str, torch.Tensor]:
    """Detector constants (numpy) → CPU tensors."""
    return _convert(arrays, _DETECTOR_DTYPES)


def pipeline_arrays_from_numpy(arrays: dict) -> dict[str, torch.Tensor]:
    """Pipeline constants (detector keys + ``K``, undistort map) → CPU tensors."""
    return _convert(arrays, {**_DETECTOR_DTYPES, **_PIPELINE_DTYPES})


_MAP_DTYPES = {
    "kf_R": torch.float32,
    "kf_t": torch.float32,
    "kf_id": torch.int32,
    "kf_valid": torch.bool,
    "points": torch.float32,
    "point_valid": torch.bool,
    "point_birth": torch.int32,
    "obs_uv": torch.float32,
    "obs_mask": torch.bool,
    "kf_count": torch.int32,
    "point_count": torch.int32,
}
_ASSOC_DTYPES = {
    "kp_to_point": torch.int32,
    "kp_birth": torch.int32,
    "prev_kf_slot": torch.int32,
    "prev_xy": torch.float32,
}
_VO_DTYPES = {
    "prev_desc": torch.uint8,
    "prev_exists": torch.bool,
    "pose": torch.float32,
    "prev_depth": torch.float32,
    "prev_depth_valid": torch.bool,
}
_KPS_DTYPES = {"xy": torch.float32, "response": torch.float32, "angle": torch.float32, "valid": torch.bool}


def _fields(x) -> Mapping:
    return x._asdict() if hasattr(x, "_asdict") else x


def _state(x, dtypes: dict, device) -> dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in _convert(_fields(x), dtypes).items()}


def map_state_from_numpy(m, device: torch.device | str = "cpu") -> MapState:
    """The reference's ``MapState`` → the port's, on ``device``."""
    return MapState(**_state(m, _MAP_DTYPES, device))


def assoc_state_from_numpy(a, device: torch.device | str = "cpu") -> AssocState:
    """The reference's ``AssocState`` → the port's, on ``device``."""
    return AssocState(**_state(a, _ASSOC_DTYPES, device))


def pnp_state_from_numpy(state, device: torch.device | str = "cpu"):
    """The reference's ``PnpState`` (VO carry, map, association) → the port's, on ``device``."""
    from tpuslam_torch.model.slam import PnpState, VoState

    fields = _fields(state)
    vo = _fields(fields["vo"])
    return PnpState(
        vo=VoState(
            prev_kps=KeypointSet(**_state(vo["prev_kps"], _KPS_DTYPES, device)),
            frame_idx=int(np.asarray(vo["frame_idx"])),
            **_state(vo, _VO_DTYPES, device),
        ),
        map=map_state_from_numpy(fields["map"], device),
        assoc=assoc_state_from_numpy(fields["assoc"], device),
    )


_FOLD_DTYPES = {
    "frame_ids": torch.int32,
    "kf_mask": torch.bool,
    "poses": torch.float32,
    "pose_ok": torch.bool,
    "kps_xy": torch.float32,
    "m_query": torch.int32,
    "m_train": torch.int32,
    "m_valid": torch.bool,
    "points3d_cur": torch.float32,
    "point_ok": torch.bool,
}


def fold_inputs_from_numpy(inputs, device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """A chunk's fold arguments (``frame_ids`` … ``point_ok``, array-likes) → the port's tensors."""
    return _state(inputs, _FOLD_DTYPES, device)


_DB_DTYPES = {
    "bow": torch.float32,
    "xy": torch.float32,
    "kp_valid": torch.bool,
    "descriptors": torch.uint8,
    "map_points": torch.float32,
    "mp_valid": torch.bool,
    "pose": torch.float32,
    "ids": torch.int32,
    "count": torch.int32,
    "last_id": torch.int32,
}


def vocabulary_from_numpy(centroids, idf=None, coarse=None, device: torch.device | str = "cpu") -> Vocabulary:
    """A vocabulary's arrays (flat, or tree with ``coarse``) → the port's ``Vocabulary`` on ``device``."""
    return Vocabulary(np.asarray(centroids), None if idf is None else np.asarray(idf),
                      None if coarse is None else np.asarray(coarse), device=device)


def keyframe_db_from_numpy(db, device: torch.device | str = "cpu") -> KeyframeDB:
    """The reference's ``KeyframeDB`` (or a mapping of its fields) → the port's."""
    return KeyframeDB(**_state(db, _DB_DTYPES, device))


def loop_result_to_numpy(res) -> dict:
    """Either package's ``LoopResult`` → a dict of numpy arrays."""
    return {name: _numpy(v) for name, v in _fields(res).items()}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sequence_result_to_numpy(out: dict) -> dict:
    """A ``run_sequence`` output (either package's) with arrays, and the map's fields, as numpy."""
    conv = {}
    for k, v in out.items():
        if k == "map" or (k == "db" and (hasattr(v, "_asdict") or isinstance(v, Mapping))):
            conv[k] = {name: _numpy(f) for name, f in _fields(v).items()}
        elif k == "loops":
            conv[k] = [{name: _numpy(f) if name == "relative_transform" else f for name, f in lp.items()}
                       for lp in v]
        elif k in ("ba_events", "pose_graph_applied", "db"):
            conv[k] = v
        else:
            conv[k] = _numpy(v)
    return conv


def checkpoint_to_numpy(payload) -> dict:
    """A ``run()`` checkpoint payload (either package's) → nested dicts of numpy arrays.

    Named tuples become dicts of their fields; every leaf, a scalar too, becomes an array.
    """

    def conv(x):
        if x is None:
            return None
        if isinstance(x, Mapping) or hasattr(x, "_asdict"):
            return {k: conv(v) for k, v in _fields(x).items()}
        if isinstance(x, (tuple, list)):
            return [conv(v) for v in x]
        return _numpy(x)

    return conv(payload)
