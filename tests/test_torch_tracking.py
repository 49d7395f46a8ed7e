"""tpuslam_torch.model.tracking.pnp_track_chunk against tpuslam's on the CPU.

Both trackers get the same inputs: a map and an association built by the
reference (the first chunk of the KITTI fixtures through its PnP chunk
program, at MaxKeypoints 512, 256 two-view hypotheses, batch 4), converted
by ``tpuslam_torch.utils.convert``, and the reference's two-view outputs
for the second chunk.  The port's RANSAC-PnP samples are the reference's
own (its Gumbel indices recomputed from the same keys and masks).

Tolerances: every integer and boolean output identical (PnP success,
inlier counts, associations, the RANSAC flag, the map's counters, slots,
masks and births); poses to 1e-4 in rotation and 1e-3 in position; map
points and scales to 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pnp import jax_gumbel_samples
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend import map as jmap
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam.model.tracking import pnp_track_chunk as j_track
from tpuslam_torch.model.tracking import pnp_track_chunk as t_track
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.convert import assoc_state_from_numpy, map_state_from_numpy

K_CAP, H_HYP, BATCH = 512, 256, 4


def tt(x):
    return torch.from_numpy(np.array(x))


def replay(keys, H=64):
    """The port's sampler: the reference's indices for frame b under keys[b]."""
    return lambda b, valid: torch.from_numpy(jax_gumbel_samples(keys[b], valid.numpy(), H))


def assert_track_equal(got, want) -> None:
    (g_res, g_map, g_assoc, g_T), (w_res, w_map, w_assoc, w_T) = got, want
    for name in ("pnp_ok", "num_pnp_inliers", "num_assoc", "used_ransac", "point_count0",
                 "kp_to_point", "kp_birth"):
        np.testing.assert_array_equal(getattr(g_res, name).numpy(), np.asarray(getattr(w_res, name)), err_msg=name)
    np.testing.assert_allclose(g_res.poses[:, :3, :3].numpy(), np.asarray(w_res.poses)[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(g_res.poses[:, :3, 3].numpy(), np.asarray(w_res.poses)[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(g_res.scale.numpy(), np.asarray(w_res.scale), rtol=1e-4)
    np.testing.assert_allclose(g_T.numpy(), np.asarray(w_T), atol=1e-3)
    for name, g, w in zip(g_map._fields, g_map, w_map):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for name, g, w in zip(g_assoc._fields, g_assoc, w_assoc):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.fixture(scope="module")
def chunk(data_dir):
    """The reference's map after chunk 0, and its two-view outputs for chunk 1."""
    cfg_dir = data_dir.parent.parent / "configs"
    cfg = JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)
    cfg = dataclasses.replace(
        cfg,
        detector=dataclasses.replace(cfg.detector, max_keypoints=K_CAP),
        pose=dataclasses.replace(cfg.pose, num_hypotheses=H_HYP),
    )
    jp = JPipeline(JCamera.from_yaml(cfg_dir / "camera.yml"), cfg, tracking="pnp")
    batches = list(FrameStream(data_dir / "images").batches(BATCH))
    key = jax.random.PRNGKey(0)
    key_vo, key_pnp = jax.random.split(key)
    state = jp.initial_pnp_state()
    _, state = jp._chunk_pnp_fn(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][2]), state, key)
    frames, valid = jnp.asarray(batches[1][0]), jnp.asarray(batches[1][2])
    kps, _, match, mvalid, res, _, _, X_prev, X_cur, point_ok = jax.jit(jp._two_view_stage)(
        frames, valid, state.vo, key_vo
    )
    fids = np.arange(BATCH, dtype=np.int32) + int(state.vo.frame_idx)
    keys = [jax.random.fold_in(key_pnp, int(f)) for f in fids]
    args = (jp._K, state.vo.pose, jnp.asarray(fids), valid, jnp.stack(keys), res.R, res.t, res.success, kps.xy,
            match.query_idx, match.train_idx, mvalid, X_cur, X_prev[..., 2], point_ok)
    kw = dict(gate_px=cfg.map.assoc_gate_px, min_cand_depth=cfg.map.min_candidate_depth, gn_iters=3)
    return state, args, keys, kw


@pytest.mark.parametrize("freeze_map", [False, True])
def test_track_chunk_matches_reference(chunk, freeze_map):
    state, args, keys, kw = chunk
    want = j_track(state.map, state.assoc, *args, freeze_map=freeze_map, **kw)
    K, pose, fids, valid, _, *rest = args
    got = t_track(
        map_state_from_numpy(state.map), assoc_state_from_numpy(state.assoc), tt(K), tt(pose),
        [int(f) for f in fids], tt(valid), replay(keys), *(tt(x) for x in rest),
        freeze_map=freeze_map, **kw,
    )
    assert_track_equal(got, want)
    assert int(want[0].num_assoc.sum()) > 0  # the chunk re-observes the map
    if freeze_map:
        assert int(got[1].point_count) == int(state.map.point_count)


def test_track_chunk_ransac_fallback():
    """A teleported seed (60 degrees, 4 units off) fails the motion-model descent: RANSAC-PnP recovers
    the pose in both packages from exact correspondences of 256 mapped points."""
    rng = np.random.default_rng(3)
    N, k_cap = 256, 512
    Kn = np.asarray([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    X = rng.uniform([-6, -4, 8], [6, 4, 20], (N, 3)).astype(np.float32)

    def project(Xc):
        pix = Xc @ Kn.T
        return (pix[:, :2] / pix[:, 2:3]).astype(np.float32)

    m = jmap.empty_map(window=8, max_points=1024)
    m, slots = jmap.insert_points(m, jnp.asarray(X), jnp.ones(N, bool))
    m, kf0 = jmap.insert_keyframe(m, 0, jnp.eye(3), jnp.zeros(3), True)
    m = jmap.add_observations(m, kf0, slots, jnp.asarray(project(X)), jnp.ones(N, bool))
    assoc = jmap.AssocState(
        kp_to_point=jnp.full((k_cap,), -1, jnp.int32).at[:N].set(slots),
        kp_birth=jnp.full((k_cap,), -1, jnp.int32).at[:N].set(m.point_birth[slots]),
        prev_kf_slot=jnp.asarray(0, jnp.int32),
        prev_xy=jnp.zeros((k_cap, 2), jnp.float32).at[:N].set(jnp.asarray(project(X))),
    )
    a = np.deg2rad(25.0)
    R_wc = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    C = np.asarray([0.6, 0.1, 1.2], np.float32)
    uv1 = project((X - C) @ R_wc)
    b = np.deg2rad(60.0)  # the seed: the previous pose, teleported
    T_prev = np.eye(4, dtype=np.float32)
    T_prev[:3, :3] = [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]]
    T_prev[:3, 3] = [3.0, -2.0, 1.5]
    xy = np.zeros((1, k_cap, 2), np.float32)
    xy[0, :N] = uv1
    idx = np.full((1, N), -1, np.int32)
    idx[0] = np.arange(N)
    keys = list(jax.random.split(jax.random.PRNGKey(0), 1))
    inputs = (np.asarray([True]), np.eye(3, dtype=np.float32)[None], np.zeros((1, 3), np.float32),
              np.asarray([False]), xy, idx, idx, np.ones((1, N), bool), np.zeros((1, N, 3), np.float32),
              np.zeros((1, N), np.float32), np.zeros((1, N), bool))
    valid, *rest = inputs
    want = j_track(m, assoc, jnp.asarray(Kn), jnp.asarray(T_prev), jnp.asarray([1], jnp.int32),
                   jnp.asarray(valid), jnp.stack(keys), *(jnp.asarray(x) for x in rest))
    got = t_track(map_state_from_numpy(m), assoc_state_from_numpy(assoc), tt(Kn), tt(T_prev), [1],
                  tt(valid), replay(keys), *(tt(x) for x in rest))
    assert bool(want[0].used_ransac[0]) and bool(want[0].pnp_ok[0])
    assert_track_equal(got, want)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3], T_true[:3, 3] = R_wc, C
    np.testing.assert_allclose(got[0].poses[0].numpy(), T_true, atol=2e-2)
