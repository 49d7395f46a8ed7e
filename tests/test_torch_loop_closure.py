"""Loop closure: tpuslam_torch's LoopClosure and SlamSystem stages against tpuslam's on the CPU.

Features: the reference's detector (512 keypoints) on the loop fixture
``tests/data/images_test_loop2`` (ten views, the last a revisit of the
first), map points along each keypoint's ray at seeded depths, the shared
tree vocabulary and ``configs/loop_closure.yml``.  The reference's keys are
replayed through the port's samplers (``test_torch_pnp.jax_gumbel_samples``).

* ``_process_chunk_impl`` over two chunks (the second revisits the first)
  with VerifyBudget 0 and 4, FIFO, and redundancy eviction across a ring
  overflow at capacity 12: every database field exact but the BoW (1e-6),
  ``success``, ``candidate_id``, ``matched_keyframe_id`` and
  ``num_inliers`` identical, the verified R within 1e-4 and t within 1e-3;
  and a database of identical rows, whose eviction scores all tie.
* ``_relocalize_impl`` with a near revisit and two noise-blinded frames in
  need, budgets 2 and 1: ``ok``, ``num_inliers`` and the matched ids
  identical, poses within 1e-4 (rotation) and 1e-3 (position).
* PnP mode: ``SlamSystem._reloc_chunk_pnp`` and ``_lc_chunk`` on the
  reference's own chunk result and map (the ten KITTI fixtures with frames
  4 and 5 blinded, the second chunk: frame 6 is rescued), the port fed them
  converted.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.frontend.pose  # noqa: F401 (imported before any trace: it builds a module constant)
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_pnp import jax_gumbel_samples
from tpuslam.backend.loop_closure import LoopClosure as JLoopClosure
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import DetectorConfig
from tpuslam.config.schema import LoopClosureConfig as JLCConfig
from tpuslam.config.schema import MatcherConfig as JMatcherConfig
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.frontend.detector import FeatureDetector
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam_torch.backend.loop_closure import KeyframeDB
from tpuslam_torch.backend.loop_closure import LoopClosure as TLoopClosure
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import LoopClosureConfig as TLCConfig
from tpuslam_torch.config.schema import MatcherConfig as TMatcherConfig
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.slam import ChunkResult
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.convert import keyframe_db_from_numpy, loop_result_to_numpy, map_state_from_numpy

LOOP_K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], np.float32)
LOOP_INTS = ("success", "candidate_id", "matched_keyframe_id", "num_inliers")


@pytest.fixture(scope="module")
def cfg_dir(data_dir):
    return data_dir.parent.parent / "configs"


@pytest.fixture(scope="module")
def features(data_dir):
    det = FeatureDetector(DetectorConfig(max_keypoints=512))
    paths = sorted((data_dir / "images_test_loop2").glob("*.png"))
    feats = [det.detect_and_compute(jnp.asarray(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))) for p in paths]
    desc = np.stack([np.asarray(d) for _, d in feats])
    xy = np.stack([np.asarray(k.xy) for k, _ in feats])
    kv = np.stack([np.asarray(k.valid) for k, _ in feats])
    rng = np.random.default_rng(0)
    rays = np.concatenate([(xy - LOOP_K[:2, 2]) / LOOP_K[0, 0], np.ones(xy.shape[:2] + (1,))], -1)
    mp = (rays * rng.uniform(5, 15, xy.shape[:2] + (1,))).astype(np.float32)
    return desc, xy, kv, mp


def pair(cfg_dir, **over):
    """The reference's and the port's LoopClosure on configs/loop_closure.yml with ``over`` replaced."""
    jc = dataclasses.replace(JLCConfig.from_yaml(cfg_dir / "loop_closure.yml"), **over)
    tc = dataclasses.replace(TLCConfig.from_yaml(cfg_dir / "loop_closure.yml"), **over)
    voc = cfg_dir / "vocabulary_tree.npz"
    return (JLoopClosure(voc, jc, JMatcherConfig(ratio_test_threshold=0.8)),
            TLoopClosure(voc, tc, TMatcherConfig(ratio_test_threshold=0.8), device="cpu"))


def replay_sampler(keys):
    """The port's PnpSampler replaying the reference's per-frame keys."""

    def sampler(positions, valid, H):
        return torch.stack([torch.from_numpy(jax_gumbel_samples(keys[p], valid[i].numpy(), H))
                            for i, p in enumerate(positions)])

    return sampler


def replay_reloc_draws(keys):
    """The port's RelocDraws replaying the reference's keys: split → (five-point key, PnP key)."""

    def draws(sel, pnp_valid, n_valid, H):
        samples, ranks = [], []
        for i, b in enumerate(sel.tolist()):
            k, k_pnp = jax.random.split(keys[b])
            samples.append(jax_gumbel_samples(k_pnp, pnp_valid[i].numpy(), H))
            ranks.append(np.array(jax.random.randint(k, (1024, 5), 0, max(int(n_valid[i]), 1))))
        return torch.from_numpy(np.stack(samples)), torch.from_numpy(np.stack(ranks))

    return draws


def assert_db_equal(got: KeyframeDB, want):
    for name in KeyframeDB._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name == "bow":
            np.testing.assert_allclose(g, w, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def assert_loops_equal(got, want):
    got, want = loop_result_to_numpy(got), loop_result_to_numpy(want)
    for name in LOOP_INTS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["bow_score"], want["bow_score"], atol=1e-6)
    T, Tw = got["relative_transform"], want["relative_transform"]
    np.testing.assert_allclose(T[:, :3, :3], Tw[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(T[:, :3, 3], Tw[:, :3, 3], atol=1e-3)


CHUNK_CASES = {
    "budget0_fifo": dict(verify_budget=0, eviction_policy="fifo"),
    "budget4_fifo_disabled": dict(verify_budget=4, eviction_policy="fifo"),
    "budget4_redundancy_overflow": dict(verify_budget=4, eviction_policy="redundancy", max_keyframes=12,
                                        eviction_protect_recent=2),
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_process_chunk_matches_reference(case, cfg_dir, features):
    desc, xy, kv, mp = features
    B = len(desc)
    jl, tl = pair(cfg_dir, **CHUNK_CASES[case])
    enabled = np.array([not (case.endswith("disabled") and i in (3, 7)) for i in range(B)])
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    jdb, tdb = jl.new_db(512), tl.new_db(512)
    n_success = 0
    for c in range(2):  # the second chunk revisits the first
        fids = np.arange(B, dtype=np.int32) + c * B
        jdb, jres = jl.process_chunk(jdb, jnp.asarray(fids), jnp.asarray(enabled), jnp.asarray(desc),
                                     jnp.asarray(xy), jnp.asarray(kv), jnp.asarray(mp), jnp.asarray(kv),
                                     jnp.asarray(LOOP_K), keys)
        tdb, tres = tl.process_chunk(tdb, torch.from_numpy(fids), torch.from_numpy(enabled),
                                     torch.from_numpy(desc), torch.from_numpy(xy), torch.from_numpy(kv),
                                     torch.from_numpy(mp), torch.from_numpy(kv), torch.from_numpy(LOOP_K),
                                     replay_sampler(keys))
        assert_loops_equal(tres, jres)
        assert_db_equal(tdb, jdb)
        n_success += int(tres.success.sum())
    assert n_success >= 4  # the revisits verify


def test_eviction_ties_take_the_lowest_rows(cfg_dir, features):
    """A ring of identical rows: every redundancy score ties (and the two protected rows tie at
    −1e30), so the victims are the lowest rows, as ``lax.top_k`` picks them."""
    desc, xy, kv, mp = features
    B = 4
    jl, tl = pair(cfg_dir, eviction_policy="redundancy", max_keyframes=8, eviction_protect_recent=2)
    one = lambda a: np.repeat(a[:1], B, 0)  # noqa: E731
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    jdb, tdb = jl.new_db(512), tl.new_db(512)
    for c in range(3):  # 4, 8, then 12 rows into 8
        fids = np.arange(B, dtype=np.int32) + c * B
        args = (one(desc), one(xy), one(kv), one(mp), one(kv))
        jdb, jres = jl.process_chunk(jdb, jnp.asarray(fids), jnp.ones(B, bool), *map(jnp.asarray, args),
                                     jnp.asarray(LOOP_K), keys)
        tdb, tres = tl.process_chunk(tdb, torch.from_numpy(fids), torch.ones(B, dtype=torch.bool),
                                     *map(torch.from_numpy, args), torch.from_numpy(LOOP_K), replay_sampler(keys))
        assert_db_equal(tdb, jdb)
        assert_loops_equal(tres, jres)
    assert tdb.ids.tolist() == [8, 9, 10, 11, 4, 5, 6, 7]


def test_detect_and_add_keyframe_match_reference(cfg_dir, features):
    """The single-frame API: nine keyframes added one by one, then a revisit of the first detected
    (its features shifted by 1.5 px)."""
    desc, xy, kv, mp = features
    jl, tl = pair(cfg_dir)
    jdb, tdb = jl.new_db(512), tl.new_db(512)
    for i in range(9):
        jdb = jl.add_keyframe(jdb, i, jnp.asarray(desc[i]), jnp.asarray(xy[i]), jnp.asarray(kv[i]),
                              jnp.asarray(mp[i]))
        tdb = tl.add_keyframe(tdb, i, torch.from_numpy(desc[i]), torch.from_numpy(xy[i]), torch.from_numpy(kv[i]),
                              torch.from_numpy(mp[i]))
    assert_db_equal(tdb, jdb)
    key = jax.random.PRNGKey(5)
    q = xy[0] + 1.5
    want = jl.detect(jdb, jnp.asarray(desc[0]), jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(LOOP_K), key)
    got = tl.detect(tdb, torch.from_numpy(desc[0]), torch.from_numpy(q), torch.from_numpy(kv[0]),
                    torch.from_numpy(LOOP_K), replay_sampler([key]))
    g, w = loop_result_to_numpy(got), loop_result_to_numpy(want)
    for name in LOOP_INTS:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    np.testing.assert_allclose(g["relative_transform"], w["relative_transform"], atol=1e-3)
    assert g["success"] and g["matched_keyframe_id"] == 0


@pytest.fixture(scope="module")
def reloc_db(cfg_dir, features):
    """The reference's and the port's LoopClosure at the defaults and the reference's database of the
    ten frames at poses along a line, shared by the relocalization budgets."""
    desc, xy, kv, mp = features
    B = len(desc)
    jl, tl = pair(cfg_dir)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, 3] = np.arange(B)[:, None] * np.array([1.0, 0.25, 2.0])
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    fids = np.arange(B, dtype=np.int32)
    jdb, _ = jl.process_chunk(jl.new_db(512), jnp.asarray(fids), jnp.ones(B, bool), jnp.asarray(desc), jnp.asarray(xy),
                              jnp.asarray(kv), jnp.asarray(mp), jnp.asarray(kv), jnp.asarray(LOOP_K), keys,
                              poses=jnp.asarray(poses))
    return jl, tl, jdb, poses


@pytest.mark.parametrize("budget", [2, 1])
def test_relocalize_matches_reference(budget, reloc_db, features):
    desc, xy, kv, mp = features
    B = len(desc)
    jl, tl, jdb, poses = reloc_db
    tdb = keyframe_db_from_numpy(jdb)
    qdesc, qxy = desc.copy(), xy.copy()
    rng = np.random.default_rng(1)
    for b in (5, 7):  # noise-blinded frames: garbage features that still get BoW candidates
        qdesc[b] = rng.integers(0, 256, qdesc[b].shape, dtype=np.uint8)
    qxy[2] += 3.0  # frame 2 is a near revisit of keyframe 2
    need = np.zeros(B, bool)
    need[[2, 5, 7]] = True
    rkeys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jl.relocalize_chunk(jdb, jnp.asarray(need), jnp.asarray(qdesc), jnp.asarray(qxy), jnp.asarray(kv),
                               jnp.asarray(LOOP_K), rkeys, budget=budget)
    got = tl.relocalize_chunk(tdb, torch.from_numpy(need), torch.from_numpy(qdesc), torch.from_numpy(qxy),
                              torch.from_numpy(kv), torch.from_numpy(LOOP_K), replay_reloc_draws(rkeys), budget=budget)
    ok, T, ni, matched = (x.numpy() for x in got)
    np.testing.assert_array_equal(ok, np.asarray(want[0]))
    np.testing.assert_array_equal(ni, np.asarray(want[2]))
    np.testing.assert_array_equal(matched, np.asarray(want[3]))
    np.testing.assert_allclose(T[:, :3, :3], np.asarray(want[1])[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(T[:, :3, 3], np.asarray(want[1])[:, :3, 3], atol=1e-3)
    assert ok[2] and matched[2] == 2 and not ok[[0, 1, 3, 4, 6, 8, 9]].any()
    np.testing.assert_allclose(T[2, :3, 3], poses[2, :3, 3], atol=0.5)


# --- PnP mode: the system's stages on the reference's own chunk -----------------

BLIND_B = 5


def _blind_config(cfg):
    """The reference's relocalization scenario (``test_system.py``): ratio 0.8, inliers at 2 px."""
    return dataclasses.replace(
        cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512),
        matcher=dataclasses.replace(cfg.matcher, ratio_test_threshold=0.8),
        pose=dataclasses.replace(cfg.pose, num_hypotheses=256, inlier_threshold_px=2.0),
    )


@pytest.fixture(scope="module")
def pnp_chunk(cfg_dir, data_dir):
    """The reference's second PnP chunk of the blinded fixtures: result, map, DB and stage outputs."""
    stream = FrameStream(data_dir / "images")
    frames = np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])
    rng = np.random.default_rng(0)
    frames[4] = rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
    frames[5] = rng.integers(0, 256, frames[0].shape, dtype=np.uint8)
    jsys = JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BLIND_B)),
                   vocabulary=cfg_dir / "vocabulary.npz", tracking="pnp")
    valid = jnp.ones(BLIND_B, bool)
    st = jsys.pipeline.initial_pnp_state()
    db = jsys.loop_closure.new_db(512)
    for c in range(2):
        key1, key2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), c))
        fids = jnp.arange(BLIND_B, dtype=jnp.int32) + c * BLIND_B
        result, st = jsys.pipeline._chunk_pnp_full_fn(jnp.asarray(frames[c * BLIND_B:(c + 1) * BLIND_B]), valid,
                                                     st, key1)
        reloc_key = jax.random.fold_in(key2, 777)
        args = (db, result, st.map, valid, fids, reloc_key)
        result2, m2, M_last, r_ok = jsys._reloc_chunk_pnp_jit(*args)
        kf_enabled = valid & (result2.pose_ok | (fids == 0))
        db2, loops = jsys._lc_chunk_jit(db, fids, kf_enabled, result2, key2, BLIND_B, m=m2)
        if c == 0:
            db, st = db2, st._replace(map=m2)
    host = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return dict(args=host(args[:5]), keys=(reloc_key, key2), out=host((result2, m2, M_last, r_ok)),
                lc=host((kf_enabled, db2, loops)), jsys=jsys)


def _port_system(cfg_dir, keys):
    reloc_key, key2 = keys

    def reloc_draws(f, pnp_valid, n_valid):
        k, k_pnp = jax.random.split(jax.random.split(reloc_key, BLIND_B)[f % BLIND_B])
        return (jax_gumbel_samples(k_pnp, pnp_valid.numpy(), 512),
                np.array(jax.random.randint(k, (1024, 5), 0, max(n_valid, 1))))

    def lc_draws(f, valid):
        return jax_gumbel_samples(jax.random.split(key2, BLIND_B)[f % BLIND_B], valid.numpy(), 512)

    return TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BLIND_B)),
                   vocabulary=cfg_dir / "vocabulary.npz", tracking="pnp", device="cpu",
                   lc_draw_fn=lc_draws, reloc_draw_fn=reloc_draws)


def _chunk_result(res) -> ChunkResult:
    return ChunkResult(*(None if x is None else torch.from_numpy(np.array(x)) for x in res))


def test_pnp_reloc_chunk_on_reference_chunk(pnp_chunk, cfg_dir):
    db, result, m, valid, fids = pnp_chunk["args"]
    want_res, want_m, want_M, want_ok = pnp_chunk["out"]
    tsys = _port_system(cfg_dir, pnp_chunk["keys"])
    fids_d = torch.from_numpy(np.array(fids))
    got_res, got_m, got_M, got_ok = tsys._reloc_chunk_pnp(
        keyframe_db_from_numpy(db), _chunk_result(result), map_state_from_numpy(m), torch.from_numpy(np.array(valid)), fids_d,
        fids.tolist(), seed=0)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)
    assert want_ok[1]  # frame 6 (the first clean frame after the blind span) is rescued
    np.testing.assert_array_equal(got_res.pose_ok.numpy(), want_res.pose_ok)
    for g, w in ((got_res.poses, want_res.poses), (got_M[None], want_M[None])):
        np.testing.assert_allclose(g.numpy()[:, :3, :3], w[:, :3, :3], atol=1e-4)
        np.testing.assert_allclose(g.numpy()[:, :3, 3], w[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got_m.points.numpy(), want_m.points, atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got_m.kf_R.numpy(), want_m.kf_R, atol=1e-4)
    np.testing.assert_allclose(got_m.kf_t.numpy(), want_m.kf_t, atol=1e-3)
    for name in ("point_valid", "point_birth", "kf_id", "obs_mask"):
        np.testing.assert_array_equal(getattr(got_m, name).numpy(), getattr(want_m, name), err_msg=name)


def test_pnp_lc_chunk_on_reference_chunk(pnp_chunk, cfg_dir):
    """Landmark map points in the keyframe's camera frame into the DB, loop detection as the reference."""
    db, _, _, _, fids = pnp_chunk["args"]
    want_res, want_m, _, _ = pnp_chunk["out"]
    kf_enabled, want_db, want_loops = pnp_chunk["lc"]
    tsys = _port_system(cfg_dir, pnp_chunk["keys"])
    got_db, got_loops = tsys._lc_chunk(
        keyframe_db_from_numpy(db), torch.from_numpy(np.array(fids)), fids.tolist(), torch.from_numpy(kf_enabled),
        _chunk_result(want_res), seed=0, m=map_state_from_numpy(want_m))
    assert_loops_equal(got_loops, want_loops)
    for name in KeyframeDB._fields:
        g, w = getattr(got_db, name).numpy(), getattr(want_db, name)
        if name in ("bow", "map_points", "pose"):
            np.testing.assert_allclose(g, w, atol=1e-5 if name != "map_points" else 1e-4, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got_db.mp_valid[int(got_db.count) - 1].any()  # the newest keyframe stores landmarks
