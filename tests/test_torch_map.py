"""tpuslam_torch.backend.map against tpuslam's on the CPU: every field exact.

Seeded numpy inputs go through both packages, and every field of the
resulting states must be identical: duplicate target slots (the first
valid writer wins), slots out of range, ring wrap-around of point slots
with recycled observations, disabled keyframe inserts (slot −1, a no-op)
and int32 payloads above 2²⁴.  The reference's states cross over through
``tpuslam_torch.utils.convert``.

The chunk folds, ``update_map_chunk`` (the per-frame scan) and
``update_map_chunk_batched``, run on the reference's inputs: synthetic
chunks with real match chains (the construction of the reference's
``tests/test_map_batched.py``, copied) and the reference pipeline's own
outputs on the KITTI fixtures.  Integer and boolean fields must be
identical to the reference's, floats within 1e-6 (rtol and atol: the
port's 3-term products are summed in another order than XLA's); the port's
batched fold must equal its scan bit for bit, floats included.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.backend import map as jmap
from tpuslam.common.geometry import so3_exp
from tpuslam_torch.backend import map as tmap
from tpuslam_torch.utils.convert import assoc_state_from_numpy, fold_inputs_from_numpy, map_state_from_numpy


def assert_same(got, want) -> None:
    """Every field of a port state equals the reference's (dtype kind and values)."""
    for name, g, w in zip(got._fields, got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert g.numpy().dtype.kind == w.dtype.kind, name


def test_row_select_first_valid_writer_wins():
    """Duplicates, slots out of range, invalid entries; float rows and int32 above 2**24."""
    rng = np.random.default_rng(0)
    M, rows = 300, 64
    slots = rng.integers(-3, rows + 3, M).astype(np.int32)  # repeats, and out of range
    valid = rng.random(M) > 0.3
    fvals = rng.normal(size=(M, 3)).astype(np.float32)
    ivals = rng.integers(2**24, 2**31 - 1, (M, 2)).astype(np.int32)  # not exact in float32
    sel, written = jmap.row_select(jnp.asarray(slots), jnp.asarray(valid), rows)
    first, t_written = tmap.row_select(torch.from_numpy(slots), torch.from_numpy(valid), rows)
    np.testing.assert_array_equal(t_written.numpy(), np.asarray(written))
    for vals in (fvals, ivals, ivals[:, 0]):
        want = np.asarray(jmap.apply_row_select(sel, written, jnp.asarray(vals)))
        got = tmap.apply_row_select(first, t_written, torch.from_numpy(vals)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    # the first valid writer, by hand
    for r in range(rows):
        writers = np.flatnonzero(valid & (slots == r))
        if writers.size:
            assert first[r] == writers[0]


def test_empty_states_match_reference():
    assert_same(tmap.empty_map(5, 300), jmap.empty_map(5, 300))
    assert_same(tmap.empty_assoc(77), jmap.empty_assoc(77))


def test_insert_keyframe_ring_and_disabled_inserts():
    """Window 3, seven inserts (two disabled): slots, ring recycling, cleared observations."""
    rng = np.random.default_rng(1)
    jm, tm = jmap.empty_map(3, 40), tmap.empty_map(3, 40)
    for i, enabled in enumerate([True, True, False, True, True, False, True]):
        R = rng.normal(size=(3, 3)).astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        jm, jslot = jmap.insert_keyframe(jm, i * 10, jnp.asarray(R), jnp.asarray(t), enabled)
        tm, tslot = tmap.insert_keyframe(tm, i * 10, torch.from_numpy(R), torch.from_numpy(t), enabled)
        assert int(tslot) == int(jslot)
        if not enabled:
            assert int(tslot) == -1
        # observations in the slot, so that a recycled slot must clear them
        slots = rng.integers(0, 40, 25).astype(np.int32)
        uv = rng.normal(size=(25, 2)).astype(np.float32)
        ok = rng.random(25) > 0.2
        jm = jmap.add_observations(jm, jslot, jnp.asarray(slots), jnp.asarray(uv), jnp.asarray(ok))
        tm = tmap.add_observations(tm, tslot, torch.from_numpy(slots), torch.from_numpy(uv), torch.from_numpy(ok))
        assert_same(tm, jm)
    assert int(tm.kf_count) == 5


@pytest.mark.parametrize("capacity,n_new", [(1024, 512), (700, 700)])
def test_insert_points_ring_wraps_and_recycles(capacity, n_new):
    """Ten rounds of K candidates into a ring that wraps; recycled slots lose their observations."""
    rng = np.random.default_rng(capacity)
    jm = jmap.empty_map(4, capacity)
    tm = map_state_from_numpy(jm)
    for i in range(10):
        pts = rng.normal(size=(n_new, 3)).astype(np.float32) * 10
        valid = rng.random(n_new) > 0.45
        jm, jslots = jmap.insert_points(jm, jnp.asarray(pts), jnp.asarray(valid))
        tm, tslots = tmap.insert_points(tm, torch.from_numpy(pts), torch.from_numpy(valid))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        # observe the new points in keyframe i % 4 with duplicate slots in the list
        kf = i % 4
        obs = np.concatenate([np.asarray(jslots), np.asarray(jslots)[:50]])
        uv = rng.normal(size=(obs.shape[0], 2)).astype(np.float32)
        ok = rng.random(obs.shape[0]) > 0.1
        jm = jmap.add_observations(jm, kf, jnp.asarray(obs), jnp.asarray(uv), jnp.asarray(ok))
        tm = tmap.add_observations(tm, kf, torch.from_numpy(obs), torch.from_numpy(uv), torch.from_numpy(ok))
        assert_same(tm, jm)
    assert int(tm.point_count) > capacity  # the ring wrapped
    with pytest.raises(ValueError):
        tmap.insert_points(tm, torch.zeros((capacity + 1, 3)), torch.ones(capacity + 1, dtype=torch.bool))


def test_add_observations_duplicates_and_disabled_keyframe():
    """Duplicate point slots keep the first valid observation; kf_slot −1 changes nothing."""
    rng = np.random.default_rng(3)
    jm = jmap.empty_map(3, 50)
    tm = tmap.empty_map(3, 50)
    for kf in (1, -1, 2, 1):
        slots = rng.integers(-2, 55, 80).astype(np.int32)
        uv = rng.normal(size=(80, 2)).astype(np.float32) * 100
        ok = rng.random(80) > 0.25
        jm = jmap.add_observations(jm, kf, jnp.asarray(slots), jnp.asarray(uv), jnp.asarray(ok))
        before = tm
        tm = tmap.add_observations(tm, kf, torch.from_numpy(slots), torch.from_numpy(uv), torch.from_numpy(ok))
        assert_same(tm, jm)
        if kf < 0:
            assert_same(tm, before)


def test_converted_states_round_trip():
    """A reference map and association cross to the port field for field."""
    rng = np.random.default_rng(4)
    jm = jmap.empty_map(4, 64)
    jm, slots = jmap.insert_points(jm, jnp.asarray(rng.normal(size=(30, 3)), jnp.float32), jnp.ones(30, bool))
    jm, kf = jmap.insert_keyframe(jm, 7, jnp.eye(3), jnp.ones(3))
    assert_same(map_state_from_numpy(jm), jm)
    ja = jmap.AssocState(
        kp_to_point=jnp.asarray(rng.integers(-1, 64, 20), jnp.int32),
        kp_birth=jnp.asarray(rng.integers(-1, 64, 20), jnp.int32),
        prev_kf_slot=jnp.asarray(kf, jnp.int32),
        prev_xy=jnp.asarray(rng.normal(size=(20, 2)), jnp.float32),
    )
    assert_same(assoc_state_from_numpy(ja), ja)
    assert_same(assoc_state_from_numpy(ja._asdict()), ja)


# --- the chunk folds -------------------------------------------------------------

KS = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def make_chunks(rng, n_chunks=4, B=6, n_land=40, Kp=48, bad_match_frac=0.15, pose_fail=(), kf_every=1):
    """Synthetic fold inputs with cross-frame match chains (numpy).

    Each frame sees every landmark at a random keypoint slot; matches link
    the previous frame's slot of a landmark to the current one's, and a
    fraction point at a wrong landmark, so that the reprojection gate breaks
    the chain and a new landmark is born.  Sized so the point ring recycles.
    """
    X = rng.uniform([-6, -4, 8], [6, 4, 24], size=(n_land, 3)).astype(np.float32)
    perms = np.stack([rng.permutation(Kp)[:n_land] for _ in range(n_chunks * B)])
    chunks = []
    for c in range(n_chunks):
        fids = np.arange(c * B, (c + 1) * B, dtype=np.int32)
        poses = np.zeros((B, 4, 4), np.float32)
        kps_xy = np.zeros((B, Kp, 2), np.float32)
        m_query = np.full((B, n_land), -1, np.int32)
        m_train = np.full((B, n_land), -1, np.int32)
        m_valid = np.zeros((B, n_land), bool)
        pts3 = np.zeros((B, n_land, 3), np.float32)
        pok = np.zeros((B, n_land), bool)
        for i in range(B):
            f = c * B + i
            Rw = np.asarray(so3_exp(jnp.asarray(rng.normal(size=3) * 0.01)))
            C = np.array([0.2 * f, 0.05 * np.sin(f), 0.1 * f], np.float32)
            poses[i] = np.eye(4)
            poses[i][:3, :3] = Rw
            poses[i][:3, 3] = C
            cam = (X - C) @ Rw
            pix = cam @ KS.T
            kps_xy[i][perms[f]] = pix[:, :2] / pix[:, 2:] + rng.normal(size=(n_land, 2)) * 0.3
            if f == 0:
                continue
            q = perms[f - 1].copy()
            bad = rng.random(n_land) < bad_match_frac
            q[bad] = perms[f - 1][rng.integers(0, n_land, int(bad.sum()))]
            m_query[i] = q
            m_train[i] = perms[f]
            m_valid[i] = rng.random(n_land) < 0.9
            pts3[i] = cam + rng.normal(size=cam.shape).astype(np.float32) * 0.01
            pok[i] = rng.random(n_land) < 0.75
        chunks.append(dict(
            frame_ids=fids, kf_mask=fids % kf_every == 0, pose_ok=np.array([f not in pose_fail for f in fids]),
            poses=poses, kps_xy=kps_xy, m_query=m_query, m_train=m_train, m_valid=m_valid,
            points3d_cur=pts3, point_ok=pok,
        ))
    return chunks


def assert_close_states(got, want, tag, exact_floats=False):
    """Integer and boolean fields identical; floats within 1e-6, or bit for bit."""
    for name, g, w in zip(got._fields, got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else np.asarray(g)
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        assert g.dtype.kind == w.dtype.kind, f"{tag}: {name}"
        if g.dtype.kind == "f" and not exact_floats:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{tag}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}: {name}")


def run_folds(chunks, window, capacity, Kp, **kw):
    """Every chunk through the reference's scan and batched fold and the port's: all four agree."""
    js = jb = jmap.empty_map(window=window, max_points=capacity)
    jas = jab = jmap.empty_assoc(Kp)
    ts = tb = tmap.empty_map(window, capacity)
    tas = tab = tmap.empty_assoc(Kp)
    Kj, Kt = jnp.asarray(KS), torch.from_numpy(KS)
    for c, ch in enumerate(chunks):
        jch = {k: jnp.asarray(v) for k, v in ch.items()}
        tch = fold_inputs_from_numpy(ch)
        js, jas = jmap.update_map_chunk(js, jas, Kj, **jch)
        jb, jab = jmap.update_map_chunk_batched(jb, jab, Kj, **jch, **kw)
        ts, tas = tmap.update_map_chunk(ts, tas, Kt, **tch)
        tb, tab = tmap.update_map_chunk_batched(tb, tab, Kt, **tch, **kw)
        for got, want, what in ((ts, js, "map"), (tas, jas, "assoc")):
            assert_close_states(got, want, f"chunk {c}: scan {what} against the reference's")
        for got, want, what in ((tb, jb, "map"), (tab, jab, "assoc")):
            assert_close_states(got, want, f"chunk {c}: batched {what} against the reference's")
        for got, want, what in ((tb, ts, "map"), (tab, tas, "assoc")):
            assert_close_states(got, want, f"chunk {c}: batched {what} against the scan", exact_floats=True)
    return ts


# (seed, make_chunks arguments, window, capacity): the cases of the reference's batched-fold tests
FOLD_CASES = {
    "basic": (11, dict(n_chunks=3, B=6, n_land=40, Kp=48), 4, 512),
    "ring_recycling": (7, dict(n_chunks=5, B=6, n_land=40, Kp=48), 3, 160),
    "pose_failures_sparse_keyframes": (
        3, dict(n_chunks=4, B=6, n_land=32, Kp=40, pose_fail=(2, 3, 7, 13, 14, 15), kf_every=2), 4, 512),
    "dead_chunk": (5, dict(n_chunks=3, B=4, n_land=24, Kp=32), 4, 256),
    "window_exceeds_chunk": (13, dict(n_chunks=5, B=3, n_land=24, Kp=32), 6, 400),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_chunk_folds_match_reference(case):
    seed, kw, window, capacity = FOLD_CASES[case]
    chunks = make_chunks(np.random.default_rng(seed), **kw)
    if case == "dead_chunk":  # no keyframe in the middle chunk: a map no-op, identity still carried
        chunks[1]["kf_mask"] = np.zeros(kw["B"], bool)
    m = run_folds(chunks, window, capacity, kw["Kp"])
    if case == "ring_recycling":
        assert int(m.point_count) > capacity


def test_batched_fold_capacity_overflow_matches_reference():
    """More new landmarks a frame than ``new_per_frame``, more observations a row than
    ``obs_per_row``: the batched folds drop the same ones (the scan keeps all)."""
    chunks = make_chunks(np.random.default_rng(17), n_chunks=2, B=4, n_land=40, Kp=48)
    jm, ja = jmap.empty_map(window=4, max_points=512), jmap.empty_assoc(48)
    tm, ta = tmap.empty_map(4, 512), tmap.empty_assoc(48)
    for ch in chunks:
        jm, ja = jmap.update_map_chunk_batched(jm, ja, jnp.asarray(KS), **{k: jnp.asarray(v) for k, v in ch.items()},
                                               new_per_frame=9, obs_per_row=20)
        tm, ta = tmap.update_map_chunk_batched(tm, ta, torch.from_numpy(KS), **fold_inputs_from_numpy(ch),
                                               new_per_frame=9, obs_per_row=20)
        assert_close_states(tm, jm, "map")
        assert_close_states(ta, ja, "assoc")
    assert int(tm.obs_mask.sum(dim=1).max()) == 20


def test_batched_fold_rejects_degenerate_window():
    (ch,) = make_chunks(np.random.default_rng(1), n_chunks=1, B=3, n_land=8, Kp=12)
    with pytest.raises(ValueError):
        tmap.update_map_chunk_batched(tmap.empty_map(1, 64), tmap.empty_assoc(12), torch.from_numpy(KS),
                                      **fold_inputs_from_numpy(ch))


@functools.lru_cache(maxsize=1)
def reference_fixture_chunks(data_dir):
    """The reference VO pipeline's fold inputs on the 10 KITTI fixtures (K 512, 256 hypotheses,
    batch 5): a list of two chunks' arguments (numpy) and ``K``."""
    from tpuslam.common.camera import Camera
    from tpuslam.config.schema import SlamConfig
    from tpuslam.model.slam import SlamPipeline
    from tpuslam_torch.pre.stream import FrameStream

    cfg_dir = data_dir.parent.parent / "configs"
    cfg = SlamConfig.from_yaml_dir(cfg_dir, batch_size=5)
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512),
                              pose=dataclasses.replace(cfg.pose, num_hypotheses=256))
    jp = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"), cfg)
    state = jp.initial_state()
    chunks = []
    for c, (frames, _, valid) in enumerate(FrameStream(data_dir / "images").batches(5)):
        res, state = jp._chunk_full_fn(jnp.asarray(frames), jnp.asarray(valid), state, jax.random.PRNGKey(c))
        fids = np.arange(5 * c, 5 * c + 5, dtype=np.int32)
        chunks.append(dict(
            frame_ids=fids, kf_mask=np.asarray(valid), poses=res.poses, pose_ok=res.pose_ok, kps_xy=res.kps_xy,
            m_query=res.m_query, m_train=res.m_train, m_valid=res.m_valid, points3d_cur=res.points3d,
            point_ok=res.point_ok,
        ))
    return [{k: np.array(v) for k, v in ch.items()} for ch in chunks], np.array(jp._K)


@pytest.fixture(scope="module")
def fixture_chunks(data_dir):
    return reference_fixture_chunks(data_dir)


def test_chunk_folds_on_fixture_chunks_match_reference(fixture_chunks):
    """The pipeline's own chunks (window 8, 4096 points, the default capacities): all four folds agree."""
    chunks, K = fixture_chunks
    m = tmap.empty_map(8, 4096)
    a = tmap.empty_assoc(512)
    jm, ja = jmap.empty_map(8, 4096), jmap.empty_assoc(512)
    jb, jab = jm, ja
    tb, tab = m, a
    for c, ch in enumerate(chunks):
        jch = {k: jnp.asarray(v) for k, v in ch.items()}
        tch = fold_inputs_from_numpy(ch)
        jm, ja = jmap.update_map_chunk(jm, ja, jnp.asarray(K), **jch)
        jb, jab = jmap.update_map_chunk_batched(jb, jab, jnp.asarray(K), **jch)
        m, a = tmap.update_map_chunk(m, a, torch.from_numpy(K), **tch)
        tb, tab = tmap.update_map_chunk_batched(tb, tab, torch.from_numpy(K), **tch)
        assert_close_states(m, jm, f"chunk {c}: scan map")
        assert_close_states(a, ja, f"chunk {c}: scan assoc")
        assert_close_states(tb, jb, f"chunk {c}: batched map")
        assert_close_states(tab, jab, f"chunk {c}: batched assoc")
        assert_close_states(tb, m, f"chunk {c}: batched map against the scan", exact_floats=True)
        assert_close_states(tab, a, f"chunk {c}: batched assoc against the scan", exact_floats=True)
    nobs = m.obs_mask.sum(dim=0)[m.point_valid]
    assert int(m.point_count) > 100 and float((nobs[nobs > 0] >= 2).float().mean()) > 0.5


def test_apply_row_scatter_and_compact_valid():
    """The BA write-back scatter and the stable compaction, against the reference's."""
    rng = np.random.default_rng(8)
    target = rng.normal(size=(50, 3)).astype(np.float32)
    vals = rng.normal(size=(70, 3)).astype(np.float32)
    slots = rng.integers(-2, 53, 70).astype(np.int32)
    ok = rng.random(70) > 0.3
    want = jmap._apply_row_scatter(jnp.asarray(target), jnp.asarray(vals), jnp.asarray(slots), jnp.asarray(ok))
    got = tmap._apply_row_scatter(torch.from_numpy(target), torch.from_numpy(vals), torch.from_numpy(slots),
                                  torch.from_numpy(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for cap in (10, 70):
        jv, (jp,) = jmap._compact_valid(jnp.asarray(ok), [jnp.asarray(vals)], cap)
        tv, (tp,) = tmap._compact_valid(torch.from_numpy(ok), [torch.from_numpy(vals)], cap)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        n = int(np.asarray(jv).sum())  # the invalid tail's order is unspecified
        np.testing.assert_array_equal(tp.numpy()[:n], np.asarray(jp)[:n])
