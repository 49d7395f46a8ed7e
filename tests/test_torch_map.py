"""tpuslam_torch.backend.map against tpuslam's on the CPU: every field exact.

Seeded numpy inputs go through both packages, and every field of the
resulting states must be identical: duplicate target slots (the first
valid writer wins), slots out of range, ring wrap-around of point slots
with recycled observations, disabled keyframe inserts (slot −1, a no-op)
and int32 payloads above 2²⁴.  The reference's states cross over through
``tpuslam_torch.utils.convert``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.backend import map as jmap
from tpuslam_torch.backend import map as tmap
from tpuslam_torch.utils.convert import assoc_state_from_numpy, map_state_from_numpy


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
