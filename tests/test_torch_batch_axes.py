"""The batch axes the reference vmaps, on the CPU.

* ``ransac_pnp`` over V = 5 problems (one with four valid matches, one with
  none) equals five unbatched calls bit for bit, with both LO refits; and
  equals ``jax.vmap`` of the reference's ``ransac_pnp`` over V keys, the
  port given each key's samples (``jax_gumbel_samples``): success, inlier
  count and inlier mask identical, R and t within 1e-4.
* ``motion_pnp`` over V = 4 problems, one seeded with a non-finite pose,
  equals four unbatched calls bit for bit; the non-finite one fails alone.
* ``SlamPipeline.process_chunks`` over S = 3 sequences equals three
  ``process_chunk`` calls bit for bit on every ``ChunkResult`` and
  ``VoState`` field, over two batched steps: the sequences start at frame
  0, 3 and 6 (each carry the result of its own earlier chunks), and the
  third one's second chunk is ragged.  At ``test_torch_dist.py``'s small
  shapes (696×256, K 256, 64 hypotheses), three frames a chunk.
* ``run_timesharded`` refuses a shard hook other than ``draw_fn``, which is
  all its batched step can take per shard.

The batched VO path is held against the reference by
``test_torch_timeshard.py::test_run_timesharded_matches_reference``, which
runs its shards as one batched sequence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_dist import tiny_camera, tiny_config, tiny_frames, tiny_pipeline
from test_torch_pnp import K, jax_gumbel_samples, perturbed, synthetic
from tpuslam.backend import pnp as jpnp
from tpuslam_torch.backend import pnp as tpnp
from tpuslam_torch.dist.timeshard import run_timesharded
from tpuslam_torch.model.slam import SlamPipeline

V, M, H = 5, 120, 256


def problems(seed: int):
    """V RANSAC-PnP problems: outliers and noise; problem 2 has four valid matches, problem 4 none."""
    rng = np.random.default_rng(seed)
    X, uv, valid = [], [], []
    for v in range(V):
        x, u, _, _ = synthetic(M, rng, outlier_frac=0.2 + 0.05 * v, noise_px=0.3)
        X.append(x)
        uv.append(u)
        valid.append(rng.random(M) > 0.15)
    valid[2][:] = False
    valid[2][[3, 9, 17, 30]] = True
    valid[4][:] = False
    return np.stack(X), np.stack(uv), np.stack(valid)


def T(x):
    return torch.from_numpy(np.asarray(x))


def assert_results_equal(batched, singles):
    for v, single in enumerate(singles):
        for name in single._fields:
            assert torch.equal(getattr(batched, name)[v], getattr(single, name)), (v, name)


@pytest.mark.parametrize("refine,lo_rounds,hyp_sweeps", [("dlt", 2, None), ("gn", 2, 6)])
def test_batched_ransac_pnp_equals_single_calls(refine, lo_rounds, hyp_sweeps):
    X, uv, valid = problems(0)
    idx = tpnp.gumbel_sample_indices(T(valid), H, 6, torch.Generator().manual_seed(1))  # (V, H, 6)
    kw = dict(num_hypotheses=H, min_inliers=12, refine=refine, lo_rounds=lo_rounds, hyp_sweeps=hyp_sweeps)
    batched = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(K), idx, **kw)
    assert batched.R.shape == (V, 3, 3) and batched.inliers.shape == (V, M) and batched.success.shape == (V,)
    singles = [tpnp.ransac_pnp(T(X[v]), T(uv[v]), T(valid[v]), T(K), idx[v], **kw) for v in range(V)]
    assert_results_equal(batched, singles)
    assert batched.success.tolist() == [True, True, False, True, False]
    # drawn inside the call: the (V, H, M) noise is the (H, M) noise of each problem in turn
    drawn = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(K), generator=torch.Generator().manual_seed(1), **kw)
    assert_results_equal(drawn, singles)


def test_batched_ransac_pnp_matches_reference_vmap():
    X, uv, valid = problems(1)
    keys = jax.random.split(jax.random.PRNGKey(11), V)
    kw = dict(num_hypotheses=H, min_inliers=12, refine="gn", lo_rounds=2, hyp_sweeps=6)
    want = jax.vmap(lambda x, u, m, k: jpnp.ransac_pnp(x, u, m, jnp.asarray(K), k, **kw))(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), keys)
    idx = np.stack([jax_gumbel_samples(keys[v], valid[v], H) for v in range(V)])
    got = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(K), T(idx), **kw)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.num_inliers.numpy(), np.asarray(want.num_inliers))
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    assert got.success.tolist() == [True, True, False, True, False]


def test_batched_motion_pnp_equals_single_calls():
    rng = np.random.default_rng(2)
    X, uv, R0, t0, valid = [], [], [], [], []
    for v in range(4):
        x, u, R, t = synthetic(100, rng, outlier_frac=0.2, noise_px=0.5)
        r0, s0 = perturbed(R, t, 2.0, rng.normal(size=3) * 0.05, rng)
        X.append(x), uv.append(u), R0.append(r0), t0.append(s0), valid.append(rng.random(100) > 0.1)
    R0[1] = np.full((3, 3), np.nan, np.float32)  # a non-finite seed: this problem fails, and only it
    X, uv, R0, t0, valid = map(np.stack, (X, uv, R0, t0, valid))
    kw = dict(iters=6, min_inliers=12, huber_schedule=(32.0, 16.0, 8.0, 4.0, 2.0, 2.0))
    batched = tpnp.motion_pnp(T(K), T(R0), T(t0), T(X), T(uv), T(valid), **kw)
    singles = [tpnp.motion_pnp(T(K), T(R0[v]), T(t0[v]), T(X[v]), T(uv[v]), T(valid[v]), **kw) for v in range(4)]
    assert_results_equal(batched, singles)
    assert batched.success.tolist() == [True, False, True, True]
    assert torch.equal(batched.R[1], torch.eye(3)) and int(batched.num_inliers[1]) == 0


def test_batched_vo_step_equals_process_chunk():
    """Two batched steps of three sequences against each sequence's own ``process_chunk`` calls."""
    pipe = SlamPipeline(tiny_camera(), tiny_config(), device="cpu", with_features=True)
    B, seeds = 3, [4, 5, 6]
    frames = [torch.from_numpy(tiny_frames(4 * B, start=4 * s)) for s in range(3)]
    ones = torch.ones(B, dtype=torch.bool)
    # sequence s has run s chunks of its own before the batched steps: it starts at frame 3s
    states = []
    for s in range(3):
        state = pipe.initial_state()
        for c in range(s):
            _, state = pipe.process_chunk(frames[s][c * B : (c + 1) * B], ones, state, seeds[s])
        states.append(state)
    assert [st.frame_idx for st in states] == [0, 3, 6]
    masks = [torch.stack([ones, ones, ones]), torch.stack([ones, ones, torch.tensor([True, True, False])])]
    want_states = list(states)
    for step, valid in enumerate(masks):
        chunk = torch.stack([frames[s][(s + step) * B : (s + step + 1) * B] for s in range(3)])
        results, states = pipe.process_chunks(chunk, valid, states, seeds)
        for s in range(3):
            want, want_states[s] = pipe.process_chunk(chunk[s], valid[s], want_states[s], seeds[s])
            for name in want._fields:
                w, g = getattr(want, name), getattr(results[s], name)
                assert (w is None) == (g is None) and (w is None or torch.equal(g, w)), (step, s, name)
            for name in want_states[s]._fields:
                w, g = getattr(want_states[s], name), getattr(states[s], name)
                if name == "prev_kps":
                    assert all(torch.equal(a, b) for a, b in zip(g, w)), (step, s, name)
                else:
                    assert (g == w) if isinstance(w, int) else torch.equal(g, w), (step, s, name)
            assert results[s].pose_ok[1:].any(), (step, s)
    assert [st.frame_idx for st in states] == [6, 9, 11]


def test_run_timesharded_refuses_hooks_it_cannot_honour():
    frames = tiny_frames(12)
    with pytest.raises(ValueError, match="pnp_draw_fn"):
        run_timesharded(tiny_pipeline(), frames, 2, seed=0, shard_hooks=lambda d: {"pnp_draw_fn": None})
