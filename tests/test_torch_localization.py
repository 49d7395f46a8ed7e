"""Localization against a frozen map: tpuslam_torch's localization_only against tpuslam's, on the CPU.

The map comes from the port's own mapping run (``SlamSystem.run`` in PnP
mode over the ten fixtures, the flat vocabulary, K 512, 256 two-view
hypotheses, ratio test 0.8, inliers at 2 px, batch 5, the pose graph off),
written with the port's ``save_state`` and read by each package's
``load_state`` with its own ``checkpoint_template``: the reference's
localization runs on exactly the map and DB the port's does.

* ``localization_only`` needs ``tracking="pnp"`` and a ``warm_start`` map
  (the reference's ``ValueError``\\ s);
* ``_warm_start_map`` re-stamps the loaded keyframe ids exactly as the
  reference's does (and leaves them in localization mode);
* localization through ``run()`` from an unknown start (frames 5..9, seed
  3), the port replaying the reference's draws, against the reference's
  ``run()`` (its one compile in this file): the lock-in frame, ``pose_ok``
  and ``reloc_ok`` identical, positions within 1e-3 after lock-in, lock-in
  within one chunk, positions within 0.6 of the mapping run (the
  reference's bar), and the loaded map and DB bit-equal after the run in
  both packages;
* ``device_prefetch`` on the CPU yields each chunk unchanged and in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.frontend.pose  # noqa: F401 (imported before any trace: it builds a module constant)
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_pnp import jax_gumbel_samples
from test_torch_resume import batches
from test_torch_system import BATCH
from test_torch_system_lc import _blind_config
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam.utils.checkpoint import load_state as jload_state
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.pre.stream import FrameStream, device_prefetch
from tpuslam_torch.utils.checkpoint import load_state, save_state
from tpuslam_torch.utils.convert import map_state_from_numpy

START, SEED = 5, 3


def reference_draws(seed: int):
    """The reference run()'s draws of (seed, frame) in PnP mode: the port's four draw hooks.

    Chunk c's key is ``fold_in(PRNGKey(seed), c)``, split into the tracking key (split again into
    the two-view and the RANSAC-PnP key, each folded with the frame index) and the loop key
    (``split(key2, B)[b]``; relocalization ``split(fold_in(key2, 777), B)[b]``).
    """

    def keys(f):
        return jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), f // BATCH))

    def draw(f, n_valid, H, S):
        key = jax.random.fold_in(jax.random.split(keys(f)[0])[0], f)
        return np.array(jax.random.randint(key, (H, S), 0, jnp.maximum(jnp.int32(int(n_valid)), 1)))

    def pnp(f, valid):
        return jax_gumbel_samples(jax.random.fold_in(jax.random.split(keys(f)[0])[1], f), valid.numpy(), 64)

    def lc(f, valid):
        return jax_gumbel_samples(jax.random.split(keys(f)[1], BATCH)[f % BATCH], valid.numpy(), 512)

    def reloc(f, pnp_valid, n_valid):
        k, k_pnp = jax.random.split(jax.random.split(jax.random.fold_in(keys(f)[1], 777), BATCH)[f % BATCH])
        return (jax_gumbel_samples(k_pnp, pnp_valid.numpy(), 512),
                np.array(jax.random.randint(k, (1024, 5), 0, max(n_valid, 1))))

    return dict(draw_fn=draw, pnp_draw_fn=pnp, lc_draw_fn=lc, reloc_draw_fn=reloc)


@pytest.fixture(scope="module")
def cfg_dir(data_dir):
    return data_dir.parent.parent / "configs"


@pytest.fixture(scope="module")
def frames(data_dir):
    stream = FrameStream(data_dir / "images")
    return np.stack([stream.read_frame(i)[0] for i in range(stream.total_frames)])


def port_system(cfg_dir, **kw):
    return TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
                   vocabulary=cfg_dir / "vocabulary.npz", tracking="pnp", enable_pose_graph=False, device="cpu", **kw)


def reference_system(cfg_dir, **kw):
    return JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _blind_config(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
                   vocabulary=cfg_dir / "vocabulary.npz", tracking="pnp", enable_pose_graph=False, **kw)


@pytest.fixture(scope="module")
def mapping(cfg_dir, frames, tmp_path_factory):
    """The port's mapping run and the path of its checkpoint."""
    out = port_system(cfg_dir).run(batches(frames, BATCH), seed=0)
    path = tmp_path_factory.mktemp("map") / "map.npz"
    save_state(path, slam=out["checkpoint"])
    return out, path


def test_localization_requires_pnp_and_warm_start(cfg_dir, frames):
    with pytest.raises(ValueError, match="pnp"):
        TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"), TSlamConfig.from_yaml_dir(cfg_dir),
                vocabulary=cfg_dir / "vocabulary.npz", localization_only=True, device="cpu")
    loc = port_system(cfg_dir, localization_only=True)
    assert loc.enable_ba is False and loc.pipeline.freeze_map
    with pytest.raises(ValueError, match="warm_start"):
        loc.run_sequence(frames[:5], seed=1)
    with pytest.raises(ValueError, match="warm_start"):
        loc.run(batches(frames[:5], BATCH), seed=1)
    with pytest.raises(ValueError, match="warm_start"):
        loc.run(batches(frames[:5], BATCH), seed=1, warm_start={"db": None})


@pytest.mark.parametrize("localization_only", [False, True])
def test_warm_start_map_matches_reference(cfg_dir, mapping, localization_only):
    m = mapping[0]["map"]
    assert int(m.kf_valid.sum()) >= 5
    jm = jax.tree.map(jnp.asarray, jax.tree.map(lambda x: x.numpy(), m))
    want = reference_system(cfg_dir, localization_only=localization_only)._warm_start_map(jm)
    got = port_system(cfg_dir, localization_only=localization_only)._warm_start_map(m)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if localization_only:
        assert got is m
    else:
        assert (got.kf_id[got.kf_valid] <= -2).all() and torch.equal(got.kf_id[~got.kf_valid], m.kf_id[~m.kf_valid])


def test_localization_matches_reference(cfg_dir, frames, mapping):
    out, path = mapping
    jloc = reference_system(cfg_dir, localization_only=True)
    jloaded = jload_state(path, slam=jloc.checkpoint_template())["slam"]
    want = jloc.run(batches(frames[START:], BATCH), seed=SEED,
                    warm_start={"map": jloaded["world_map"], "db": jloaded["db"]})
    tloc = port_system(cfg_dir, localization_only=True, **reference_draws(SEED))
    loaded = load_state(path, device="cpu", slam=tloc.checkpoint_template())["slam"]
    got = tloc.run(batches(frames[START:], BATCH), seed=SEED, warm_start={"map": loaded["world_map"],
                                                                          "db": loaded["db"]})

    for k in ("pose_ok", "reloc_ok"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    ok = got["pose_ok"]
    lockin = int(np.argmax(ok))
    assert ok.any() and lockin < BATCH and got["reloc_ok"][lockin]  # the bootstrap relocalized
    np.testing.assert_allclose(got["poses"][lockin:, :3, 3], want["poses"][lockin:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got["poses"][lockin:, :3, :3], want["poses"][lockin:, :3, :3], atol=1e-4)
    err = np.linalg.norm(got["poses"][lockin + 1:, :3, 3] - out["poses"][START + lockin + 1:, :3, 3], axis=1)
    assert err.max() < 0.6, err
    assert got["ba_events"] == [] and got["loops"] == [] and not got["pose_graph_applied"]

    # frozen: the map and the DB after the run are the loaded ones, bit for bit, in both packages
    for name, frozen in (("world_map", loaded["world_map"]), ("db", loaded["db"])):
        for field, g, w, j in zip(frozen._fields, got["checkpoint"][name], frozen, want["checkpoint"][name]):
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name}.{field}")
            np.testing.assert_array_equal(np.asarray(j), w.numpy(), err_msg=f"reference {name}.{field}")
    np.testing.assert_array_equal(loaded["world_map"].kf_id.numpy(), out["map"].kf_id.numpy())
    assert map_state_from_numpy(jax.tree.map(np.asarray, jloaded["world_map"])).kf_id.equal(loaded["world_map"].kf_id)


def test_device_prefetch_on_the_cpu():
    rng = np.random.default_rng(0)
    chunks = [(rng.integers(0, 256, (3, 5, 7), dtype=np.uint8), np.full(3, float(i)), np.arange(3) < 3 - i)
              for i in range(5)]
    out = list(device_prefetch(iter(chunks), device="cpu", depth=2))
    assert len(out) == len(chunks)
    for (frames, stamps, valid), (f0, s0, v0) in zip(out, chunks):
        assert torch.is_tensor(frames) and frames.device.type == "cpu" and frames.dtype == torch.uint8
        np.testing.assert_array_equal(frames.numpy(), f0)
        assert stamps is s0 and valid is v0
