"""Checkpoints across packages: tpuslam_torch.utils.checkpoint against tpuslam.utils.checkpoint.

Both write one ``.npz`` of ``"{name}.leaf_{i}"`` arrays in JAX's pytree
order with a JSON ``__manifest__``, so a file written by either package
loads in the other.  The reference's five cases (``test_checkpoint.py``)
run in both directions: written by the port and read by the reference with
its own templates, and written by the reference and read by the port.  The
two ``SlamSystem.checkpoint_template``\\ s have the same leaves (count,
dtype and shape, in order) in VO and PnP mode, with and without loop
closure, and ``VoState.frame_idx`` comes back as a Python ``int``.  No SLAM
run: the plain VO pipeline's checkpoint through the CLI in-process
(``--save-state`` then ``--resume`` writes the uninterrupted trajectory,
at the shapes of ``test_torch_resume.py``, which holds the ``--slam`` case).
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend.loop_closure import empty_db as jempty_db
from tpuslam.backend.map import empty_map as jempty_map
from tpuslam.backend.map import insert_keyframe, insert_points
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam.utils import checkpoint as jckpt
from tpuslam_torch import cli
from tpuslam_torch.backend.loop_closure import empty_db as tempty_db
from tpuslam_torch.backend.map import empty_map as tempty_map
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.utils import checkpoint as tckpt
from tpuslam_torch.utils.convert import map_state_from_numpy

DIRECTIONS = [("port", "reference"), ("reference", "port")]


def save(pkg: str, path, **trees):
    (tckpt if pkg == "port" else jckpt).save_state(path, **trees)


def load(pkg: str, path, **templates):
    if pkg == "port":
        return tckpt.load_state(path, device="cpu", **templates)
    return jckpt.load_state(path, **templates)


def a_map():
    """The reference's test map (a keyframe and five points in a 4 x 64 window), as the reference's."""
    m = jempty_map(window=4, max_points=64)
    m, _ = insert_keyframe(m, 3, jnp.eye(3) * 2.0, jnp.asarray([1.0, 2, 3]))
    m, _ = insert_points(m, jnp.ones((5, 3)), jnp.ones(5, bool))
    return m


def in_package(pkg: str, tree):
    """A reference map in ``pkg``'s own types."""
    return tree if pkg == "reference" else map_state_from_numpy(jax.tree.map(np.asarray, tree))


def empty_map(pkg: str, window: int, max_points: int):
    return jempty_map(window, max_points) if pkg == "reference" else tempty_map(window, max_points)


def empty_db(pkg: str, *args):
    return jempty_db(*args) if pkg == "reference" else tempty_db(*args)


def assert_leaves_equal(got, want):
    g, w = jax.tree.leaves(jax.tree.map(np.asarray, tuple(got))), jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_roundtrip_map_state(tmp_path, writer, reader):
    m = a_map()
    p = tmp_path / "ckpt.npz"
    save(writer, p, map=in_package(writer, m))
    back = load(reader, p, map=empty_map(reader, 4, 64))["map"]
    assert type(back).__module__.startswith("tpuslam_torch" if reader == "port" else "tpuslam.")
    if reader == "port":
        assert all(torch.is_tensor(x) for x in back)
        back = [x.numpy() for x in back]
    assert_leaves_equal(back, m)


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_roundtrip_multiple_states(tmp_path, writer, reader):
    traj = np.random.default_rng(0).normal(size=(7, 4, 4))
    p = tmp_path / "ckpt.npz"
    save(writer, p, map=empty_map(writer, 2, 8), db=empty_db(writer, 4, 16, 8, 32), trajectory=traj)
    out = load(reader, p, map=empty_map(reader, 2, 8), db=empty_db(reader, 4, 16, 8, 32),
               trajectory=np.zeros((7, 4, 4)))
    back = np.asarray(out["trajectory"])  # float32 in the reference: jnp.asarray without x64
    np.testing.assert_array_equal(back, traj.astype(np.float64 if reader == "port" else np.float32))
    assert out["db"].bow.shape == (4, 16)
    assert_leaves_equal([np.asarray(x) for x in out["db"]], jempty_db(4, 16, 8, 32))


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_missing_checkpoint(tmp_path, reader):
    with pytest.raises(FileNotFoundError):
        load(reader, tmp_path / "nonexistent" / "ckpt.npz", map=empty_map(reader, 2, 8))


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_missing_name(tmp_path, writer, reader):
    p = tmp_path / "ckpt.npz"
    save(writer, p, map=empty_map(writer, 2, 8))
    with pytest.raises(KeyError, match="no state named 'db'"):
        load(reader, p, db=empty_db(reader, 2, 4, 4, 32))


@pytest.mark.parametrize("writer, reader", DIRECTIONS)
def test_wrong_template(tmp_path, writer, reader):
    p = tmp_path / "ckpt.npz"
    save(writer, p, map=empty_map(writer, 2, 8))
    two = (torch.zeros(3), torch.zeros(3)) if reader == "port" else (jnp.zeros(3), jnp.zeros(3))
    with pytest.raises(ValueError, match="leaves"):
        load(reader, p, map=two)


def test_leaf_order_is_jax_order():
    """Dict keys sorted, named tuples in field order, None no leaf, scalars one leaf each."""
    tree = {"b": (1, None, 2.5), "a": [torch.zeros(2), {"d": np.ones(1), "c": True}], "e": None}
    got = tckpt.flatten(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want) == 5
    assert [type(x) for x in got] == [type(x) for x in want]
    assert got[0] is tree["a"][0] and got[1] is True and got[2] is tree["a"][1]["d"] and got[3:] == [1, 2.5]


def _systems(data_dir, tracking, vocabulary):
    cfg_dir = data_dir.parent.parent / "configs"
    voc = None if vocabulary is None else cfg_dir / vocabulary

    def small(cfg):
        return dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512))

    jsys = JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"), small(JSlamConfig.from_yaml_dir(cfg_dir)),
                   vocabulary=voc, tracking=tracking)
    tsys = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"), small(TSlamConfig.from_yaml_dir(cfg_dir)),
                   vocabulary=voc, tracking=tracking, device="cpu")
    return jsys, tsys


@pytest.mark.parametrize("tracking", ["vo", "pnp"])
@pytest.mark.parametrize("vocabulary", [None, "vocabulary_tree.npz"])
def test_checkpoint_template_leaves_match(data_dir, tracking, vocabulary):
    jsys, tsys = _systems(data_dir, tracking, vocabulary)
    want = jax.tree.leaves(jsys.checkpoint_template())
    got = tckpt.flatten(tsys.checkpoint_template())
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = tckpt._to_numpy(g)
        assert (g.dtype, g.shape) == (np.asarray(w).dtype, np.asarray(w).shape), i


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_frame_idx_restored_as_int(tmp_path, data_dir, writer):
    jsys, tsys = _systems(data_dir, "vo", None)
    if writer == "port":
        state = tsys.pipeline.initial_state()._replace(frame_idx=37)
    else:
        state = jsys.pipeline.initial_state()._replace(frame_idx=jnp.int32(37))
    p = tmp_path / "ckpt.npz"
    save(writer, p, state=state)
    with np.load(p) as data:
        assert data["state.leaf_7"].dtype == np.int32 and data["state.leaf_7"].shape == ()
    back = load("port", p, state=tsys.pipeline.initial_state())["state"]
    assert type(back.frame_idx) is int and back.frame_idx == 37
    assert back.pose.dtype == torch.float32 and back.prev_exists.dtype == torch.bool


def test_cli_resume_reproduces_the_uninterrupted_run(tmp_path, data_dir):
    """Plain VO at batch 4: the first part stops after the chunk that reaches frame 6 (8 frames)."""
    base = cli_args(small_config_dir(tmp_path, data_dir.parent.parent / "configs"), data_dir, 4)
    full, part1, part2, ckpt = (tmp_path / n for n in ("full.txt", "part1.txt", "part2.txt", "ckpt.npz"))
    assert cli.main(base + ["-o", str(full)]) == 0
    assert cli.main(base + ["-o", str(part1), "--max-frames", "6", "--save-state", str(ckpt)]) == 0
    with np.load(ckpt) as data:  # the reference CLI's layout: the trajectory and the VO carry
        assert json.loads(bytes(data["__manifest__"]).decode()).keys() == {"trajectory", "state"}
    assert cli.main(base + ["-o", str(part2), "--resume", str(ckpt)]) == 0
    check_split_trajectories(full, part1, part2, 8)


def small_config_dir(tmp_path, cfg_dir):
    """``configs/`` at the test shapes, MaxKeypoints 512 and NumHypotheses 256, in ``tmp_path``."""
    d = tmp_path / "configs"
    d.mkdir()
    for p in cfg_dir.iterdir():
        if p.is_file():
            shutil.copy(p, d / p.name)
    det = (d / "feature_detector.yml").read_text().replace("MaxKeypoints: 1024", "MaxKeypoints: 512")
    (d / "feature_detector.yml").write_text(det)
    (d / "pose_estimator.yml").write_text("%YAML:1.0\n---\nNumHypotheses: 256\n")
    cfg = TSlamConfig.from_yaml_dir(d)
    assert cfg.detector.max_keypoints == 512 and cfg.pose.num_hypotheses == 256
    return d


def cli_args(config_dir, data_dir, batch: int) -> list[str]:
    return ["-c", str(config_dir), "-v", str(data_dir / "images"), "--batch-size", str(batch), "--device", "cpu"]


def check_split_trajectories(full, part1, part2, split_at: int):
    """The resumed run's trajectory file equals the uninterrupted one's, and the first part is its prefix."""
    T_full, T_part1, T_split = (np.loadtxt(p) for p in (full, part1, part2))
    assert T_full.shape == T_split.shape == (10, 12) and T_part1.shape == (split_at, 12)
    np.testing.assert_array_equal(T_split, T_full)
    np.testing.assert_array_equal(T_part1, T_full[:split_at])
