"""The soak (``tpuslam_torch/tools/soak.py``) against tpuslam's on the CPU.

* ``build_sequence``: the port's frame order equals the reference's
  ``tools/soak.py::build_sequence`` (read through a stand-in stream whose
  frame i is the value i), at 1,536 and 96 frames, with the same
  ``filler_end``.
* The subsystem soak of ``tests/test_eviction.py``: 400 self-similar
  filler frames through a 24-slot ring under the redundancy policy, then a
  revisit, through the port's ``LoopClosure`` on the reference's inputs with
  its draws replayed: every chunk's candidates and verdicts, the DB's ids
  and the tail's candidates identical, and the ring never grew.
* A short system soak in both packages at the small shapes (K 512, 256
  hypotheses, batch 5, a ring of 8 keyframes, 35 frames of the soak's
  sequence: its shortest, one filler cycle, which still overflows the ring
  from the second chunk on and revisits the prologue), the port through
  ``run_soak``: loops, ``pose_ok`` and the set of the DB's surviving ids
  identical.  The slots they occupy differ (not
  traced to an op; likely: the filler repeats four fixture frames, so
  redundancy scores, each row's largest BoW similarity to another, can tie
  to within the rounding of the (C, C) product, which XLA and torch sum in
  different orders, and a tie decides which slot is evicted first; ROADMAP
  F5).
"""

import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.frontend.pose  # noqa: F401 (imported before any trace: it builds a module constant)
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_loop_closure import replay_sampler
from test_torch_system import BATCH, _small, draw_fn
from test_torch_system_lc import lc_draws, reloc_draws
from tpuslam.backend.loop_closure import LoopClosure as JLoopClosure
from tpuslam.backend.vocabulary import Vocabulary as JVocabulary
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import LoopClosureConfig as JLCConfig
from tpuslam.config.schema import MatcherConfig as JMatcherConfig
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.system import SlamSystem as JSystem
from tpuslam_torch.backend.loop_closure import LoopClosure as TLoopClosure
from tpuslam_torch.backend.vocabulary import Vocabulary as TVocabulary
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import LoopClosureConfig as TLCConfig
from tpuslam_torch.config.schema import MatcherConfig as TMatcherConfig
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model.system import SlamSystem as TSystem
from tpuslam_torch.tools import soak


class _IndexStream:
    """Stands in for the reference's FrameStream: frame i is a 1x1 image of value i."""

    def __init__(self, path, *a, **k):
        self.total_frames = 10

    def read_frame(self, i):
        return np.full((1, 1), i, np.uint8), float(i)


@pytest.fixture(scope="module")
def reference_build_sequence(data_dir):
    """``tools/soak.py::build_sequence`` with the reference's stream swapped for ``_IndexStream``."""
    import tpuslam.pre.stream
    import tpuslam.utils.platform

    mp = pytest.MonkeyPatch()
    mp.setattr(tpuslam.utils.platform, "apply_env_platform", lambda: None)  # the tool sets JAX's platform
    mp.setattr(tpuslam.pre.stream, "FrameStream", _IndexStream)
    spec = importlib.util.spec_from_file_location("reference_soak", data_dir.parent.parent / "tools" / "soak.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    yield module.build_sequence
    mp.undo()


@pytest.mark.parametrize("n", [1536, 96])
def test_build_sequence_matches_reference(reference_build_sequence, n):
    want, want_end = reference_build_sequence(n)
    idx, filler_end = soak.sequence_indices(n)
    assert idx == want[:, 0, 0].tolist() and filler_end == want_end
    assert len(idx) == n and idx[:15] == list(range(10)) + [8, 7, 6, 5, 4]


def test_build_sequence_frames(kitti_frames):
    frames, filler_end = soak.build_sequence(96)
    idx, _ = soak.sequence_indices(96)
    assert frames.shape == (96, 512, 1392) and filler_end == 85  # 15 + 66 filler + 4 bridge
    assert idx[85:] == list(range(9, -1, -1)) + [0]  # the revisit, then one frame of stationary tail
    for f, i in zip(frames[::7], idx[::7]):
        np.testing.assert_array_equal(f, kitti_frames[i])


# --- the subsystem soak (tests/test_eviction.py::test_soak_loops_survive_heavy_recycling) ---
W, KP, DESC_BYTES, B, CAP = 16, 16, 4, 4, 24


def _frame_desc(words, word_ids):
    return np.stack([words[word_ids[k % len(word_ids)]] for k in range(KP)])


def test_subsystem_soak_matches_reference():
    words = np.random.default_rng(0).integers(0, 256, (W, DESC_BYTES), dtype=np.uint8)
    cfg = dict(min_db_size=2, min_frames_difference=2, min_absolute_score=0.005, relative_score_factor=1.1,
               max_keyframes=CAP, eviction_policy="redundancy", eviction_protect_recent=8)
    jlc = JLoopClosure(JVocabulary(words), JLCConfig(**cfg), JMatcherConfig())
    tlc = TLoopClosure(TVocabulary(words, device="cpu"), TLCConfig(**cfg), TMatcherConfig(), device="cpu")
    frames = ([_frame_desc(words, [2 * i, 2 * i + 1]) for i in range(4)]
              + [_frame_desc(words, [12, 13] if j % 2 else [13, 14]) for j in range(400)]
              + [_frame_desc(words, [2 * i, 2 * i + 1]) for i in range(4)])
    frames = np.stack(frames)
    rng = np.random.default_rng(5)
    jdb, tdb = jlc.new_db(KP, DESC_BYTES), tlc.new_db(KP, DESC_BYTES)
    K = np.eye(3, dtype=np.float32) * 100.0
    ones = np.ones((B, KP), bool)
    for c in range(len(frames) // B):
        fids = np.arange(c * B, (c + 1) * B, dtype=np.int32)
        desc = frames[c * B : (c + 1) * B]
        xy = rng.uniform(0, 99, (B, KP, 2)).astype(np.float32)
        mp = rng.uniform(-1, 1, (B, KP, 3)).astype(np.float32)
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), c), B)
        jdb, jres = jlc.process_chunk(jdb, jnp.asarray(fids), jnp.ones(B, bool), jnp.asarray(desc), jnp.asarray(xy),
                                      jnp.asarray(ones), jnp.asarray(mp), jnp.asarray(ones), jnp.asarray(K), keys)
        t = torch.from_numpy
        tdb, tres = tlc.process_chunk(tdb, t(fids), torch.ones(B, dtype=torch.bool), t(desc), t(xy), t(ones), t(mp),
                                      t(ones), t(K), replay_sampler(keys))
        for name in ("candidate_id", "success", "matched_keyframe_id"):
            np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)),
                                          err_msg=f"chunk {c} {name}")
    ids = tdb.ids.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jdb.ids))
    assert set(ids.tolist()) & {0, 1, 2, 3}, f"place A evicted after the soak: {sorted(ids)}"
    tail = tres.candidate_id.numpy().tolist()
    assert tail == np.asarray(jres.candidate_id).tolist() and any(c in (0, 1, 2, 3) for c in tail)
    assert tdb.bow.shape[0] == CAP


# --- a short system soak in both packages ---
N_SHORT, RING, PROTECT = 35, 8, 2


def _short(cfg):
    cfg = _small(cfg)
    return dataclasses.replace(cfg, loop_closure=dataclasses.replace(
        cfg.loop_closure, max_keyframes=RING, eviction_policy="redundancy", eviction_protect_recent=PROTECT))


def test_short_system_soak_matches_reference(data_dir):
    cfg_dir = data_dir.parent.parent / "configs"
    voc = cfg_dir / "vocabulary_tree.npz"
    frames, filler_end = soak.build_sequence(N_SHORT)
    jsys = JSystem(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _short(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), vocabulary=voc, ba_iterations=0)
    want = jsys.run_sequence(frames, seed=0)
    tsys = TSystem(TCamera.from_yaml(cfg_dir / "camera.yml"),
                   _short(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)), vocabulary=voc, device="cpu",
                   draw_fn=draw_fn(False), lc_draw_fn=lc_draws, reloc_draw_fn=reloc_draws, ba_iterations=0)
    report, got = soak.run_soak(tsys, frames, filler_end)
    assert [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in got["loops"]] == \
        [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in want["loops"]]
    np.testing.assert_array_equal(got["pose_ok"], np.asarray(want["pose_ok"]))
    # the same keyframes survive; the slots they sit in may differ (the module docstring)
    assert sorted(got["db"].ids.tolist()) == sorted(np.asarray(want["db"].ids).tolist())
    assert report["frames"] == N_SHORT and report["db_capacity"] == RING and report["carry_shapes_fixed"]
    assert report["loops_total"] == len(want["loops"]) and report["memory_growth"] is None
    assert report["memory_settled_chunk"] == RING // BATCH
    assert report["prologue_ids_in_db"] == sorted(int(i) for i in np.asarray(want["db"].ids) if 0 <= i < 15)
