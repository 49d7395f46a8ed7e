"""``Vocabulary.fit`` and its trainers: tpuslam_torch against tpuslam on the CPU.

The corpus is the port's BRIEF descriptors of 4 KITTI fixture frames
(MaxKeypoints 512, one document a frame).  Both packages draw the initial
centroids and the thin-cell pads with numpy's ``default_rng(seed)`` and
reseed empty clusters on the host the same way, so the bars are: centroids
(flat), coarse words and leaves (tree) identical, IDF within 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend import vocabulary as jvoc
from tpuslam_torch.backend import vocabulary as tvoc
from tpuslam_torch.common.hamming import hamming_matrix, pack_bits, unpack_bits
from tpuslam_torch.config.schema import DetectorConfig
from tpuslam_torch.frontend.detector import FeatureDetector


@pytest.fixture(scope="module")
def docs(data_dir, kitti_frames):
    cfg = dataclasses.replace(DetectorConfig.from_yaml(data_dir.parent.parent / "configs" / "feature_detector.yml"),
                              max_keypoints=512)
    kps, desc = FeatureDetector(cfg, device="cpu").detect_and_compute_batch(torch.from_numpy(np.stack(kitti_frames[:4])))
    return [d[v].numpy() for d, v in zip(desc, kps.valid)]


def _same(got, want):
    np.testing.assert_array_equal(got.centroids.numpy(), np.asarray(want.centroids))
    assert (got.coarse is None) == (want.coarse is None)
    if got.coarse is not None:
        np.testing.assert_array_equal(got.coarse.numpy(), np.asarray(want.coarse))
    np.testing.assert_allclose(got.idf.numpy(), np.asarray(want.idf), rtol=0, atol=1e-6)


def test_fit_flat_matches_reference(docs):
    assert sum(len(d) for d in docs) > 1800
    got = tvoc.Vocabulary.fit(docs, num_words=64, iters=5, seed=3, device="cpu")
    _same(got, jvoc.Vocabulary.fit(docs, num_words=64, iters=5, seed=3))
    assert got.device == torch.device("cpu") and len(np.unique(got.centroids.numpy(), axis=0)) == 64


def test_fit_tree_with_thin_cells_matches_reference(docs):
    """(6, 300) over ~2k descriptors: cells under 300 members take all of them plus numpy-drawn pads."""
    corpus = np.concatenate(docs)
    got = tvoc.Vocabulary.fit(docs, iters=4, seed=1, branching=(6, 300), device="cpu")
    _same(got, jvoc.Vocabulary.fit(docs, iters=4, seed=1, branching=(6, 300)))
    a1 = hamming_matrix(torch.from_numpy(corpus), got.coarse).argmin(dim=1).numpy()
    sizes = np.bincount(a1, minlength=6)
    assert (sizes < 300).any() and (sizes >= 300).any()  # both kinds of cell were trained


def test_empty_clusters_reseeded_like_reference(docs):
    """A corpus of three copies: the initial draw repeats descriptors, whose later copies get no member
    (ties go to the lowest index) and are reseeded from the farthest descriptors on the host."""
    corpus = np.concatenate([docs[0][:150]] * 3)
    init = np.random.default_rng(0).choice(len(corpus), 128, replace=False)
    assert len(np.unique(corpus[init], axis=0)) < 128  # so the first step has empty clusters
    got = tvoc.train_vocabulary(corpus, num_words=128, iters=3, seed=0, device="cpu")
    np.testing.assert_array_equal(got, jvoc.train_vocabulary(corpus, num_words=128, iters=3, seed=0))
    with pytest.raises(ValueError, match="at least"):
        tvoc.train_vocabulary(corpus[:10], num_words=16, device="cpu")


def test_pack_bits_matches_and_inverts_unpack():
    """``common/hamming.py::pack_bits`` is the reference's ``_pack_bits``, LSB-first, the inverse of ``unpack_bits``."""
    rng = np.random.default_rng(0)
    bits = rng.random((5, 256)) > 0.5
    packed = pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jvoc._pack_bits(bits)))
    np.testing.assert_array_equal(unpack_bits(packed).numpy(), bits.astype(np.float32))
