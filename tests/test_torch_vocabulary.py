"""The BoW vocabulary: tpuslam_torch's against tpuslam's on the CPU.

Both packages load the shared ``configs/vocabulary.npz`` (256 flat words)
and ``configs/vocabulary_tree.npz`` (64 coarse words × 64 leaves).  On
descriptors of the loop fixture (``tests/data/images_test_loop2``, the
reference's detector at 512 keypoints) and on seeded random ones, with
ties planted: word and leaf assignments identical, BoW vectors within 1e-6,
the empty input the zero vector, and save/load a round trip.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend.vocabulary import Vocabulary as JVocabulary
from tpuslam.config.schema import DetectorConfig
from tpuslam.frontend.detector import FeatureDetector
from tpuslam_torch.backend.vocabulary import Vocabulary as TVocabulary
from tpuslam_torch.utils.convert import vocabulary_from_numpy

FILES = ("vocabulary.npz", "vocabulary_tree.npz")


@pytest.fixture(scope="module")
def cfg_dir(data_dir):
    return data_dir.parent.parent / "configs"


@pytest.fixture(scope="module")
def descriptors(data_dir):
    """(3, 512, 32) fixture descriptors and their valid masks, then (2, 300, 32) seeded ones with ties."""
    det = FeatureDetector(DetectorConfig(max_keypoints=512))
    paths = sorted((data_dir / "images_test_loop2").glob("*.png"))[:3]
    feats = [det.detect_and_compute(jnp.asarray(cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))) for p in paths]
    fixture = (np.stack([np.asarray(d) for _, d in feats]), np.stack([np.asarray(k.valid) for k, _ in feats]))
    rng = np.random.default_rng(0)
    seeded = rng.integers(0, 256, (2, 300, 32), dtype=np.uint8)
    return fixture, (seeded, rng.random((2, 300)) > 0.3)


def _with_ties(vocab: JVocabulary, rng) -> np.ndarray:
    """Descriptors exactly halfway (in bits) between two words, and between two leaves of one word."""
    c = np.asarray(vocab.centroids)
    out = []
    for _ in range(40):
        a, b = rng.choice(len(c), 2, replace=False)
        bits_a, bits_b = np.unpackbits(c[a]), np.unpackbits(c[b])
        diff = np.nonzero(bits_a != bits_b)[0]
        mix = bits_a.copy()
        mix[diff[: len(diff) // 2]] = bits_b[diff[: len(diff) // 2]]
        out.append(np.packbits(mix))
    return np.stack(out)


@pytest.mark.parametrize("name", FILES)
def test_assignments_exact_and_bow_close(name, cfg_dir, descriptors):
    jv = JVocabulary.load(cfg_dir / name)
    tv = TVocabulary.load(cfg_dir / name, device="cpu")
    rng = np.random.default_rng(1)
    ties = _with_ties(jv, rng)
    for desc, valid in descriptors:
        want = np.stack([np.asarray(jv.assign(jnp.asarray(d))) for d in desc])
        np.testing.assert_array_equal(tv.assign(torch.from_numpy(desc)).numpy(), want)
        want_bow = np.stack([np.asarray(jv.transform(jnp.asarray(d), jnp.asarray(v))) for d, v in zip(desc, valid)])
        got_bow = tv.transform(torch.from_numpy(desc), torch.from_numpy(valid)).numpy()
        np.testing.assert_allclose(got_bow, want_bow, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(got_bow, axis=1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(tv.assign(torch.from_numpy(ties)).numpy(), np.asarray(jv.assign(jnp.asarray(ties))))
    score = tv.score(torch.from_numpy(got_bow[0]), torch.from_numpy(got_bow[1]))
    np.testing.assert_allclose(float(score), float(jv.score(jnp.asarray(want_bow[0]), jnp.asarray(want_bow[1]))),
                               atol=1e-6)


def test_tree_ties_take_the_lowest_index(cfg_dir):
    """Two equal coarse words, and two equal leaves of one word: the first wins, as ``jnp.argmin``."""
    data = np.load(cfg_dir / "vocabulary_tree.npz")
    coarse, leaves = data["coarse"].copy(), data["centroids"].copy()
    coarse[7] = coarse[3]
    leaves[3 * 64 + 9] = leaves[3 * 64 + 2]
    jv = JVocabulary(leaves, data["idf"], coarse=coarse)
    tv = vocabulary_from_numpy(leaves, data["idf"], coarse)
    q = np.stack([coarse[3], leaves[3 * 64 + 2]])
    got = tv.assign(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jv.assign(jnp.asarray(q))))
    assert got[1] == 3 * 64 + 2


@pytest.mark.parametrize("name", FILES)
def test_empty_input_is_the_zero_vector(name, cfg_dir):
    tv = TVocabulary.load(cfg_dir / name, device="cpu")
    d = torch.zeros((2, 16, 32), dtype=torch.uint8)
    bow = tv.transform(d, torch.zeros((2, 16), dtype=torch.bool))
    assert bow.shape == (2, tv.num_words) and not bow.any()


@pytest.mark.parametrize("name", FILES)
def test_save_load_round_trip(name, cfg_dir, tmp_path):
    tv = TVocabulary.load(cfg_dir / name, device="cpu")
    tv.save(tmp_path / "v.npz")
    back = TVocabulary.load(tmp_path / "v.npz", device="cpu")
    assert torch.equal(back.centroids, tv.centroids) and torch.equal(back.idf, tv.idf)
    assert (back.coarse is None) == (tv.coarse is None) and (tv.coarse is None or torch.equal(back.coarse, tv.coarse))
    jv = JVocabulary.load(tmp_path / "v.npz")  # the reference reads the port's file
    np.testing.assert_array_equal(np.asarray(jv.centroids), tv.centroids.numpy())
    with pytest.raises(FileNotFoundError):
        TVocabulary.load(tmp_path / "missing.npz")
