"""The vocabulary tools: tpuslam_torch.tools against the reference's ``tools/*.py`` in-process, on the CPU.

* ``train_vocabulary`` (flat, ``--tree 4,4``, ``--augment 2``) on
  ``tests/data/test_images`` with ``--words 16 --iters 2 --max-keypoints
  128``: the ``.npz`` arrays identical, and each package's
  ``Vocabulary.load`` reads the other's file.  Both tools see the same gray
  frames: the reference's tool reads with ``cv2.imread(...,
  IMREAD_GRAYSCALE)``, whose RGB → gray conversion differs from the
  loaders' on about half the pixels of these RGB fixtures (ROADMAP F5), so
  here its ``cv2.imread`` returns the reference's own loader's bytes, which
  are the port's loader's.
* ``pre/augment.py`` against this OpenCV on KITTI frame 0 (1392 wide, a
  multiple of 16) and a 333-wide crop (a 13-column tail): the rotations
  (``getRotationMatrix2D`` + ``warpAffine``) and the rescalings
  (``resize`` there and back) bit for bit.  Which paths run is pinned:
  the warp's vector loop is 16 columns wide (8 or 32 give other bytes on
  a 509-wide frame), and the resize's vertical pass is the vector one
  (the exact rounding of the scalar code gives other bytes).
* ``calibrate`` and ``evaluate`` with ``configs/vocabulary.npz`` (no grid
  point keeps every loop: infeasible) and ``configs/vocabulary_tree.npz``:
  the result dicts equal, rounded fields exactly and unrounded floats to
  1e-5 (the BoW vectors agree to 1e-6); ``--write`` writes the same YAML
  bytes, and both tools print the same tables.  Each package's
  ``_frame_bows`` is memoised for the module, so each fixture directory's
  BoW vectors are made once a package and a vocabulary.

The port runs on one CPU thread (``one_torch_thread``): under the suite's
six workers its eight intra-op threads a worker thrash.
"""

import importlib.util
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.backend.vocabulary import Vocabulary as JVocabulary
from tpuslam.config.schema import LoopClosureConfig as JLoopClosureConfig
from tpuslam.pre.native_loader import NativeFrameLoader as JNativeFrameLoader
from tpuslam_torch.backend.vocabulary import Vocabulary as TVocabulary
from tpuslam_torch.config.schema import LoopClosureConfig as TLoopClosureConfig
from tpuslam_torch.pre import augment
from tpuslam_torch.tools import calibrate_vocabulary as tcal
from tpuslam_torch.tools import eval_vocabulary as teval
from tpuslam_torch.tools import train_vocabulary as ttrain

REPO = Path(__file__).resolve().parent.parent
VOCABS = ["configs/vocabulary.npz", "configs/vocabulary_tree.npz"]
TRAIN = ["--words", "16", "--iters", "2", "--max-keypoints", "128"]


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference():
    return {n: _reference_tool(n) for n in ("train_vocabulary", "calibrate_vocabulary", "eval_vocabulary")}


@pytest.fixture(scope="module", autouse=True)
def memoised_frame_bows(reference):
    """Each package's BoW vectors of a fixture directory under a vocabulary, made once for the module."""
    mp = pytest.MonkeyPatch()
    for mod in (reference["calibrate_vocabulary"], reference["eval_vocabulary"], tcal, teval):
        memo, real = {}, mod._frame_bows

        def cached(vocab, image_dir, det, memo=memo, real=real):
            key = (str(image_dir), vocab.num_words)
            if key not in memo:
                memo[key] = real(vocab, image_dir, det)
            return memo[key]

        mp.setattr(mod, "_frame_bows", cached)
    yield
    mp.undo()


def _loader_imread(path, flags=None):
    """``cv2.imread`` as the reference's loader decodes the file (gray, its colour conversion)."""
    path = Path(path)
    files = sorted(p for p in path.parent.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
    return JNativeFrameLoader(path.parent).decode_indices([files.index(path)])[0]


def test_reference_tool_reads_rgb_frames_otherwise(data_dir):
    """Why the reference's tool is given the loader's bytes: OpenCV's RGB -> gray of the RGB fixtures
    differs from the loaders' on about half their pixels (ROADMAP F5); a gray PNG reads the same."""
    differ = [int((cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) != _loader_imread(p)).sum())
              for p in sorted((data_dir / "test_images").glob("*.png"))]
    assert differ == [152464, 152505]
    kitti = data_dir / "images" / "0000000000.png"
    np.testing.assert_array_equal(cv2.imread(str(kitti), cv2.IMREAD_GRAYSCALE), _loader_imread(kitti))


@pytest.mark.parametrize("extra", [[], ["--tree", "4,4"], ["--augment", "2"]], ids=["flat", "tree", "augment"])
def test_train_vocabulary_matches_reference(data_dir, tmp_path, reference, monkeypatch, capsys, extra):
    images = str(data_dir / "test_images")
    ttrain.main([images, "-o", str(tmp_path / "port.npz"), *TRAIN, *extra, "--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(cv2, "imread", _loader_imread)
    reference["train_vocabulary"].main([images, "-o", str(tmp_path / "ref.npz"), *TRAIN, *extra])
    assert capsys.readouterr().out.replace("ref.npz", "port.npz") == port_out
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(want.files) == sorted(["centroids", "idf"] + (["coarse"] if extra[:1] == ["--tree"] else []))
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["centroids"].shape == (16, 32)
    # each package reads the other's file
    j = JVocabulary.load(tmp_path / "port.npz")
    t = TVocabulary.load(tmp_path / "ref.npz", device="cpu")
    np.testing.assert_array_equal(np.asarray(j.centroids), t.centroids.numpy())
    np.testing.assert_array_equal(np.asarray(j.idf), t.idf.numpy())
    assert (j.coarse is None) == (t.coarse is None)


def test_augment_draws_the_reference_order():
    """The shuffle draws the reference's permutation of its nine operations, the same for every frame."""
    ops = list(range(9))
    np.random.default_rng(0).shuffle(ops)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (40, 64)).astype(np.uint8))
    want = [img] + [ttrain.augment_ops(40, 64)[i](img) for i in ops[:3]]
    got = list(ttrain.variants(img, 3, 0))
    assert len(got) == 4
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.fixture(scope="module")
def augment_frames(kitti_frames):
    return {"kitti": kitti_frames[0], "crop333": np.ascontiguousarray(kitti_frames[4][150:351, 500:833])}


@pytest.mark.parametrize("frame", ["kitti", "crop333"])
@pytest.mark.parametrize("angle", [-20, -10, 10, 20])
def test_rotation_matches_cv2(augment_frames, frame, angle):
    img = augment_frames[frame]
    h, w = img.shape
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    np.testing.assert_array_equal(augment.rotation_matrix((w / 2, h / 2), angle), m)
    got = augment.warp_affine_u8(torch.from_numpy(img), m, (w, h)).numpy()
    np.testing.assert_array_equal(got, cv2.warpAffine(img, m, (w, h)))


@pytest.mark.parametrize("frame", ["kitti", "crop333"])
@pytest.mark.parametrize("scale", [0.7, 1.4])
def test_rescale_matches_cv2(augment_frames, frame, scale):
    img = augment_frames[frame]
    h, w = img.shape
    small = cv2.resize(img, None, fx=scale, fy=scale)
    got_small = augment.resize_u8(torch.from_numpy(img), fx=scale, fy=scale)
    np.testing.assert_array_equal(got_small.numpy(), small)
    np.testing.assert_array_equal(augment.resize_u8(got_small, (w, h)).numpy(), cv2.resize(small, (w, h)))


def test_opencv_paths_pinned(monkeypatch):
    """The warp's vector loop is 16 columns wide; the resize's vertical pass is the vector code's."""
    img = np.random.default_rng(5).integers(0, 256, (301, 509)).astype(np.uint8)
    frames = [np.random.default_rng(5 + k).integers(0, 256, (301, 509)).astype(np.uint8) for k in range(4)]
    for width in (8, 32):
        monkeypatch.setattr(augment, "VECTOR_COLUMNS", width)
        differ = 0
        for f in frames:
            for angle in (-20, -10, 10, 20, 33, 7):
                m = cv2.getRotationMatrix2D((254.5, 150.5), angle, 1.0)
                differ += int((augment.warp_affine_u8(torch.from_numpy(f), m, (509, 301)).numpy()
                               != cv2.warpAffine(f, m, (509, 301))).sum())
        assert differ > 0, width
    # the scalar code's exact rounding of (S0·b0 + S1·b1) / 2^22 is not what runs
    h, w = img.shape
    want = cv2.resize(img, None, fx=1.4, fy=1.4)
    x0, x1, a0, a1 = augment._coefficients(want.shape[1], w, 1 / 1.4, True, "cpu")
    y0, y1, b0, b1 = augment._coefficients(want.shape[0], h, 1 / 1.4, False, "cpu")
    rows = torch.from_numpy(img).long()[:, x0] * a0 + torch.from_numpy(img).long()[:, x1] * a1
    scalar = ((rows[y0] * b0[:, None] + rows[y1] * b1[:, None] + (1 << 21)) >> 22).clamp(0, 255).numpy()
    assert (scalar != want).any()
    np.testing.assert_array_equal(augment.resize_u8(torch.from_numpy(img), fx=1.4, fy=1.4).numpy(), want)


def _same_result(got, want, path=""):
    """Dicts equal: ints, bools, strings and rounded fields exactly; unrounded floats to 1e-5."""
    assert type(got) is type(want) or (isinstance(got, (tuple, list)) and isinstance(want, (tuple, list))), path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same_result(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_result(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-5, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_calibrate_matches_reference(reference, vocab):
    want = reference["calibrate_vocabulary"].calibrate(Path(vocab), JLoopClosureConfig.from_yaml(REPO / "configs" / "loop_closure.yml"))
    got = tcal.calibrate(Path(vocab), TLoopClosureConfig.from_yaml(REPO / "configs" / "loop_closure.yml"), device="cpu")
    assert got["feasible"] == (vocab.endswith("tree.npz"))
    if got["feasible"]:  # rounded fields exactly
        for k in ("min_absolute_score", "relative_score_factor", "recall_envelope", "forward_false_candidate_rate"):
            assert got[k] == want[k], k
    _same_result(got, want)


@pytest.mark.parametrize("vocab", VOCABS)
def test_evaluate_matches_reference(reference, vocab):
    want = reference["eval_vocabulary"].evaluate(Path(vocab), JLoopClosureConfig.from_yaml(REPO / "configs" / "loop_closure.yml"))
    got = teval.evaluate(Path(vocab), TLoopClosureConfig.from_yaml(REPO / "configs" / "loop_closure.yml"), device="cpu")
    _same_result(got, want)
    assert got["forward_queries"] == 8 and got["loops"][1]["rank0_correct"]


def test_write_and_tables_match_reference(reference, tmp_path, capsys):
    """``--write`` gives the reference's YAML bytes; both tools print the same tables."""
    for name in ("port", "ref"):
        shutil.copy(REPO / "configs" / "loop_closure.yml", tmp_path / f"{name}.yml")
    tcal.main([*VOCABS, "--write", str(tmp_path / "port.yml"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    reference["calibrate_vocabulary"].main([*VOCABS, "--write", str(tmp_path / "ref.yml")])
    assert capsys.readouterr().out.replace("ref.yml", "port.yml") == port_out
    assert (tmp_path / "port.yml").read_bytes() == (tmp_path / "ref.yml").read_bytes()
    assert "MinAbsoluteScore: 0.0199" in (tmp_path / "port.yml").read_text()
    teval.main([*VOCABS, "--device", "cpu"])
    port_out = capsys.readouterr().out
    reference["eval_vocabulary"].main(VOCABS)
    assert capsys.readouterr().out == port_out


def test_tools_default_to_the_card(data_dir, tmp_path):
    """Without ``--device`` each tool runs on ``cuda``: on a machine without a card it fails, never falling back."""
    assert not torch.cuda.is_available()
    for call in (lambda: ttrain.main([str(data_dir / "test_images"), "-o", str(tmp_path / "v.npz"), *TRAIN]),
                 lambda: tcal.main(VOCABS[:1]), lambda: teval.main(VOCABS[:1])):
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    assert not (tmp_path / "v.npz").exists()
