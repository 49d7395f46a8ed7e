"""The five CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips (with its reason) where there is no
CUDA device; the decision is taken inside the fixture, not at import.  The
file needs neither JAX nor OpenCV, so on a GPU machine without them it runs
without the suite's conftest:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest -p no:cacheprovider``.
Kernels 1-3 and 5 must match exactly; kernel 4 to rtol 1e-5, because it
sums the matches in another order than the twin.  Kernels 1 and 5 also meet
every one of the 65,536 bright and dark FAST circle patterns.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.frontend.brief import gaussian_kernel, padded_patch_len
from tpuslam_torch.kernels import brief as kb
from tpuslam_torch.kernels import frontend as kf
from tpuslam_torch.kernels import pose as kp
from tpuslam_torch.pre.stream import decode_png_gray8

IMAGES = Path(__file__).resolve().parent / "data" / "images"

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def frames(dev):
    # odd sizes exercise the partial tiles at the right and bottom edges
    imgs = np.stack([decode_png_gray8(p) for p in sorted(IMAGES.glob("*.png"))[:3]])
    return torch.from_numpy(imgs)[:, :301, :703].contiguous().to(dev)


def test_kernel1_frontend_exact(frames):
    taps = torch.from_numpy(gaussian_kernel().astype(np.float32))
    for contiguous in (9, 12):
        args = dict(threshold=20, contiguous=contiguous, taps=taps)
        before = kf.fused_frontend_batch.launches
        got = kf.fused_frontend_batch(frames, **args)
        want = kf.fused_frontend_reference(frames, **args)
        torch.cuda.synchronize()
        assert kf.fused_frontend_batch.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert int(got[1].sum()) > 500


@pytest.mark.parametrize("window", [5, 12, 14])
def test_kernel5_fused_nms_exact(frames, window):
    taps = torch.from_numpy(gaussian_kernel().astype(np.float32))
    for contiguous in (9, 12):
        args = dict(threshold=20, contiguous=contiguous, window=window, taps=taps)
        before = kf.fused_frontend_nms_batch.launches
        got = kf.fused_frontend_nms_batch(frames, **args)
        want = kf.fused_frontend_nms_reference(frames, **args)
        torch.cuda.synchronize()
        assert kf.fused_frontend_nms_batch.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert int((got[1] > 0).sum()) > 100


def test_kernel2_patches_exact(frames, dev):
    rng = np.random.default_rng(0)
    b, h, w = frames.shape
    xy = np.stack([rng.uniform(-5, w + 5, (b, 333)), rng.uniform(-5, h + 5, (b, 333))], -1)
    xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
    got = kb.extract_brief_patches(frames, xy, 31)
    want = kb.extract_brief_patches_reference(frames, xy, 31)
    torch.cuda.synchronize()
    assert got.shape == (b, 333, padded_patch_len(31))
    assert torch.equal(got, want)


def _kernel3_case(case, rng):
    """(patches, bin indices, bins) of one edge case; S2p 2304 and P 256 as on the main path."""
    b, k, bins = 2, 300, 16
    if case == "k1":
        k = 1
    elif case == "k333":  # not a multiple of the 64-keypoint slab
        k = 333
    elif case == "bins64":
        bins = 64
    patches = rng.integers(-128, 128, (b, k, 2304), dtype=np.int8)
    idx = rng.integers(0, bins, (b, k))
    if case == "one_bin":  # every keypoint in one bin: 5 slabs of it, the rest empty
        idx[:] = 7
    elif case == "empty_bins":  # bins 0-3 and 9-15 hold nobody
        idx = rng.integers(4, 9, (b, k))
    elif case == "out_of_range":
        idx = rng.integers(-1, bins + 1, (b, k))
        idx[0, :5] = -1
        idx[1, :5] = bins
    elif case == "bins64":
        idx = rng.integers(-1, bins + 1, (b, k))
    return patches, idx, bins


@pytest.mark.parametrize("case", ["random", "one_bin", "k1", "k333", "empty_bins", "out_of_range", "bins64"])
def test_kernel3_own_bin_dots_exact(dev, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    patches, idx, bins = _kernel3_case(case, rng)
    patches = torch.from_numpy(patches).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    W3 = torch.from_numpy(rng.integers(-1, 2, (bins, 2304, 256), dtype=np.int8)).to(dev)
    W = kb.pack_bin_weights(W3)
    before = kb.brief_own_bin_dots.launches
    got = kb.brief_own_bin_dots(patches, idx, W)
    want = kb.brief_own_bin_dots_reference(patches, idx, W3)
    torch.cuda.synchronize()
    assert kb.brief_own_bin_dots.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    out_of_range = (idx < 0) | (idx >= bins)
    assert not got[out_of_range].any()


def _ring_patterns(dark: bool) -> torch.Tensor:
    """(2048, 2048) u8: cell (cy, cx) of 8 x 8 carries pattern cy * 256 + cx on the
    circle of its pixel (4, 4) — bit i set puts circle pixel i at 200 (or 0
    for ``dark``), the rest of the image is 100: all 65,536 patterns once."""
    from tpuslam_torch.frontend.fast import CIRCLE_OFFSETS

    img = np.full((2048, 2048), 100, np.uint8)
    pattern = np.arange(65536).reshape(256, 256)
    for i, (dx, dy) in enumerate(CIRCLE_OFFSETS):
        on = (pattern >> i) & 1 == 1
        img[4 + dy :: 8, 4 + dx :: 8][on] = 0 if dark else 200
    return torch.from_numpy(img)


def _corner_by_counters(contiguous: int) -> np.ndarray:
    """(65536,) whether a centre whose circle mask is the index is a FAST corner."""
    masks = np.arange(65536)
    bits = [(masks >> i) & 1 == 1 for i in range(16)]
    run = np.zeros(65536, int)
    seg = np.zeros(65536, bool)
    for i in range(min(32, 15 + contiguous)):
        run = np.where(bits[i % 16], run + 1, 0)
        seg |= run >= contiguous
    n4 = sum(bits[i].astype(int) for i in (0, 4, 8, 12))
    return (bits[0] | bits[8]) & (n4 >= 3) & seg


@pytest.mark.parametrize("contiguous", [9, 12, 16])
def test_fast_ring_exhaustive(dev, contiguous):
    """Kernels 1 and 5 against their twins on every bright and every dark circle pattern."""
    taps = torch.from_numpy(gaussian_kernel().astype(np.float32))
    images = torch.stack([_ring_patterns(False), _ring_patterns(True)]).to(dev)
    args = dict(threshold=20, contiguous=contiguous, taps=taps)
    got = kf.fused_frontend_batch(images, **args)
    want = kf.fused_frontend_reference(images, **args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    expected = torch.from_numpy(_corner_by_counters(contiguous)).reshape(256, 256)
    centres = got[1][:, 4::8, 4::8].cpu()
    assert torch.equal(centres[0], expected) and torch.equal(centres[1], expected)
    for window in (5, 12):
        got5 = kf.fused_frontend_nms_batch(images, window=window, **args)
        want5 = kf.fused_frontend_nms_reference(images, window=window, **args)
        torch.cuda.synchronize()
        for g, w in zip(got5, want5):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_kernel4_msac_close(dev):
    rng = np.random.default_rng(4)
    B, H, M = 3, 300, 777
    x1 = torch.from_numpy(rng.uniform(-0.6, 0.6, (B, M, 2)).astype(np.float32)).to(dev)
    x2 = x1 + torch.from_numpy(rng.normal(0, 2e-3, (B, M, 2)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((B, M)) > 0.1).to(dev)
    E = torch.from_numpy((rng.normal(size=(B, H, 9)) * 0.3).astype(np.float32)).to(dev)
    P = kp.build_msac_operand(x1, x2, valid, 1e-6)
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


def test_wrappers_reject_bad_input(dev):
    with pytest.raises(ValueError):
        kb.extract_brief_patches(torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev),
                                 torch.zeros((1, 4, 2), dtype=torch.float64, device=dev), 31)
    with pytest.raises(ValueError):
        kp.msac_scores(torch.zeros((1, 4, 8), device=dev), torch.zeros((1, 9, 10), device=dev))
    W3 = torch.zeros((2, 2304, 256), dtype=torch.int8, device=dev)
    patches = torch.zeros((1, 4, 2304), dtype=torch.int8, device=dev)
    bins = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # weights not in kernel 3's packed layout
        kb.brief_own_bin_dots(patches, bins, W3)
    with pytest.raises(ValueError):  # contiguous out of the kernels' range
        kf.fused_frontend_batch(torch.zeros((1, 8, 8), dtype=torch.uint8, device=dev), threshold=20,
                                contiguous=17, taps=torch.zeros((5, 5)))
