"""The four CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips (with its reason) where there is no
CUDA device; the decision is taken inside the fixture, not at import.  The
file needs neither JAX nor OpenCV, so on a GPU machine without them it runs
without the suite's conftest:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest -p no:cacheprovider``.
Kernels 1-3 must match exactly; kernel 4 to rtol 1e-5, because it sums the
matches in another order than the twin.
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


@pytest.mark.parametrize("bins", [16, 64])
def test_kernel3_own_bin_dots_exact(dev, bins):
    rng = np.random.default_rng(bins)
    patches = torch.from_numpy(rng.integers(-128, 128, (2, 300, 2304), dtype=np.int8)).to(dev)
    W = torch.from_numpy(rng.integers(-1, 2, (bins, 2304, 256), dtype=np.int8)).to(dev)
    idx = torch.from_numpy(rng.integers(-1, bins + 1, (2, 300))).to(dev)
    got = kb.brief_own_bin_dots(patches, idx, W)
    want = kb.brief_own_bin_dots_reference(patches, idx, W)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
