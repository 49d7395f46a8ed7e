"""The five CUDA kernels against their plain twins, on the card.

Marked ``cuda``: every test skips (with its reason) where there is no
CUDA device; the decision is taken inside the fixture, not at import.  The
file needs neither JAX nor OpenCV, so on a GPU machine without them it runs
without the suite's conftest:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest -p no:cacheprovider``.
Kernels 1-3 and 5 must match exactly; kernel 4 to rtol 1e-5, because it
sums the matches in another order than the twin.  Kernels 1 and 5 also meet
every one of the 65,536 bright and dark FAST circle patterns, through the
one SWAR FAST they share; kernel 5 also runs at shapes off its tile, on
rows and buffers that start at any byte, and on dense and empty images.

The PnP tracking path holds no kernel, but its map writes and its tracker
run on the card too: the map inserts and ``pnp_track_chunk`` on CUDA
tensors must give what they give on CPU tensors (integers identical,
poses to 1e-4 in rotation and 1e-3 in position), and a write with
duplicate target slots must pick the first valid writer on the card.

The SLAM back end holds no kernel either: on the card the batched map fold
must equal the per-frame scan (integers identical, floats bit for bit) with
the point ring recycling, ``bundle_adjust`` must agree with itself on the
CPU (float64: 1e-8; float32: costs rtol 1e-3, poses 1e-3), and neither the
fold nor a fixed-step BA may sync with the host
(``torch.cuda.set_sync_debug_mode("error")``).

Loop closure adds kernel 4 at relocalization's shape (two frames × 1024
five-point samples × 10 candidates, 1024 matches), whose masked candidates
may hold NaN: the unmasked rows must match the twin at rtol 1e-5.  On the
card, against the CPU given the same draws: the five-point pose (R 1e-4,
t 1e-3, inliers ±2), a loop-closure chunk over a ring overflow (integers
identical, BoW 1e-6), relocalization (ok and ids identical, poses 1e-4 /
1e-3) and the pose graph's PCG on a 300-node drift graph.  The chunk syncs
with the host exactly once (its one read), relocalization only where
``torch.linalg.svd`` does (``set_sync_debug_mode("warn")``, counted after a
first call has built the Jacobi schedules on the card).

The streaming driver: ``device_prefetch`` stages distinct chunks bit-equal
(with its source overwritten after each yield, at depths 1-3),
``load_state(device="cuda")`` puts every array leaf on the card (a host
counter stays an ``int``), and ``SlamSystem.run`` split through a
checkpoint equals the uninterrupted run bit for bit on the card, in VO and
PnP mode, at small shapes.

The last modules: exact BRIEF (``BriefQuantizedBins: 0``) through the
detector on full-width frames launches kernel 1 and neither kernel 2 nor 3,
and gives on the card what it gives on the CPU (keypoints and descriptors
identical, angles 1e-4 deg); the single-image ``detect``, ``compute`` and
``detect_and_compute`` run the batch path at B = 1 on the card, equal to
the CPU and to row 0 of the batch; ``PoseEstimator`` given draws equals the
CPU (integer fields identical, R 1e-4, t 1e-3); ``Vocabulary.fit`` trains
the CPU's centroids (IDF 1e-6); ``time_fn`` and ``device_trace`` see the
card's kernels.

The batch axes: kernels 1-4 at the batched VO path's batch of 64
full-width frames (four 16-frame sequences or time shards as one chunk)
against their twins; ``SlamPipeline.process_chunks`` over three sequences
on the card against each sequence's ``process_chunk`` (integers identical,
poses 1e-4 / 1e-3); batched ``ransac_pnp`` over five problems against five
unbatched calls on the card (success and inliers identical, R 1e-4, t
1e-3); an unbatched ``motion_pnp`` and ``ransac_pnp`` on the card equal
their 2-D formulation, the products they computed before the problem axis,
bit for bit.
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


@pytest.mark.parametrize("window", [1, 5, 12, 14])
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


def _kernel5_exact(images, window, contiguous=9, threshold=20):
    taps = torch.from_numpy(gaussian_kernel().astype(np.float32))
    args = dict(threshold=threshold, contiguous=contiguous, window=window, taps=taps)
    got = kf.fused_frontend_nms_batch(images, **args)
    want = kf.fused_frontend_nms_reference(images, **args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    return got


# kernel 5's tile is 64 x 96: below one tile; one pixel over a tile and over two; widths that are
# not multiples of 4 (rows start at any byte), of 16 but not 4, of 8 but not 16; one tile exactly
@pytest.mark.parametrize("shape", [(1, 20, 37), (2, 7, 8), (2, 65, 97), (1, 129, 193), (2, 77, 203),
                                   (1, 70, 206), (1, 128, 200), (1, 64, 96), (3, 100, 300)])
@pytest.mark.parametrize("window", [1, 2, 5, 12, 14])
def test_kernel5_ragged_shapes_exact(frames, shape, window):
    b, h, w = shape
    images = frames[:b, 100 : 100 + h, 200 : 200 + w].contiguous()
    _, key = _kernel5_exact(images, window)
    if h * w > 5000:
        assert int((key > 0).sum()) > 0


@pytest.mark.parametrize("offset", [1, 2, 7, 8])
def test_kernel5_unaligned_base(frames, dev, offset):
    """An image buffer that starts at an odd address: the aligned loads stay inside it."""
    b, h, w = 2, 97, 211
    flat = torch.empty(b * h * w + offset, dtype=torch.uint8, device=dev)
    images = flat[offset:].reshape(b, h, w).copy_(frames[:b, 50 : 50 + h, 300 : 300 + w])
    assert images.data_ptr() % 16 == offset and images.is_contiguous()
    for window in (5, 12):
        _kernel5_exact(images, window)


def _kernel5_synthetic(kind: str) -> np.ndarray:
    h, w = 150, 333
    if kind == "zeros":
        return np.zeros((2, h, w), np.uint8)
    if kind == "white":
        return np.full((2, h, w), 255, np.uint8)
    if kind == "noise":  # at threshold 0 and a run of 1 most pixels are corners: dense keys
        return np.random.default_rng(3).integers(0, 256, (2, h, w), dtype=np.uint8)
    # a lattice of lone bright pixels: every one a corner with the same score,
    # so only the inverted raster index in the key decides who survives
    img = np.zeros((2, h, w), np.uint8)
    img[:, ::4, ::4] = 255
    return img


@pytest.mark.parametrize("kind", ["zeros", "white", "noise", "lattice"])
@pytest.mark.parametrize("window", [1, 5, 12, 14])
def test_kernel5_dense_and_empty_exact(dev, kind, window):
    images = torch.from_numpy(_kernel5_synthetic(kind)).to(dev)
    dense = kind == "noise"
    _, key = _kernel5_exact(images, window, contiguous=1 if dense else 12, threshold=0 if dense else 20)
    survivors = int((key > 0).sum())
    if kind in ("zeros", "white"):
        assert survivors == 0
    elif dense:
        assert survivors > (images.numel() // 3 if window == 1 else 10)
    else:  # equal scores everywhere: the first corner in raster order beats all it can see
        assert int(key[0].max()) >> 20 == 16 * 255 and int(key[0, 4, 4]) > 0
        assert survivors > 5000 if window == 1 else survivors == 2


@pytest.mark.parametrize("k", [1, 333, 1024])
@pytest.mark.parametrize("patch_size", [31, 25, 15])  # sides 48, 40 and 24: 16- and 8-byte units
def test_kernel2_patches_exact(frames, dev, patch_size, k):
    """Keypoints up to 5 px outside every border, and on each corner and edge."""
    rng = np.random.default_rng(1000 * patch_size + k)
    b, h, w = frames.shape
    xy = np.stack([rng.uniform(-5, w + 5, (b, k)), rng.uniform(-5, h + 5, (b, k))], -1)
    corners = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w / 2, 0), (0, h / 2),
               (w - 0.5, h / 2), (w / 2, h - 0.5), (-0.9, -0.9), (1.5, 2.5)]
    n = min(k, len(corners))
    xy[:, :n] = np.asarray(corners[:n])
    xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
    before = kb.extract_brief_patches.launches
    got = kb.extract_brief_patches(frames, xy, patch_size)
    want = kb.extract_brief_patches_reference(frames, xy, patch_size)
    torch.cuda.synchronize()
    assert kb.extract_brief_patches.launches == before + 1
    assert got.shape == (b, k, padded_patch_len(patch_size)) and got.dtype == torch.int8
    assert torch.equal(got, want)


def test_kernel2_unaligned_image_view(frames, dev):
    """A frame buffer that starts at an odd address: the aligned loads stay inside it."""
    b, h, w = 2, 97, 211
    flat = torch.from_numpy(np.random.default_rng(5).integers(0, 256, b * h * w + 3, dtype=np.uint8)).to(dev)
    images = flat[3:].reshape(b, h, w)
    rng = np.random.default_rng(6)
    xy = np.stack([rng.uniform(-5, w + 5, (b, 200)), rng.uniform(-5, h + 5, (b, 200))], -1)
    xy[0, 0], xy[1, 1] = (0, 0), (w - 1, h - 1)  # the buffer's first and last bytes
    xy = torch.from_numpy(xy.astype(np.float32)).to(dev)
    for patch_size in (31, 25):
        got = kb.extract_brief_patches(images, xy, patch_size)
        want = kb.extract_brief_patches_reference(images, xy, patch_size)
        torch.cuda.synchronize()
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


def _kernel4_case(dev, B, H, M, seed=4):
    rng = np.random.default_rng(seed)
    x1 = torch.from_numpy(rng.uniform(-0.6, 0.6, (B, M, 2)).astype(np.float32)).to(dev)
    x2 = x1 + torch.from_numpy(rng.normal(0, 2e-3, (B, M, 2)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.random((B, M)) > 0.1).to(dev)
    E = torch.from_numpy((rng.normal(size=(B, H, 9)) * 0.3).astype(np.float32)).to(dev)
    return E, kp.build_msac_operand(x1, x2, valid, 1e-6)


# ragged in H and M; the smallest; the main path's H and M; M below one 16-byte unit; configs/fast's chunk
@pytest.mark.parametrize("shape", [(3, 300, 777), (1, 1, 1), (2, 1024, 1024), (2, 130, 5), (16, 512, 1024)])
def test_kernel4_msac_close(dev, shape):
    E, P = _kernel4_case(dev, *shape)
    before = kp.msac_scores.launches
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    torch.cuda.synchronize()
    assert kp.msac_scores.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


def test_kernel4_same_bits_twice_and_invalid_pair_scores_zero(dev):
    E, P = _kernel4_case(dev, 3, 300, 777)
    P[1] = 0.0  # a pair with no valid match
    first = kp.msac_scores(E, P)
    second = kp.msac_scores(E, P)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not first[1].any() and bool((first[0] > 0).all())
    # an operand that does not start on a 16-byte boundary takes the 4-byte copies
    E4, P4 = _kernel4_case(dev, 2, 130, 1024)
    shifted = torch.empty(P4.numel() + 1, device=dev)[1:].reshape(P4.shape).copy_(P4)
    assert shifted.data_ptr() % 16 and torch.equal(kp.msac_scores(E4, shifted), kp.msac_scores(E4, P4))


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


def _map_ops(dev, rng):
    """A scripted run of map writes: ring wrap, recycled slots, duplicate observations, a disabled insert."""
    from tpuslam_torch.backend import map as tmap

    m = tmap.empty_map(3, 700, device=dev)
    for i in range(6):
        pts = torch.from_numpy(rng.normal(size=(600, 3)).astype(np.float32)).to(dev)
        ok = torch.from_numpy(rng.random(600) > 0.4).to(dev)
        m, slots = tmap.insert_points(m, pts, ok)
        m, kf = tmap.insert_keyframe(m, i, torch.eye(3, device=dev) * (i + 1), torch.ones(3, device=dev),
                                     torch.tensor(i != 3, device=dev))
        dup = torch.cat([slots, slots[:200]])
        uv = torch.from_numpy(rng.normal(size=(800, 2)).astype(np.float32)).to(dev)
        m = tmap.add_observations(m, kf, dup, uv, torch.ones(800, dtype=torch.bool, device=dev))
    return m


def test_map_writes_card_equals_cpu(dev):
    got = _map_ops(dev, np.random.default_rng(0))
    want = _map_ops(torch.device("cpu"), np.random.default_rng(0))
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w), name
    assert int(got.point_count) > 700  # the ring wrapped


def test_row_select_first_writer_on_card(dev):
    """200,000 writers onto 50 rows: each row takes its first valid writer, not any writer."""
    from tpuslam_torch.backend.map import apply_row_select, row_select

    rng = np.random.default_rng(1)
    slots = torch.from_numpy(rng.integers(-1, 52, 200_000)).to(dev)
    valid = torch.from_numpy(rng.random(200_000) > 0.5).to(dev)
    vals = torch.arange(200_000, dtype=torch.int32, device=dev) + 2**30
    first, written = row_select(slots, valid, 50)
    got = apply_row_select(first, written, vals).cpu().numpy()
    s, v = slots.cpu().numpy(), valid.cpu().numpy()
    for r in range(50):
        writers = np.flatnonzero(v & (s == r))
        assert got[r] == writers[0] + 2**30


@pytest.mark.parametrize("freeze_map", [False, True])
def test_pnp_track_chunk_card_equals_cpu(dev, freeze_map):
    """Two frames against a 256-point map: a teleported seed (the RANSAC fallback, or with a frozen
    map the projection refresh), then a healthy one."""
    from tpuslam_torch.backend import map as tmap
    from tpuslam_torch.backend.pnp import gumbel_sample_indices
    from tpuslam_torch.model.tracking import pnp_track_chunk

    rng = np.random.default_rng(3)
    N, k_cap = 256, 512
    K = np.asarray([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    X = rng.uniform([-6, -4, 8], [6, 4, 20], (N, 3)).astype(np.float32)

    def project(Xc):
        pix = Xc @ K.T
        return (pix[:, :2] / pix[:, 2:3]).astype(np.float32)

    def yaw(deg):
        a = np.deg2rad(deg)
        return np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)

    centres = [np.asarray([0.6, 0.1, 1.2], np.float32), np.asarray([0.7, 0.1, 1.9], np.float32)]
    xy = np.zeros((2, k_cap, 2), np.float32)
    for f, (deg, C) in enumerate(zip((25.0, 27.0), centres)):
        xy[f, :N] = project((X - C) @ yaw(deg))
    T_prev = np.eye(4, dtype=np.float32)
    T_prev[:3, :3] = yaw(-60.0)
    T_prev[:3, 3] = [3.0, -2.0, 1.5]
    idx = np.tile(np.arange(N, dtype=np.int32), (2, 1))
    draws = [gumbel_sample_indices(torch.ones(N, dtype=torch.bool), 64, 6, torch.Generator().manual_seed(f))
             for f in range(2)]

    def run(d):
        m = tmap.empty_map(8, 1024, device=d)
        m, slots = tmap.insert_points(m, torch.from_numpy(X).to(d), torch.ones(N, dtype=torch.bool, device=d))
        m, kf0 = tmap.insert_keyframe(m, 0, torch.eye(3, device=d), torch.zeros(3, device=d))
        uv0 = torch.from_numpy(project(X)).to(d)
        m = tmap.add_observations(m, kf0, slots, uv0, torch.ones(N, dtype=torch.bool, device=d))
        assoc = tmap.empty_assoc(k_cap, device=d)
        assoc = assoc._replace(
            kp_to_point=torch.cat([slots, assoc.kp_to_point[N:]]),
            kp_birth=torch.cat([m.point_birth[slots.long()], assoc.kp_birth[N:]]),
            prev_kf_slot=kf0,
            prev_xy=torch.cat([uv0, assoc.prev_xy[N:]]),
        )
        t = lambda a: torch.from_numpy(np.asarray(a)).to(d)  # noqa: E731
        return pnp_track_chunk(
            m, assoc, t(K), t(T_prev), [1, 2], t([True, True]), lambda b, valid: draws[b].to(d),
            t(np.eye(3, dtype=np.float32)[None].repeat(2, 0)), t(np.zeros((2, 3), np.float32)),
            t([False, False]), t(xy), t(idx), t(idx), t(np.ones((2, N), bool)),
            t(np.zeros((2, N, 3), np.float32)), t(np.zeros((2, N), np.float32)), t(np.zeros((2, N), bool)),
            freeze_map=freeze_map,
        )

    (g_res, g_map, g_assoc, _), (c_res, c_map, c_assoc, _) = run(dev), run(torch.device("cpu"))
    if not freeze_map:
        assert bool(c_res.used_ransac[0]) and bool(c_res.pnp_ok.all())
    for name in ("pnp_ok", "num_pnp_inliers", "num_assoc", "used_ransac", "point_count0", "kp_to_point",
                 "kp_birth"):
        assert torch.equal(getattr(g_res, name).cpu(), getattr(c_res, name)), name
    for name in ("kf_id", "kf_valid", "point_valid", "point_birth", "obs_mask", "kf_count", "point_count"):
        assert torch.equal(getattr(g_map, name).cpu(), getattr(c_map, name)), name
    assert torch.equal(g_assoc.kp_to_point.cpu(), c_assoc.kp_to_point)
    assert float((g_res.poses[:, :3, :3].cpu() - c_res.poses[:, :3, :3]).abs().max()) <= 1e-4
    assert float((g_res.poses[:, :3, 3].cpu() - c_res.poses[:, :3, 3]).abs().max()) <= 1e-3


# --- the SLAM back end: map folds and bundle adjustment ---------------------------


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _fold_chunks(rng, n_chunks=5, B=6, n_land=40, Kp=48):
    """Synthetic fold inputs with match chains and wrong matches (numpy, no JAX)."""
    Kc = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = rng.uniform([-6, -4, 8], [6, 4, 24], size=(n_land, 3))
    perms = np.stack([rng.permutation(Kp)[:n_land] for _ in range(n_chunks * B)])
    chunks = []
    for c in range(n_chunks):
        ch = dict(frame_ids=np.arange(c * B, (c + 1) * B, dtype=np.int32), kf_mask=np.ones(B, bool),
                  pose_ok=np.ones(B, bool), poses=np.zeros((B, 4, 4), np.float32),
                  kps_xy=np.zeros((B, Kp, 2), np.float32), m_query=np.full((B, n_land), -1, np.int32),
                  m_train=np.full((B, n_land), -1, np.int32), m_valid=np.zeros((B, n_land), bool),
                  points3d_cur=np.zeros((B, n_land, 3), np.float32), point_ok=np.zeros((B, n_land), bool))
        for i in range(B):
            f = c * B + i
            Rw = _rodrigues(rng.normal(size=3) * 0.01)
            C = np.array([0.2 * f, 0.05 * np.sin(f), 0.1 * f])
            ch["poses"][i] = np.eye(4)
            ch["poses"][i][:3, :3] = Rw
            ch["poses"][i][:3, 3] = C
            cam = (X - C) @ Rw
            pix = cam @ Kc.T
            ch["kps_xy"][i][perms[f]] = pix[:, :2] / pix[:, 2:] + rng.normal(size=(n_land, 2)) * 0.3
            if f == 0:
                continue
            q = perms[f - 1].copy()
            bad = rng.random(n_land) < 0.15
            q[bad] = perms[f - 1][rng.integers(0, n_land, int(bad.sum()))]
            ch["m_query"][i], ch["m_train"][i] = q, perms[f]
            ch["m_valid"][i] = rng.random(n_land) < 0.9
            ch["points3d_cur"][i] = cam + rng.normal(size=cam.shape) * 0.01
            ch["point_ok"][i] = rng.random(n_land) < 0.75
        chunks.append(ch)
    return chunks, Kc.astype(np.float32)


def _states_equal(a, b) -> None:
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


def test_map_folds_batched_equals_scan_on_card(dev):
    """Five chunks into a 160-point ring (it wraps), window 3: the two folds agree bit for bit
    on the card, and the card agrees with the CPU."""
    from tpuslam_torch.backend import map as tmap

    chunks, Kc = _fold_chunks(np.random.default_rng(7))

    def run(d, fold):
        m, a = tmap.empty_map(3, 160, device=d), tmap.empty_assoc(48, device=d)
        K = torch.from_numpy(Kc).to(d)
        states = []
        for ch in chunks:
            m, a = fold(m, a, K, **{k: torch.from_numpy(v).to(d) for k, v in ch.items()})
            states.append((m, a))
        return states

    scan = run(dev, tmap.update_map_chunk)
    batched = run(dev, tmap.update_map_chunk_batched)
    cpu = run(torch.device("cpu"), tmap.update_map_chunk_batched)
    for (ms, as_), (mb, ab), (mc, ac) in zip(scan, batched, cpu):
        _states_equal(mb, ms)
        _states_equal(ab, as_)
        _states_equal(tmap.MapState(*(x.cpu() for x in mb)), mc)
    assert int(batched[-1][0].point_count) > 160


def _ba_window(d, dtype=torch.float32):
    """Four keyframes observing 200 points with 0.5 px noise, perturbed, on device ``d``."""
    from tpuslam_torch.backend import map as tmap

    rng = np.random.default_rng(9)
    Kc = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = rng.uniform([-4, -3, 6], [4, 3, 18], size=(200, 3))
    m = tmap.empty_map(8, 512, device=d)
    slots = []
    for i in range(4):
        R = _rodrigues(rng.normal(size=3) * 0.05)
        t = np.array([0.8 * i, 0.0, 0.0]) + rng.normal(size=3) * 0.05
        uv = (X @ R.T + t) @ Kc.T
        uv = uv[:, :2] / uv[:, 2:] + rng.normal(size=(200, 2)) * 0.5
        if i:
            R = _rodrigues(rng.normal(size=3) * 0.02) @ R
            t = t + rng.normal(size=3) * 0.1
        m, s = tmap.insert_keyframe(m, i, torch.tensor(R, dtype=torch.float32, device=d),
                                    torch.tensor(t, dtype=torch.float32, device=d))
        slots.append((s, uv))
    X0 = torch.tensor(X + rng.normal(size=X.shape) * 0.05, dtype=torch.float32, device=d)
    m, pslots = tmap.insert_points(m, X0, torch.ones(200, dtype=torch.bool, device=d))
    for s, uv in slots:
        m = tmap.add_observations(m, s, pslots, torch.tensor(uv, dtype=torch.float32, device=d),
                                  torch.ones(200, dtype=torch.bool, device=d))
    m = m._replace(**{k: getattr(m, k).to(dtype) for k in ("kf_R", "kf_t", "points", "obs_uv")})
    return m, torch.tensor(Kc, dtype=torch.float32, device=d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_bundle_adjust_card_equals_cpu(dev, dtype):
    from tpuslam_torch.backend.ba import bundle_adjust

    assert not torch.backends.cuda.matmul.allow_tf32
    got = bundle_adjust(*_ba_window(dev, dtype), iterations=6, active_points=256)
    want = bundle_adjust(*_ba_window(torch.device("cpu"), dtype), iterations=6, active_points=256)
    f64 = dtype == torch.float64
    torch.testing.assert_close(got.initial_cost.cpu(), want.initial_cost, rtol=1e-9 if f64 else 1e-5, atol=0)
    torch.testing.assert_close(got.final_cost.cpu(), want.final_cost, rtol=1e-9 if f64 else 1e-3, atol=0)
    tol = 1e-8 if f64 else 1e-3
    torch.testing.assert_close(got.map.kf_R.cpu(), want.map.kf_R, rtol=0, atol=tol)
    torch.testing.assert_close(got.map.kf_t.cpu(), want.map.kf_t, rtol=0, atol=tol)
    assert float(got.final_cost) < 0.5 * float(got.initial_cost)


def test_fold_and_fixed_step_ba_do_not_sync(dev):
    """The batched fold, the scan fold and a fixed-step BA run with host syncs made errors."""
    from tpuslam_torch.backend import map as tmap
    from tpuslam_torch.backend.ba import bundle_adjust

    chunks, Kc = _fold_chunks(np.random.default_rng(3), n_chunks=2)
    args = [{k: torch.from_numpy(v).to(dev) for k, v in ch.items()} for ch in chunks]
    K = torch.from_numpy(Kc).to(dev)
    window = _ba_window(dev)
    torch.cuda.synchronize()
    for fold in (tmap.update_map_chunk_batched, tmap.update_map_chunk):
        m, a = tmap.empty_map(4, 512, device=dev), tmap.empty_assoc(48, device=dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for ch in args:
                m, a = fold(m, a, K, **ch)
            ba = bundle_adjust(*window, iterations=4, active_points=128)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert int(m.kf_count) == 12 and float(ba.final_cost) < float(ba.initial_cost)


# --- loop closure: kernel 4 at relocalization's shape, the stages card vs CPU -------------


def _count_syncs(fn):
    """(result, host syncs ``fn`` made, {"file:line": count}) from sync debug mode "warn", each put
    at the innermost line of this repository on the Python stack when it was raised."""
    import collections
    import traceback
    import warnings

    repo = str(Path(__file__).resolve().parent.parent)
    where = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):  # not the mode switch's own notice
            ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(repo)]
            site = ours[-1] if ours else traceback.FrameSummary(filename, lineno, "")
            where[f"{Path(site.filename).name}:{site.lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum(where.values()), dict(where)


def _fivepoint_case(d, n_pairs=2, H=1024, M=1024, seed=0):
    """Matches of a rigid scene with 40% outliers, and H five-point samples a pair."""
    from tpuslam_torch.common.geometry import so3_exp

    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 600], [0, 700.0, 250], [0, 0, 1]], np.float32)
    x1s, x2s = [], []
    for _ in range(n_pairs):
        R = so3_exp(torch.from_numpy(rng.normal(size=3).astype(np.float32) * 0.05)).numpy()
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = rng.uniform([-8, -3, 5], [8, 3, 40], (M, 3))
        p1, p2 = X @ K.T, (X @ R.T + t) @ K.T
        uv1 = p1[:, :2] / p1[:, 2:]
        uv2 = p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.5, (M, 2))
        out = rng.random(M) < 0.4
        uv2[out] = rng.uniform([0, 0], [1200, 500], (int(out.sum()), 2))
        x1s.append(uv1)
        x2s.append(uv2)
    valid = rng.random((n_pairs, M)) > 0.1
    ranks = rng.integers(0, valid.sum(1).min(), (n_pairs, H, 5))
    to = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(d, dt)  # noqa: E731
    return to(np.stack(x1s)), to(np.stack(x2s)), to(valid, torch.bool), to(K), to(ranks, torch.int64)


def test_kernel4_reloc_shape_with_masked_nan_candidates(dev):
    """Kernel 4 at (2, 10240, 1024) on real five-point candidates; masked rows carry NaN."""
    from tpuslam_torch.common.geometry import normalize_points
    from tpuslam_torch.frontend.fivepoint import fivepoint_essential

    pts1, pts2, valid, K, ranks = _fivepoint_case(dev)
    x1, x2 = normalize_points(K, pts1), normalize_points(K, pts2)
    idx = ranks.reshape(2, -1)[..., None].expand(-1, -1, 2)
    E, ok = fivepoint_essential(torch.gather(x1, 1, idx).reshape(2, 1024, 5, 2),
                                torch.gather(x2, 1, idx).reshape(2, 1024, 5, 2))
    E = E.reshape(2, 10240, 9).contiguous()
    ok = ok.reshape(2, 10240)
    E[:, 0] = torch.nan  # at least one NaN row a pair, masked
    ok[:, 0] = False
    assert ok.float().mean() > 0.1 and (~torch.isfinite(E[~ok]).all(-1)).any()
    P = kp.build_msac_operand(x1, x2, valid, (2.0 / 700.0) ** 2)
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-5, atol=0.0)
    assert torch.isfinite(got[ok]).all()


def test_fivepoint_pose_card_equals_cpu(dev):
    from tpuslam_torch.frontend.pose import estimate_relative_pose

    args = _fivepoint_case(dev, H=256, M=512)
    kw = dict(num_hypotheses=256, sample_size=5, inlier_threshold_px=2.0)
    got = estimate_relative_pose(*args[:4], draws=args[4], **kw)
    want = estimate_relative_pose(*(a.cpu() for a in args[:4]), draws=args[4].cpu(), **kw)
    assert torch.equal(got.success.cpu(), want.success) and bool(want.success.all())
    torch.testing.assert_close(got.R.cpu(), want.R, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.t.cpu(), want.t, rtol=0, atol=1e-3)
    assert (got.num_inliers.cpu() - want.num_inliers).abs().max() <= 2


def _lc_features(rng, B=8, K=128, shift=0.0):
    xy = rng.uniform([0, 0], [640, 480], (B, K, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (B, K, 32), dtype=np.uint8)
    kv = rng.random((B, K)) > 0.05
    rays = np.concatenate([(xy - [320, 240]) / 500.0, np.ones((B, K, 1))], -1)
    mp = (rays * rng.uniform(5, 15, (B, K, 1))).astype(np.float32)
    return desc, xy + shift, kv, mp


def _recorded(d, store):
    """A PnpSampler drawing on ``d`` and keeping its samples, and one replaying them on the CPU."""
    from tpuslam_torch.backend.pnp import gumbel_sample_indices

    def draw(positions, valid, H):
        gen = torch.Generator(device=valid.device)
        out = []
        for i, p in enumerate(positions):
            gen.manual_seed(1000 + p)
            out.append(gumbel_sample_indices(valid[i], H, 6, gen))
        store[tuple(positions)] = torch.stack(out)
        return store[tuple(positions)]

    return draw, (lambda positions, valid, H: store[tuple(positions)].cpu())


def test_loop_closure_chunk_card_equals_cpu_with_one_sync(dev):
    """Three chunks into a 16-row ring (redundancy eviction on the third), the later chunks revisits
    of the first: card == CPU given the same samples, one host sync a chunk."""
    from tpuslam_torch.backend.loop_closure import KeyframeDB, LoopClosure
    from tpuslam_torch.config.schema import LoopClosureConfig, MatcherConfig

    cfg = LoopClosureConfig(min_absolute_score=0.01, relative_score_factor=1.0, verify_budget=4,
                            max_keyframes=16, eviction_protect_recent=2)
    voc = Path(__file__).resolve().parent.parent / "configs" / "vocabulary_tree.npz"
    lcs = {d: LoopClosure(voc, cfg, MatcherConfig(ratio_test_threshold=0.8), device=d) for d in (dev, "cpu")}
    rng = np.random.default_rng(0)
    base = _lc_features(rng)
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    dbs = {d: lc.new_db(128) for d, lc in lcs.items()}
    store = {}
    record, replay = _recorded(dev, store)
    n_success = 0
    for c in range(3):
        feats = base
        if c > 0:  # a revisit: the same place seen again, a tenth of its descriptors new (no row's BoW is
            # another's exactly: duplicate rows tie in the eviction score up to rounding, which the card
            # and the CPU break differently)
            desc = base[0].copy()
            redo = rng.random(desc.shape[:2]) < 0.1
            desc[redo] = rng.integers(0, 256, (int(redo.sum()), 32), dtype=np.uint8)
            feats = (desc, base[1] + 1.0, base[2], base[3])
        res = {}
        for d, sampler in ((dev, record), ("cpu", replay)):
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in feats]
            fids, Kd = torch.arange(8, dtype=torch.int32, device=d) + 8 * c, K.to(d)
            call = lambda: lcs[d].process_chunk(dbs[d], fids, torch.ones(8, dtype=torch.bool, device=d),  # noqa: E731
                                                *args[:3], args[3], args[2], Kd, sampler)
            if d == dev and c == 2:  # counted once the earlier chunks built the Jacobi schedules, once
                (dbs[d], res[d]), syncs, where = _count_syncs(call)
                assert syncs == 1, f"chunk {c}: {syncs} host syncs at {where}"
            else:
                dbs[d], res[d] = call()
        for name in ("success", "candidate_id", "matched_keyframe_id", "num_inliers"):
            assert torch.equal(getattr(res[dev], name).cpu(), getattr(res["cpu"], name)), name
        torch.testing.assert_close(res[dev].relative_transform.cpu(), res["cpu"].relative_transform,
                                   rtol=0, atol=1e-3)
        for name in KeyframeDB._fields:
            g, w = getattr(dbs[dev], name).cpu(), getattr(dbs["cpu"], name)
            if name == "bow":
                torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
            else:
                assert torch.equal(g, w), name
        n_success += int(res["cpu"].success.sum())
    assert n_success >= 4


def test_relocalize_card_equals_cpu(dev):
    """Relocalization of a near revisit and two noise frames: card == CPU given the same draws; it
    syncs with the host only where ``torch.linalg.svd`` does (twice: projection and decomposition)."""
    from tpuslam_torch.backend.loop_closure import RELOC_HYPOTHESES, LoopClosure, generator_sampler
    from tpuslam_torch.backend.pnp import gumbel_top_indices
    from tpuslam_torch.config.schema import LoopClosureConfig, MatcherConfig

    cfg = LoopClosureConfig(min_absolute_score=0.01)
    voc = Path(__file__).resolve().parent.parent / "configs" / "vocabulary_tree.npz"
    rng = np.random.default_rng(1)
    desc, xy, kv, mp = _lc_features(rng)
    poses = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    poses[:, :3, 3] = np.arange(8)[:, None] * np.array([1.0, 0.25, 2.0])
    qdesc = desc.copy()
    qdesc[5] = rng.integers(0, 256, qdesc[5].shape, dtype=np.uint8)
    qdesc[6] = rng.integers(0, 256, qdesc[6].shape, dtype=np.uint8)
    need = np.zeros(8, bool)
    need[[2, 5, 6]] = True
    u_pnp = torch.from_numpy(rng.random((8, 512, 128)).astype(np.float32))
    u_rank = torch.from_numpy(rng.random((8, RELOC_HYPOTHESES, 5)).astype(np.float32))

    noise = {}  # the uniforms on each device, copied before the counted call

    def draws(sel, pnp_valid, n_valid, H):
        n = torch.clamp_min(n_valid, 1).float()[:, None, None]
        up, ur = noise[sel.device.type]
        return gumbel_top_indices(up[sel], pnp_valid, 6), torch.minimum(torch.floor(ur[sel] * n), n - 1).long()

    out = {}
    K = torch.tensor([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    for d in (dev, "cpu"):
        lc = LoopClosure(voc, cfg, MatcherConfig(ratio_test_threshold=0.8), device=d)
        noise[torch.device(d).type] = (u_pnp.to(d), u_rank.to(d))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)  # noqa: E731
        db, _ = lc.process_chunk(lc.new_db(128), torch.arange(8, dtype=torch.int32, device=d),
                                 torch.ones(8, dtype=torch.bool, device=d), to(desc), to(xy), to(kv), to(mp), to(kv),
                                 K.to(d), generator_sampler(), poses=to(poses))
        q = [to(need), to(qdesc), to(xy + 2.0), to(kv), K.to(d)]
        call = lambda: lc.relocalize_chunk(db, *q, draws)  # noqa: E731
        if d == dev:
            call()  # the first call builds the Jacobi schedules of the 4-, 9- and 12-column solves
            out[d], syncs, where = _count_syncs(call)
            _, svd_syncs, _ = _count_syncs(lambda: torch.linalg.svd(torch.eye(3, device=dev).expand(2, 3, 3)))
            assert syncs == 2 * svd_syncs, (syncs, svd_syncs, where)
        else:
            out[d] = call()
    ok, T, ni, matched = (x.cpu() for x in out[dev])
    assert torch.equal(ok, out["cpu"][0]) and torch.equal(matched, out["cpu"][3])
    assert bool(ok[2]) and int(matched[2]) == 2
    assert (ni - out["cpu"][2]).abs().max() <= 2
    torch.testing.assert_close(T[:, :3, :3], out["cpu"][1][:, :3, :3], rtol=0, atol=1e-4)
    torch.testing.assert_close(T[:, :3, 3], out["cpu"][1][:, :3, 3], rtol=0, atol=1e-3)


def drift_graph(n: int, dtype=torch.float32):
    """A circle of ``n`` poses integrated with a 2% drift and one loop edge (n − 1 ↔ 0, weight 20)."""
    from tpuslam_torch.backend import pose_graph as tpg
    from tpuslam_torch.common.geometry import so3_exp

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = 2 * np.pi * i / n
        gt[i, :3, :3] = so3_exp(torch.tensor([0.0, a + np.pi / 2, 0.0], dtype=torch.float64)).numpy()
        gt[i, :3, 3] = [10.0 * np.cos(a), 0.0, 10.0 * np.sin(a)]
    est = [gt[0]]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        rel[:3, :3] = so3_exp(torch.from_numpy(rng.normal(size=3) * 0.01)).numpy() @ rel[:3, :3]
        rel[:3, 3] *= 1.02
        est.append(est[-1] @ rel)
    g = tpg.graph_from_trajectory(torch.from_numpy(np.stack(est)))
    g = tpg.add_edge(g, n - 1, 0, n - 1, torch.from_numpy(np.linalg.inv(gt[0]) @ gt[n - 1]), weight=20.0)
    return g._replace(nodes=g.nodes.to(dtype), edge_T=g.edge_T.to(dtype), edge_weight=g.edge_weight.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_pose_graph_pcg_card_equals_cpu(dev, dtype):
    from tpuslam_torch.backend import pose_graph as tpg

    g = drift_graph(300, dtype)
    want = tpg.optimize_pose_graph(g, iterations=12)  # N > 256: PCG
    got = tpg.optimize_pose_graph(tpg.PoseGraph(*(x.to(dev) for x in g)), iterations=12)
    tol = 1e-3 if dtype == torch.float32 else 1e-6
    torch.testing.assert_close(got.nodes.cpu(), want.nodes, rtol=0, atol=tol)
    loop_gap = lambda nodes: float((torch.linalg.inv(nodes[0]) @ nodes[-1] - g.edge_T[299])[:3, 3].norm())  # noqa: E731
    assert loop_gap(want.nodes) < 0.05 * loop_gap(g.nodes)


def _chunk(i: int, shape=(4, 376, 1241)) -> np.ndarray:
    return np.random.default_rng(1000 + i).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_distinct_chunks_bit_equal(dev, depth):
    """Every staged chunk equals its host source, read at once and again after all later copies
    (a pinned buffer refilled under a running copy would corrupt an earlier chunk); the source
    array is overwritten after each yield, so only the staged copy can hold the chunk."""
    from tpuslam_torch.pre.stream import device_prefetch

    n = 10
    src = np.empty((4, 376, 1241), np.uint8)

    def batches():
        for i in range(n):
            src[...] = _chunk(i)
            yield src, np.full(4, float(i)), np.ones(4, bool)

    staged = []
    for i, (frames, stamps, valid) in enumerate(device_prefetch(batches(), device=dev, depth=depth)):
        assert frames.is_cuda and frames.dtype == torch.uint8 and stamps[0] == i
        torch.cuda._sleep(200_000)  # the consumer's work on its stream, while later copies run
        assert torch.equal(frames.cpu(), torch.from_numpy(_chunk(i)))
        staged.append(frames)
    torch.cuda.synchronize()
    assert len(staged) == n
    for i, frames in enumerate(staged):
        assert torch.equal(frames.cpu(), torch.from_numpy(_chunk(i))), i


def test_load_state_places_every_leaf_on_the_card(dev, tmp_path):
    from tpuslam_torch.backend.loop_closure import empty_db
    from tpuslam_torch.backend.map import empty_map
    from tpuslam_torch.frontend.fast import KeypointSet
    from tpuslam_torch.model.slam import VoState
    from tpuslam_torch.utils.checkpoint import flatten, load_state, save_state

    k = 16
    vo = VoState(KeypointSet(torch.rand(k, 2), torch.rand(k), torch.rand(k), torch.rand(k) > 0.5),
                 torch.randint(0, 256, (k, 32), dtype=torch.uint8), torch.tensor(True), torch.eye(4), 41,
                 torch.rand(k), torch.rand(k) > 0.5)
    trees = {"vo": vo, "map": empty_map(4, 64), "db": empty_db(4, 16, k, 32), "poses": np.eye(4)[None]}
    save_state(tmp_path / "ckpt.npz", **trees)
    back = load_state(tmp_path / "ckpt.npz", device=dev, **trees)
    for name, tree in trees.items():
        leaves = flatten(back[name])
        assert len(leaves) == len(flatten(tree))
        for got, want in zip(leaves, flatten(tree)):
            if isinstance(want, int):
                assert type(got) is int and got == want
            else:
                assert got.is_cuda and torch.equal(got.cpu(), torch.as_tensor(want)), name


@pytest.mark.parametrize("tracking", ["vo", "pnp"])
def test_split_run_equals_single_run_on_card(dev, tmp_path, tracking):
    """``SlamSystem.run`` at small shapes (K 512, 256 hypotheses, batch 4, the tree vocabulary) over
    the ten fixtures, split after frame 8 through a checkpoint loaded onto the card: the raw and the
    folded trajectory, the stats and every checkpoint leaf bit-equal to the uninterrupted run."""
    import dataclasses

    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.system import SlamSystem
    from tpuslam_torch.utils.checkpoint import flatten, load_state, save_state

    cfg_dir = IMAGES.parent.parent.parent / "configs"
    cfg = SlamConfig.from_yaml_dir(cfg_dir, batch_size=4)
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512),
                              pose=dataclasses.replace(cfg.pose, num_hypotheses=256))
    system = SlamSystem(Camera.from_yaml(cfg_dir / "camera.yml"), cfg, vocabulary=cfg_dir / "vocabulary_tree.npz",
                        tracking=tracking, device=dev)
    imgs = np.stack([decode_png_gray8(p) for p in sorted(IMAGES.glob("*.png"))])

    def batches(start, stop):
        for s in range(start, stop, 4):
            blk = imgs[s:min(s + 4, stop)]
            nb = len(blk)
            yield np.concatenate([blk, np.repeat(blk[-1:], 4 - nb, 0)]), np.zeros(4), np.arange(4) < nb

    single = system.run(batches(0, 10))
    first = system.run(batches(0, 8))
    save_state(tmp_path / "ckpt.npz", slam=first["checkpoint"])
    resume = load_state(tmp_path / "ckpt.npz", device=dev, slam=system.checkpoint_template())["slam"]
    split = system.run(batches(8, 10), resume=resume)
    assert single["pose_ok"][1:].all()
    for k in ("poses", "pose_ok", "reloc_ok", "num_matches", "num_inliers"):
        np.testing.assert_array_equal(split[k], single[k], err_msg=k)
    assert split["ba_events"] == single["ba_events"]
    for i, (g, w) in enumerate(zip(flatten(split["checkpoint"]), flatten(single["checkpoint"]))):
        g, w = (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (g, w))
        np.testing.assert_array_equal(g, w, err_msg=f"checkpoint leaf {i}")


def _full_frames(n: int) -> torch.Tensor:
    return torch.from_numpy(np.stack([decode_png_gray8(p) for p in sorted(IMAGES.glob("*.png"))[:n]]))


def _detectors(dev, bins: int, max_keypoints: int = 512):
    import dataclasses

    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg = dataclasses.replace(DetectorConfig.from_yaml(IMAGES.parent.parent.parent / "configs" / "feature_detector.yml"),
                              brief_quantized_bins=bins, max_keypoints=max_keypoints)
    return FeatureDetector(cfg, device=dev), FeatureDetector(cfg, device="cpu")


def _same_keypoints(a, b, angle_atol=1e-4):
    for f in ("xy", "response", "valid"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
    torch.testing.assert_close(a.angle.cpu(), b.angle.cpu(), rtol=0, atol=angle_atol)


def test_exact_brief_detector_card_equals_cpu(dev):
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    gpu, cpu = _detectors(dev, 0, 1024)
    frames = _full_frames(2)
    reset_launch_counts()
    kg, dg = gpu.detect_and_compute_batch(frames.to(dev))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_frontend_batch"] == 1
    assert counts["extract_brief_patches"] == counts["brief_own_bin_dots"] == 0
    kc, dc = cpu.detect_and_compute_batch(frames)
    _same_keypoints(kg, kc)
    assert torch.equal(dg.cpu(), dc) and int(kc.valid.sum()) > 1000


@pytest.mark.parametrize("bins", [0, 16])
def test_single_image_api_on_card(dev, bins):
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    gpu, cpu = _detectors(dev, bins)
    frames = _full_frames(2)
    image = frames[1]
    reset_launch_counts()
    k_det = gpu.detect(image.to(dev))
    k_cmp, d_cmp = gpu.compute(image.to(dev), k_det)
    k_dac, d_dac = gpu.detect_and_compute(image.to(dev))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_frontend_batch"] == 3
    assert counts["extract_brief_patches"] == counts["brief_own_bin_dots"] == (2 if bins else 0)
    assert k_det.xy.is_cuda and d_dac.is_cuda
    _same_keypoints(k_det, cpu.detect(image), angle_atol=0)
    c_cmp, cd_cmp = cpu.compute(image, cpu.detect(image))
    _same_keypoints(k_cmp, c_cmp)
    assert torch.equal(d_cmp.cpu(), cd_cmp) and torch.equal(d_dac, d_cmp)
    kb, db = gpu.detect_and_compute_batch(frames.to(dev))
    assert torch.equal(db[1], d_dac) and torch.equal(kb.angle[1], k_dac.angle)


def test_detect_keypoints_on_card(dev):
    """The single-image FAST + NMS + top-k launches kernel 1 once on the card and equals the CPU's."""
    from tpuslam_torch.frontend.fast import detect_keypoints
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    image = _full_frames(1)[0]
    args = dict(threshold=20, contiguous=12, window=12, max_keypoints=1024)
    reset_launch_counts()
    got = detect_keypoints(image.to(dev), **args)
    torch.cuda.synchronize()
    assert launch_counts()["fused_frontend_batch"] == 1 and got.xy.is_cuda
    want = detect_keypoints(image, **args)
    _same_keypoints(got, want, angle_atol=0)
    assert got.capacity == 1024 and int(want.count()) > 500


def test_pose_estimator_card_equals_cpu(dev):
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import PoseConfig
    from tpuslam_torch.frontend.pose import PoseEstimator

    cam = Camera.from_yaml(IMAGES.parent.parent.parent / "configs" / "camera.yml")
    rng = np.random.default_rng(3)
    M = 600
    X = np.stack([rng.uniform(-8, 8, M), rng.uniform(-3, 3, M), rng.uniform(6, 40, M)], -1)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    x1 = X @ cam.K.T
    x2 = (X @ R.T + [0.1, 0.0, -1.0]) @ cam.K.T
    pts1 = torch.from_numpy((x1[:, :2] / x1[:, 2:] + rng.normal(0, 0.3, (M, 2))).astype(np.float32))
    pts2 = torch.from_numpy((x2[:, :2] / x2[:, 2:] + rng.normal(0, 0.3, (M, 2))).astype(np.float32))
    valid = torch.from_numpy(rng.random(M) > 0.1)
    draws = torch.from_numpy(rng.integers(0, int(valid.sum()), (512, 8)))
    cfg = PoseConfig(num_hypotheses=512)
    got = PoseEstimator(cam, cfg, device=dev).estimate(pts1, pts2, valid, draws=draws)
    want = PoseEstimator(cam, cfg, device="cpu").estimate(pts1, pts2, valid, draws=draws)
    assert bool(got.success) and bool(want.success)
    assert int(got.num_inliers) == int(want.num_inliers) and torch.equal(got.inliers.cpu(), want.inliers)
    torch.testing.assert_close(got.R.cpu(), want.R, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.t.cpu(), want.t, rtol=0, atol=1e-3)


@pytest.mark.parametrize("branching", [None, (4, 32)])
def test_vocabulary_fit_card_equals_cpu(dev, branching):
    from tpuslam_torch.backend.vocabulary import Vocabulary

    gpu, _ = _detectors(dev, 16)
    kps, desc = gpu.detect_and_compute_batch(_full_frames(3).to(dev))
    docs = [d[v].cpu().numpy() for d, v in zip(desc, kps.valid)]
    got = Vocabulary.fit(docs, num_words=64, iters=4, branching=branching, device=dev)
    want = Vocabulary.fit(docs, num_words=64, iters=4, branching=branching, device="cpu")
    assert got.centroids.is_cuda and torch.equal(got.centroids.cpu(), want.centroids)
    assert (got.coarse is None) == (want.coarse is None) == (branching is None)
    assert branching is None or torch.equal(got.coarse.cpu(), want.coarse)
    torch.testing.assert_close(got.idf.cpu(), want.idf, rtol=0, atol=1e-6)


def test_profiling_sees_the_card(dev, tmp_path):
    import json

    from tpuslam_torch.utils.profiling import time_fn
    from tpuslam_torch.utils.profiling import device_trace

    x = torch.ones(512, 512, device=dev)
    out = time_fn(lambda: torch.cuda._sleep(1_000_000) or x @ x, warmup=1, iters=3)
    assert out["per_call_ms"] > 0.1  # the sleeps were waited for
    frames = _full_frames(1).to(dev)
    taps = torch.from_numpy(gaussian_kernel().astype(np.float32))
    with device_trace(tmp_path):
        kf.fused_frontend_batch(frames, threshold=20, contiguous=12, taps=taps)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("frontend" in n for n in names), sorted(names)[:20]


def test_kernels_1_to_4_at_batch_64(dev):
    """The batched VO path's chunk: 64 full-width frames (the ten fixtures tiled), 1024 keypoints."""
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.detector import FeatureDetector

    det = FeatureDetector(DetectorConfig.from_yaml(IMAGES.parent.parent.parent / "configs" / "feature_detector.yml"),
                          device=dev)
    c = det.config
    frames = _full_frames(10)[torch.arange(64) % 10].contiguous().to(dev)
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    got = kf.fused_frontend_batch(frames, **args)
    for g, w in zip(got, kf.fused_frontend_reference(frames, **args)):
        assert torch.equal(g, w)
    blur, kps = det._detect_level(frames, c.max_keypoints)
    assert kps.xy.shape == (64, 1024, 2) and int(kps.valid.sum()) > 64 * 300
    patches = kb.extract_brief_patches(blur, kps.xy, c.patch_size)
    assert torch.equal(patches, kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size))
    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    dots = kb.brief_own_bin_dots(patches, bins, det.bin_weights)
    assert torch.equal(dots, kb.brief_own_bin_dots_reference(patches, bins, det.bin_weights_3d))
    E, P = _kernel4_case(dev, 64, 1024, 1024)
    torch.testing.assert_close(kp.msac_scores(E, P), kp.msac_scores_reference(E, P), rtol=1e-5, atol=0.0)


def test_batched_vo_step_on_card(dev):
    """Three sequences from frames 0, 2 and 4 of the fixtures (K 512, 256 hypotheses, batch 4), two
    batched steps (the second ragged) against each sequence's ``process_chunk`` on the card."""
    import dataclasses

    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline

    cfg_dir = IMAGES.parent.parent.parent / "configs"
    cfg = SlamConfig.from_yaml_dir(cfg_dir, batch_size=4)
    cfg = dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=512),
                              pose=dataclasses.replace(cfg.pose, num_hypotheses=256))
    pipe = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"), cfg, device=dev)
    imgs = _full_frames(10).to(dev)
    seqs = torch.stack([imgs[2 * s: 2 * s + 6] for s in range(3)])  # (3, 6, H, W): chunks of 4 and 2 frames
    seeds = [3, 4, 5]
    states = [pipe.initial_state() for _ in seeds]
    want = list(states)
    for lo, n in ((0, 4), (4, 2)):
        frames = torch.cat([seqs[:, lo:lo + n], seqs[:, lo + n - 1:lo + n].expand(3, 4 - n, *seqs.shape[2:])], 1)
        frames = frames.contiguous()
        valid = torch.arange(4).expand(3, 4) < n
        results, states = pipe.process_chunks(frames, valid, states, seeds)
        for s in range(3):
            w, want[s] = pipe.process_chunk(frames[s], valid[s], want[s], seeds[s])
            for k in ("pose_ok", "num_matches", "num_inliers"):
                assert torch.equal(getattr(results[s], k), getattr(w, k)), (lo, s, k)
            torch.testing.assert_close(results[s].poses[:, :3, :3], w.poses[:, :3, :3], rtol=0, atol=1e-4)
            torch.testing.assert_close(results[s].poses[:, :3, 3], w.poses[:, :3, 3], rtol=0, atol=1e-3)
            assert states[s].frame_idx == want[s].frame_idx
            assert results[s].pose_ok[1:n].all()


def test_batched_ransac_pnp_on_card(dev):
    """Five problems (one with four valid matches, one with none) against five unbatched calls."""
    from tpuslam_torch.backend.pnp import gumbel_sample_indices, ransac_pnp, so3_exp

    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X, uv, valid = [], [], []
    for _ in range(5):
        x = rng.uniform([-3, -2, 4], [3, 2, 12], size=(200, 3))
        R = so3_exp(torch.from_numpy(rng.normal(size=3) * 0.3).float()).double().numpy()
        pix = (x @ R.T + rng.normal(size=3) * 0.3) @ K.T
        u = pix[:, :2] / pix[:, 2:] + rng.normal(size=(200, 2)) * 0.3
        u[:40] = rng.uniform([0, 0], [640, 480], (40, 2))
        X.append(x), uv.append(u), valid.append(rng.random(200) > 0.1)
    valid[2][:] = False
    valid[2][[3, 9, 17, 30]] = True
    valid[4][:] = False
    X, uv = (torch.from_numpy(np.stack(a)).float().to(dev) for a in (X, uv))
    valid = torch.from_numpy(np.stack(valid)).to(dev)
    Kt = torch.from_numpy(K).float().to(dev)
    idx = gumbel_sample_indices(valid, 512, 6, torch.Generator(device=dev).manual_seed(1))
    kw = dict(num_hypotheses=512, min_inliers=12, refine="gn", hyp_sweeps=6)
    b = ransac_pnp(X, uv, valid, Kt, idx, **kw)
    for v in range(5):
        s = ransac_pnp(X[v], uv[v], valid[v], Kt, idx[v], **kw)
        assert bool(b.success[v]) == bool(s.success) and int(b.num_inliers[v]) == int(s.num_inliers)
        assert torch.equal(b.inliers[v], s.inliers)
        torch.testing.assert_close(b.R[v], s.R, rtol=0, atol=1e-4)
        torch.testing.assert_close(b.t[v], s.t, rtol=0, atol=1e-3)
    assert b.success.tolist() == [True, True, False, True, False]


def _motion_pnp_2d(K, R, t, X, uv, valid, iters, min_inliers, schedule, thr=2.0):
    """``motion_pnp`` as it was before the problem axis, written with 2-D products: the tracker's call."""
    from tpuslam_torch.backend.pnp import _apply_step, _gn_step, _gn_system, reprojection_errors

    vf = valid.float()
    fx, fy = K[0, 0], K[1, 1]
    for i in range(iters):
        Xc = X @ R.T + t
        z = Xc[:, 2]
        behind = z <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, z)
        r = ((Xc * inv_z[:, None]) @ K.T)[:, :2] - uv
        err = torch.linalg.vector_norm(r, dim=-1)
        delta = schedule[min(i, len(schedule) - 1)]
        w = vf * torch.where(~behind, torch.clamp_max(delta / torch.clamp_min(err, 1e-9), 1.0), 0.0)
        R, t = _apply_step(R, t, _gn_step(_gn_system(Xc, fx, fy, inv_z), w, r))
    err, z = reprojection_errors(K, R, t, X, uv)
    inliers = (err < thr) & (z > 0) & valid
    count = inliers.sum(dtype=torch.int32)
    ok = (count >= min_inliers) & torch.isfinite(R).all() & torch.isfinite(t).all()
    return (torch.where(ok, R, torch.eye(3, device=R.device)), torch.where(ok, t, 0.0), inliers & ok,
            torch.where(ok, count, 0), ok)


def _ransac_pnp_2d(X, uv, valid, K, idx, min_inliers, lo_rounds, thr=2.0):
    """``ransac_pnp`` (Gauss-Newton LO, 6 hypothesis sweeps) as it was before the problem axis."""
    from tpuslam_torch.backend.pnp import refine_pnp_gn, reprojection_errors, solve_pnp_dlt

    xn = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
    R_h, t_h = solve_pnp_dlt(X[idx], xn[idx], sweeps=6)
    err, z = reprojection_errors(K, R_h, t_h, X, uv)
    inlier_mat = (err < thr) & (z > 0) & valid[None, :]
    counts = inlier_mat.sum(dim=-1, dtype=torch.int32)
    best = torch.argmax(counts).reshape(1)
    R, t, inl, n = (a.index_select(0, best)[0] for a in (R_h, t_h, inlier_mat, counts))
    for _ in range(lo_rounds):
        R_r, t_r = refine_pnp_gn(K, R, t, X, uv, inl.float(), iters=3)
        err_r, z_r = reprojection_errors(K, R_r, t_r, X, uv)
        inl_r = (err_r < thr) & (z_r > 0) & valid
        n_r = inl_r.sum(dtype=torch.int32)
        better = n_r >= n
        R, t, inl, n = (torch.where(better, a, b) for a, b in ((R_r, R), (t_r, t), (inl_r, inl), (n_r, n)))
    ok = (n >= min_inliers) & (valid.sum(dtype=torch.int32) >= idx.shape[1])
    return torch.where(ok, R, torch.eye(3, device=R.device)), torch.where(ok, t, 0.0), inl & ok, \
        torch.where(ok, n, 0), ok


def test_unbatched_pnp_keeps_its_2d_products_on_card(dev):
    """On the card an (M,) call runs without the problem axis: the tracker's ``motion_pnp`` and
    ``ransac_pnp`` give the bits of their 2-D formulation (``torch.equal`` on every field)."""
    from tpuslam_torch.backend.pnp import gumbel_sample_indices, motion_pnp, ransac_pnp, so3_exp

    rng = np.random.default_rng(5)
    K = torch.tensor([[718.856, 0, 607.1928], [0, 718.856, 185.2157], [0, 0, 1]], device=dev)
    for M in (30, 1024):
        x = rng.uniform([-8, -3, 4], [8, 3, 40], size=(M, 3))
        R = so3_exp(torch.from_numpy(rng.normal(size=3) * 0.1).float()).double().numpy()
        t = rng.normal(size=3) * 0.5
        pix = (x @ R.T + t) @ K.cpu().double().numpy().T
        u = pix[:, :2] / pix[:, 2:] + rng.normal(size=(M, 2)) * 0.5
        u[: M // 5] += rng.normal(size=(M // 5, 2)) * 40
        X, uv = (torch.from_numpy(a).float().to(dev) for a in (x, u))
        valid = torch.from_numpy(rng.random(M) > 0.1).to(dev)
        R0 = so3_exp(torch.from_numpy(rng.normal(size=3) * 0.02).float()).to(dev) @ torch.from_numpy(R).float().to(dev)
        t0 = torch.from_numpy(t).float().to(dev) + 0.05
        sched = (32.0, 16.0, 8.0, 4.0, 2.0, 2.0)
        got = motion_pnp(K, R0, t0, X, uv, valid, iters=6, min_inliers=12, huber_schedule=sched)
        want = _motion_pnp_2d(K, R0, t0, X, uv, valid, 6, 12, sched)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), M
        idx = gumbel_sample_indices(valid.cpu(), 256, 6, torch.Generator().manual_seed(2)).to(dev)
        got = ransac_pnp(X, uv, valid, K, idx, num_hypotheses=256, min_inliers=12, solver_sweeps=8,
                         hyp_sweeps=6, lo_rounds=1, refine="gn")
        want = _ransac_pnp_2d(X, uv, valid, K, idx, 12, 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), M
        assert bool(got.success), M
