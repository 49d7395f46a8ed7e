"""Exact continuous-angle BRIEF (``BriefQuantizedBins: 0``) and the single-image detector API:
tpuslam_torch against tpuslam on the CPU.

Both packages blur with the Pallas kernel's rounding (every product and
sum rounded to float32; the port's kernel-1 twin, bit-exact with it in
``test_torch_frontend.py``).  The reference's XLA CPU blur contracts into
FMAs (``test_torch_brief.py``), which moves a few .5 ties and so an angle
by up to 0.03 deg; here its ``_compute_impl`` blurs with the twin, called
back from its traced program.

The moment maps are integer sums below 2^24: exact.  Angles agree to 1e-4
deg (float32 ``atan2`` of the two libraries).  Descriptors are bit-exact
except where a rotated pattern coordinate ``x·cos − y·sin`` lies at an
integer: XLA's CPU compiler contracts it into ``fma(x, cos, −fl(y·sin))``,
the port rounds both products (as kernel code and every device here do),
and the C-style truncation then lands on either side of the integer.  The
test finds each such coordinate, shows that the reference's bits follow
from the contracted rounding and the port's from its own, and holds every
other keypoint bit for bit (ROADMAP F5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.common import camera as jcam
from tpuslam.config.schema import DetectorConfig as JDetectorConfig
from tpuslam.frontend import brief as jb
from tpuslam.frontend import detector as jdetector
from tpuslam.frontend import fast as jfast
from tpuslam_torch.common import camera as tcam
from tpuslam_torch.config.schema import DetectorConfig as TDetectorConfig
from tpuslam_torch.frontend import brief as tb
from tpuslam_torch.frontend import fast as tfast
from tpuslam_torch.frontend.detector import FeatureDetector as TDetector
from tpuslam_torch.frontend.fast import KeypointSet
from tpuslam_torch.kernels.frontend import fused_frontend_batch

PAIRS, PATCH = 256, 31
ANGLE_ATOL = 1e-4  # degrees: float32 atan2 of XLA and of torch


def _blur_no_fma(image, kernel):
    """The reference's blur with every product and sum rounded (the Pallas kernel's rounding): the
    port's kernel-1 twin, called back from the traced program (XLA would contract any jnp form)."""

    def twin(im, k):
        taps = torch.from_numpy(np.array(k, np.float32))
        return tb.gaussian_blur_u8(torch.from_numpy(np.array(im))[None], taps)[0].numpy()

    return jax.pure_callback(twin, jax.ShapeDtypeStruct(image.shape, jnp.uint8), image, kernel,
                             vmap_method="sequential")


@pytest.fixture(scope="module", autouse=True)
def reference_blur_without_fma():
    """Every reference ``compute`` in this module blurs with :func:`_blur_no_fma`."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdetector, "gaussian_blur_u8", _blur_no_fma)
    jax.clear_caches()  # drop any trace of _compute_impl made with the contracted blur
    yield
    mp.undo()
    jax.clear_caches()


def _cfg(cls, path, **over):
    return dataclasses.replace(cls.from_yaml(path), brief_quantized_bins=0, **over)


@pytest.fixture(scope="module")
def frames(kitti_frames):
    return np.stack(kitti_frames)


@pytest.fixture(scope="module")
def blur(frames):
    taps = torch.from_numpy(jb.gaussian_kernel().astype(np.float32))
    return fused_frontend_batch(torch.from_numpy(frames), threshold=20, contiguous=12, taps=taps)[0].numpy()


@pytest.fixture(scope="module")
def reference(frames, blur):
    """The reference's keypoints (K 1024) and exact-path angles and descriptors on the 10 fixtures."""
    kps = jax.vmap(lambda im: jfast.detect_keypoints(
        im, threshold=20, contiguous=12, nms=True, window=12, max_keypoints=1024))(jnp.asarray(frames))
    pattern = jb.generate_brief_pattern(PAIRS, PATCH, 42)
    k2, desc = jax.jit(jax.vmap(lambda b, k: jdetector._compute_from_blurred(b, k, pattern, None, PAIRS, PATCH, 0)))(
        jnp.asarray(blur), kps)
    kps = KeypointSet(*(torch.from_numpy(np.array(f)) for f in kps))
    return kps, np.asarray(k2.angle), np.asarray(desc)


@pytest.mark.parametrize("radius", [15, 3])
def test_moment_maps_exact(blur, radius):
    want = jax.jit(jb.orientation_moment_maps, static_argnums=1)(jnp.asarray(blur[0], jnp.float32), radius)
    got = tb.orientation_moment_maps(torch.from_numpy(blur[:1]).float(), radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_orientations_match(blur, reference):
    """On frames 0, 4 and 8 (the moment maps of all 10 cost seconds on one thread)."""
    kps, want, _ = reference
    sel = [0, 4, 8]
    got = tb.compute_orientations(torch.from_numpy(blur[sel]), KeypointSet(*(f[sel] for f in kps)), PATCH).numpy()
    want = want[sel]
    assert int(kps.valid[sel].sum()) > 2000
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_ATOL)


def _rotated(p, c, s, fma):
    """Integer rotated coordinates (..., K, P) of pattern offsets p (P, 2) by float32 cos/sin (..., K, 1).

    ``fma``: x = fl(p0·c − fl(p1·s)), y = fl(p0·s + fl(p1·c)), XLA CPU's
    contraction (exact in float64: each product has at most 29 bits);
    otherwise every product and sum is rounded to float32.
    """
    p0 = p[:, 0].astype(np.float32)
    p1 = p[:, 1].astype(np.float32)
    if fma:
        x = (p0.astype(np.float64) * c - (p1 * s).astype(np.float64)).astype(np.float32)
        y = (p0.astype(np.float64) * s + (p1 * c).astype(np.float64)).astype(np.float32)
    else:
        x, y = p0 * c - p1 * s, p0 * s + p1 * c
    return x.astype(np.int32), y.astype(np.int32), x, y


def _descriptor_row(img, kx, ky, ok, coords, pattern):
    """numpy oracle of one keypoint's exact descriptor from its integer rotated coordinates."""
    x1, y1, x2, y2 = (c + o for c, o in zip(coords, (kx, ky, kx, ky)))
    h, w = img.shape
    inside = (x1 >= 0) & (x1 < w) & (y1 >= 0) & (y1 < h) & (x2 >= 0) & (x2 < w) & (y2 >= 0) & (y2 < h)
    valid = inside & pattern["pair_valid"]
    bits = np.zeros(PAIRS, bool)
    bit = img[y1.clip(0, h - 1), x1.clip(0, w - 1)] < img[y2.clip(0, h - 1), x2.clip(0, w - 1)]
    bits[: int(valid.sum())] = bit[valid]
    return np.packbits(bits & ok, bitorder="little")


def test_exact_descriptors_bit_exact_but_traced_integer_coordinates(blur, reference):
    """Given the reference's angles: every descriptor bit-exact except at traced integer coordinates."""
    kps, angles, want = reference
    pattern = tb.generate_brief_pattern(PAIRS, PATCH, 42)
    got = tb.compute_brief_descriptors(torch.from_numpy(blur), kps, torch.from_numpy(angles.copy()), pattern,
                                       PAIRS, PATCH).numpy()
    assert (want.any(axis=-1)).sum() > 6000
    # each package's float32 cos/sin of the same float32 angle
    theta = jnp.asarray(angles) * (jnp.pi / 180.0)
    c_ref = np.asarray(jax.jit(jnp.cos)(theta))[..., None]
    s_ref = np.asarray(jax.jit(jnp.sin)(theta))[..., None]
    t = torch.from_numpy(angles.copy()) * (np.pi / 180.0)
    c_port = torch.cos(t).numpy()[..., None]
    s_port = torch.sin(t).numpy()[..., None]
    pat = tb.generate_brief_pattern_numpy(PAIRS, PATCH, 42)
    ref_c = [_rotated(pat[n], c_ref, s_ref, fma=True) for n in ("p1", "p2")]
    port_c = [_rotated(pat[n], c_port, s_port, fma=False) for n in ("p1", "p2")]
    flip = np.zeros(angles.shape, bool)
    for (rx, ry, rxf, ryf), (px, py, pxf, pyf) in zip(ref_c, port_c):
        for r_int, p_int, r_f, p_f in ((rx, px, rxf, pxf), (ry, py, ryf, pyf)):
            d = r_int != p_int
            # every flip is a coordinate at an integer in one rounding, within an ulp of it in the other
            near = np.minimum(np.abs(r_f - np.round(r_f)), np.abs(p_f - np.round(p_f)))
            assert np.all(near[d] <= 4e-6), near[d].max()
            flip |= d.any(axis=-1)
    rows = (got != want).any(axis=-1)
    assert not (rows & ~flip).any(), np.argwhere(rows & ~flip)[:5]  # no unexplained difference
    assert flip.sum() <= 3, np.argwhere(flip)  # a handful on 10 frames (frame 8, kp 696: atan2(3, 4))
    img = blur
    ok = tb._border_ok(kps, PATCH, blur.shape[-2:]).numpy()
    xy = kps.xy.numpy().astype(np.int32)
    for f, k in np.argwhere(flip):
        coords_r = [a[f, k] for (ix, iy, _, _) in ref_c for a in (ix, iy)]
        coords_p = [a[f, k] for (ix, iy, _, _) in port_c for a in (ix, iy)]
        args = (img[f], xy[f, k, 0], xy[f, k, 1], ok[f, k])
        np.testing.assert_array_equal(_descriptor_row(*args, coords_r, pat), want[f, k])
        np.testing.assert_array_equal(_descriptor_row(*args, coords_p, pat), got[f, k])


def test_tiny_image_branch():
    """An image smaller than the 45-pixel rotation patch takes the direct gather; both packages agree."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    K = 64
    xy = np.stack([rng.integers(8, 40, K), rng.integers(8, 32, K)], -1).astype(np.float32)
    valid = rng.random(K) > 0.2
    angles = rng.uniform(-180, 180, K).astype(np.float32)
    jk = jfast.KeypointSet(jnp.asarray(xy), jnp.zeros(K), jnp.zeros(K), jnp.asarray(valid))
    tk = KeypointSet(torch.from_numpy(xy), torch.zeros(K), torch.zeros(K), torch.from_numpy(valid))
    assert 2 * tb.rotation_patch_half(PATCH) + 1 > min(img.shape)
    want = np.asarray(jax.jit(jb.compute_brief_descriptors, static_argnums=(4, 5))(
        jnp.asarray(img), jk, jnp.asarray(angles), jb.generate_brief_pattern(PAIRS, PATCH), PAIRS, PATCH))
    got = tb.compute_brief_descriptors(torch.from_numpy(img), tk, torch.from_numpy(angles),
                                       tb.generate_brief_pattern(PAIRS, PATCH), PAIRS, PATCH).numpy()
    assert want.any(axis=-1).sum() >= 4  # keypoints 15 px inside the border have live bits
    np.testing.assert_array_equal(got, want)
    got_o = tb.compute_orientations(torch.from_numpy(img), tk, PATCH).numpy()
    want_o = np.asarray(jax.jit(jb.compute_orientations, static_argnums=2)(jnp.asarray(img), jk, PATCH))
    np.testing.assert_allclose(got_o, want_o, rtol=0, atol=ANGLE_ATOL)


def test_detect_keypoints_matches(frames):
    """The single-image FAST + NMS + top-k (kernel 1's twin on the CPU) against the reference's, on a crop."""
    crop = np.ascontiguousarray(frames[2][100:400, 300:1000])
    want = jfast.detect_keypoints(jnp.asarray(crop), threshold=20, contiguous=12, max_keypoints=300)
    got = tfast.detect_keypoints(torch.from_numpy(crop), threshold=20, contiguous=12, max_keypoints=300)
    for f in ("xy", "response", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.capacity == 300 and int(got.count()) == int(want.count()) > 100


def test_mask_run_matches():
    rng = np.random.default_rng(2)
    mask = rng.random((16, 7, 9)) > 0.3
    for run in (1, 3, 9, 12, 16):
        np.testing.assert_array_equal(tfast._mask_run(torch.from_numpy(mask), run).numpy(),
                                      np.asarray(jfast.mask_run(jnp.asarray(mask), run)))


@pytest.fixture(scope="module")
def detectors(data_dir):
    path = data_dir.parent.parent / "configs" / "feature_detector.yml"
    jd = jdetector.FeatureDetector(_cfg(JDetectorConfig, path))
    td = TDetector(_cfg(TDetectorConfig, path), device="cpu")
    assert jd.bin_weights is None and td.bin_weights is None and td.rotated_offsets is None
    return jd, td


def _flipped_rows_only(got, want, max_rows=3):
    rows = (np.asarray(got) != np.asarray(want)).any(axis=-1)
    assert rows.sum() <= max_rows, int(rows.sum())
    return rows


def test_single_image_api_matches_reference(detectors, frames):
    """``detect``, ``compute`` and ``detect_and_compute`` on one image against the reference's."""
    jd, td = detectors
    for i in (8,):  # the frame with the traced coordinate
        image = frames[i]
        jk = jd.detect(jnp.asarray(image))
        tk = td.detect(torch.from_numpy(image))
        for f in ("xy", "response", "valid"):
            np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)))
        assert tk.capacity == 1024 and int(tk.count()) == int(jk.count()) > 500
        jk2, jdesc = jd.compute(jnp.asarray(image), jk)
        tk2, tdesc = td.compute(torch.from_numpy(image), tk)
        np.testing.assert_allclose(tk2.angle.numpy(), np.asarray(jk2.angle), rtol=0, atol=ANGLE_ATOL)
        rows = _flipped_rows_only(tdesc.numpy(), jdesc)  # frame 8's traced coordinate (test above)
        assert rows.sum() == 1
        tk3, tdesc3 = td.detect_and_compute(torch.from_numpy(image))
        assert torch.equal(tdesc3, tdesc) and torch.equal(tk3.angle, tk2.angle)
    kb, db = td.detect_and_compute_batch(torch.from_numpy(frames[:2]))
    k1, d1 = td.detect_and_compute(torch.from_numpy(frames[1]))
    assert torch.equal(d1, db[1]) and torch.equal(k1.xy, kb.xy[1]) and torch.equal(k1.angle, kb.angle[1])


@pytest.mark.parametrize("normalize", [True, False])
def test_undistort_image_matches(data_dir, frames, normalize):
    cam_path = data_dir.parent.parent / "configs" / "camera.yml"
    jc = jcam.Camera.from_yaml(cam_path)
    idx, valid = jc.device_undistort_map()
    want = np.asarray(jcam.undistort_image(jnp.asarray(frames[3]), idx, valid, normalize=normalize))
    t_idx, t_valid = tcam.Camera.from_yaml(cam_path).device_undistort_map()
    got = tcam.undistort_image(torch.from_numpy(frames[3]), t_idx, t_valid, normalize=normalize).numpy()
    assert got.dtype == want.dtype == (np.float32 if normalize else np.uint8)
    np.testing.assert_array_equal(got, want)


def test_pyramid_at_bins_0_matches_reference(monkeypatch, data_dir, frames):
    """``configs/multiscale`` with exact BRIEF, cut to its first 2 levels (each level is a compile of the
    reference), on 2 frames, the reference's level images injected."""
    from test_torch_pyramid import _jax_resize
    from tpuslam_torch.frontend import detector as tdetector

    monkeypatch.setattr(tdetector, "resize_batch_u8", _jax_resize)
    path = data_dir.parent.parent / "configs" / "multiscale" / "feature_detector.yml"
    jd = jdetector.FeatureDetector(_cfg(JDetectorConfig, path, max_keypoints=512, num_levels=2))
    td = TDetector(_cfg(TDetectorConfig, path, max_keypoints=512, num_levels=2), device="cpu")
    jk, jdesc = jd.detect_and_compute_batch(jnp.asarray(frames[:2]))
    tk, tdesc = td.detect_and_compute_batch(torch.from_numpy(frames[:2]))
    assert len(td._feasible_levels(*frames.shape[-2:])) == 2 and int(tk.valid.sum()) > 800
    for f in ("xy", "response", "valid"):
        np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)))
    np.testing.assert_allclose(tk.angle.numpy(), np.asarray(jk.angle), rtol=0, atol=ANGLE_ATOL)
    np.testing.assert_array_equal(tdesc.numpy(), np.asarray(jdesc))
