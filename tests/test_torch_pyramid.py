"""The image pyramid (``configs/multiscale``): tpuslam_torch against tpuslam on the CPU.

The resize is held to the reference's CPU path by its own tolerance (XLA's
CPU compiler sums the dense resize in an order no elementwise program
reproduces), and the rest of the pyramid is held bit for bit by giving both
packages the same level images: the port's ``resize_batch_u8`` is replaced
by the reference's ``_resize_batch_u8``.  Detector and pipeline run at
``MaxKeypoints`` 512, 4 levels at scale 1.2: level capacities 204, 142, 98
and 68, every level on kernel 5's twin when ``nms_fused`` is on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import DetectorConfig as JDetectorConfig
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.frontend import detector as jdetector
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import DetectorConfig as TDetectorConfig
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.frontend import detector as tdetector
from tpuslam_torch.model import slam as tslam
from tpuslam_torch.pre.stream import FrameStream

K_CAP, H_HYP, BATCH = 512, 256, 4
# (h, w) of levels 1-3 of a 1392×512 frame at scale 1.2
LEVEL_SHAPES = [(427, 1160), (356, 967), (296, 806)]


def _jax_resize(images: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """The reference's CPU resize, as a drop-in for the port's ``resize_batch_u8``."""
    out = jdetector._resize_batch_u8(jnp.asarray(images.cpu().numpy()), h_out, w_out)
    return torch.from_numpy(np.array(out)).to(images.device)


@pytest.fixture(scope="module")
def cfg_dir(data_dir):
    return data_dir.parent.parent / "configs" / "multiscale"


@pytest.mark.parametrize("h_out,w_out", LEVEL_SHAPES)
def test_resize_weights_match_jax(h_out, w_out):
    """``resize_weights_numpy`` equals ``jax.image.resize`` of an identity, within 2·2⁻²³.

    Not bit for bit, and not within one ulp: no single float32 recipe can
    be.  XLA's CPU code computes each weight twice, once in the loop nest
    that feeds the column sums and once in the one that divides by them,
    and its LLVM backend rounds the two differently.  Where a loop runs
    vectorised it contracts the sample position ``(i + ½)·inv_scale − ½``
    into an FMA and rounds the triangle ``1 − |d|·r`` in two steps; where
    it has constant-folded the sample positions (the last columns of an
    axis, or every column of the sums for 296 rows) it rounds the product
    first and contracts the triangle into an FMA instead.  It also sums
    each column in blocks of 32 rows.  So one weight's numerator and its
    column sum can come from different roundings.  The port applies the
    vectorised loops' formula to both (FMA position, two-step triangle,
    sums in input order).  Measured: 0-51 of the 1022-2782 nonzero
    weights of an axis differ, by at most 1.5·2⁻²³ (296×512).  The
    tolerance is two ulp of 1.0, the sum of each weight column; the band of
    nonzero taps is identical.
    """
    for n_in, n_out in ((512, h_out), (1392, w_out)):
        want = np.asarray(jax.image.resize(
            jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in), method="linear",
            precision=jax.lax.Precision.HIGHEST,
        ))
        got = tdetector.resize_weights_numpy(n_in, n_out)
        assert got.dtype == np.float32 and got.shape == (n_out, n_in)
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0**-23)


@pytest.fixture(scope="module")
def two_frames(kitti_frames):
    return np.stack(kitti_frames[:2])


@pytest.mark.parametrize("h_out,w_out", LEVEL_SHAPES)
def test_resize_close_to_jax(two_frames, h_out, w_out):
    """The port's resize vs the reference's CPU resize on 2 fixture frames.

    At most 1 gray level anywhere, on at most 0.05% of the pixels of a
    level: the two sum the same weights in different orders, and a sum that
    lands within an ulp of .5 rounds to either side.
    """
    got = tdetector.resize_batch_u8(torch.from_numpy(two_frames), h_out, w_out).numpy()
    want = np.asarray(jdetector._resize_batch_u8(jnp.asarray(two_frames), h_out, w_out))
    assert got.shape == want.shape == (2, h_out, w_out)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 5e-4, int((diff > 0).sum())


@pytest.fixture(scope="module")
def detector_pair(cfg_dir):
    jcfg = dataclasses.replace(JDetectorConfig.from_yaml(cfg_dir / "feature_detector.yml"),
                               max_keypoints=K_CAP)
    tcfg = dataclasses.replace(TDetectorConfig.from_yaml(cfg_dir / "feature_detector.yml"),
                               max_keypoints=K_CAP)
    assert tcfg.num_levels == 4 and tcfg.scale_factor == 1.2
    return jdetector.FeatureDetector(jcfg), tcfg


@pytest.fixture(scope="module")
def jax_pyramid(detector_pair, two_frames):
    jk, jdesc = detector_pair[0].detect_and_compute_batch(jnp.asarray(two_frames))
    return jax.tree.map(np.asarray, jk), np.asarray(jdesc)


@pytest.mark.parametrize("nms_fused", [False, True])
def test_pyramid_detector_matches_reference(monkeypatch, detector_pair, jax_pyramid,
                                            two_frames, nms_fused):
    """Given the reference's level images, keypoints and descriptors are bit-exact.

    With ``nms_fused`` every level takes the fused path (its capacity is
    below its tile count) and the result is the same.  Angles agree to 1e-4
    deg (atan2 is a libm call in each framework; measured: equal) on all but
    one of the 1024 keypoints, and to 5e-3 on that one: the reference's CPU
    blur is FMA-contracted by XLA and rounds a sum within an ulp of .5 the
    other way from its own Pallas kernel, which the port follows
    (``test_torch_brief.py``).  On level 1 of frame 0 one such pixel,
    (y, x) = (64, 765), lies in the patch of the keypoint at (773, 71): its
    intensity moment moves by one pixel's weight, its angle by 4.0e-3 deg,
    and its descriptor stays the same.
    """
    monkeypatch.setattr(tdetector, "resize_batch_u8", _jax_resize)
    det = tdetector.FeatureDetector(detector_pair[1], device="cpu", nms_fused=nms_fused)
    levels = det._feasible_levels(*two_frames.shape[-2:])
    assert [(h, w) for _, h, w in levels[1:]] == LEVEL_SHAPES
    assert all(det._fused_nms_ok(h, w, 68) == nms_fused for _, h, w in levels)
    tk, tdesc = det.detect_and_compute_batch(torch.from_numpy(two_frames))
    jk, jdesc = jax_pyramid
    assert tk.xy.shape == (2, K_CAP, 2) and int(jk.valid.sum()) > 600
    assert (np.asarray(jk.xy) % 1 != 0).any()  # upper levels mapped back to level 0
    np.testing.assert_array_equal(tk.xy.numpy(), jk.xy)
    np.testing.assert_array_equal(tk.response.numpy(), jk.response)
    np.testing.assert_array_equal(tk.valid.numpy(), jk.valid)
    np.testing.assert_array_equal(tdesc.numpy(), jdesc)
    angle_err = np.abs(tk.angle.numpy() - jk.angle)
    assert angle_err.max() <= 5e-3 and (angle_err > 1e-4).sum() <= 1, np.sort(angle_err.ravel())[-3:]


def _jax_draws(frame_idx, n_valid, H, S):
    key = jax.random.fold_in(jax.random.PRNGKey(0), frame_idx)
    return np.array(jax.random.randint(key, (H, S), 0, jnp.maximum(jnp.int32(int(n_valid)), 1)))


def _small(cfg):
    return dataclasses.replace(
        cfg,
        detector=dataclasses.replace(cfg.detector, max_keypoints=K_CAP),
        pose=dataclasses.replace(cfg.pose, num_hypotheses=H_HYP),
    )


@pytest.fixture(scope="module")
def pipeline_runs(cfg_dir, data_dir):
    """The reference pipeline and the port's (fused NMS), the latter with both resizes."""
    batches = list(FrameStream(data_dir / "images").batches(BATCH))
    jp = JPipeline(JCamera.from_yaml(cfg_dir / "camera.yml"),
                   _small(JSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)))
    want = jp.run(iter(batches), seed=0)
    tp = tslam.SlamPipeline(
        TCamera.from_yaml(cfg_dir / "camera.yml"),
        _small(TSlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)),
        device="cpu", draw_fn=_jax_draws, nms_fused=True,
    )
    own = tp.run(iter(batches), seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdetector, "resize_batch_u8", _jax_resize)
        injected = tp.run(iter(batches), seed=0)
    return want, injected, own


def test_pyramid_vo_matches_reference(pipeline_runs):
    """With the reference's level images: the single-level VO tolerances (``test_torch_slam.py``).

    Identical matches and ``pose_ok``, inliers ±2, rotations 1e-4,
    positions 1e-3.
    """
    want, got, _ = pipeline_runs
    np.testing.assert_array_equal(got["num_matches"], want["num_matches"])
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    assert got["pose_ok"][1:].all()
    assert np.all(np.abs(got["num_inliers"].astype(int) - want["num_inliers"].astype(int)) <= 2)
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], atol=1e-3)
    assert got["poses"][-1, 2, 3] > 5.0  # forward motion along +z
    assert got["state"].frame_idx == 10


def test_pyramid_vo_own_resize_close_to_reference(pipeline_runs):
    """With the port's own resize: ``pose_ok`` identical, matches ±2, the other tolerances as above.

    Measured on the 10 fixtures: the ±1 gray-level resize differences
    (``test_resize_close_to_jax``) move no keypoint that matters — matches,
    inliers and ``pose_ok`` identical, rotations within 5.4e-7, positions
    within 3.8e-4, the same as with the reference's level images.  The
    asserted envelope keeps ±2 matches of room for the resize.
    """
    want, _, got = pipeline_runs
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    assert np.all(np.abs(got["num_matches"].astype(int) - want["num_matches"].astype(int)) <= 2)
    assert np.all(np.abs(got["num_inliers"].astype(int) - want["num_inliers"].astype(int)) <= 2)
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], atol=1e-3)
