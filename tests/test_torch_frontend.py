"""tpuslam_torch's frontend against tpuslam on the CPU.

Kernel 1's and kernel 5's plain twins against ``fused_frontend_batch`` and
``fused_frontend_nms_batch`` run in Pallas interpret mode (the
``pl.pallas_call`` patch of ``test_pallas_frontend.py``), keypoint
selection against the reference, and the whole detector batch (keypoints
and descriptors) against the reference's CPU quantised path.  All integer
stages are compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.config.schema import DetectorConfig as JDetectorConfig
from tpuslam.frontend import fast as jfast
from tpuslam.frontend.detector import FeatureDetector as JDetector
from tpuslam_torch.config.schema import DetectorConfig as TDetectorConfig
from tpuslam_torch.frontend import fast as tfast
from tpuslam_torch.frontend.brief import gaussian_kernel
from tpuslam_torch.frontend.detector import FeatureDetector as TDetector
from tpuslam_torch.kernels.frontend import (
    fused_frontend_batch,
    fused_frontend_nms_batch,
    fused_frontend_nms_reference,
    fused_frontend_reference,
)


@pytest.fixture(scope="module")
def crop(kitti_frames):
    return np.ascontiguousarray(kitti_frames[0][100:400, 300:1000])


@pytest.fixture(scope="module")
def taps():
    return torch.from_numpy(gaussian_kernel().astype(np.float32))


def _pallas_interpret(fn_name: str, crop: np.ndarray, **kw) -> tuple[np.ndarray, ...]:
    """Run a Pallas frontend kernel of the reference in interpret mode on one crop."""
    from tpuslam.kernels import frontend_pallas as fp

    orig = fp.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    fp.pl.pallas_call = interp_call
    try:
        out = getattr(fp, fn_name).__wrapped__(jnp.asarray(crop)[None], **kw)
    finally:
        fp.pl.pallas_call = orig
    return tuple(np.asarray(o[0]) for o in out)


@pytest.fixture(scope="module")
def pallas_out(crop):
    return _pallas_interpret("fused_frontend_batch", crop, threshold=20, contiguous=12)


def test_kernel1_twin_bit_exact_with_pallas(crop, taps, pallas_out):
    blur, corner, score = fused_frontend_batch(
        torch.from_numpy(crop)[None], threshold=20, contiguous=12, taps=taps
    )
    np.testing.assert_array_equal(blur[0].numpy(), pallas_out[0])
    np.testing.assert_array_equal(corner[0].numpy(), pallas_out[1])
    # Zero padding on both sides: the score agrees at every pixel.
    np.testing.assert_array_equal(score[0].numpy(), pallas_out[2])


@pytest.mark.parametrize("window", [5, 12, 14])
def test_kernel5_twin_bit_exact_with_pallas(crop, taps, window):
    """Kernel 5's twin: blur and post-NMS key plane equal the Pallas kernel's, bit for bit."""
    want_blur, want_key = _pallas_interpret(
        "fused_frontend_nms_batch", crop, threshold=20, contiguous=12, window=window
    )
    blur, key = fused_frontend_nms_batch(
        torch.from_numpy(crop)[None], threshold=20, contiguous=12, window=window, taps=taps
    )
    assert key.dtype == torch.int64 and want_key.dtype == np.uint32
    assert int((key > 0).sum()) > 50
    np.testing.assert_array_equal(key[0].numpy(), want_key.astype(np.int64))
    np.testing.assert_array_equal(blur[0].numpy(), want_blur)


def test_kernel5_wrapper_on_cpu_is_the_twin(crop, taps):
    x = torch.from_numpy(np.stack([crop, crop[::-1].copy()]))
    args = dict(threshold=20, contiguous=9, window=12, taps=taps)
    for u, v in zip(fused_frontend_nms_batch(x, **args), fused_frontend_nms_reference(x, **args)):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="window"):
        fused_frontend_nms_batch(x, threshold=20, contiguous=9, window=15, taps=taps)


@pytest.mark.parametrize("window,max_kp", [(12, 256), (5, 64)])
def test_select_from_key_matches(crop, window, max_kp):
    """The top-k over a post-NMS key plane equals the reference's and the port's select_keypoints."""
    corner, score = jfast.fast_response_and_mask(jnp.asarray(crop), 20, 12)
    jkey = jfast._packed_key(score, jfast.local_max_nms(corner, score, window))
    want = jfast.select_from_key(jkey, window=window, max_keypoints=max_kp)
    key = torch.from_numpy(np.asarray(jkey).astype(np.int64))[None]
    got = tfast.select_from_key(key, window=window, max_keypoints=max_kp)
    direct = tfast.select_keypoints(
        torch.from_numpy(np.array(corner))[None], torch.from_numpy(np.array(score))[None],
        nms=True, window=window, max_keypoints=max_kp,
    )
    assert int(np.asarray(want.valid).sum()) > 0
    for field in ("xy", "response", "valid"):
        np.testing.assert_array_equal(getattr(got, field)[0].numpy(), np.asarray(getattr(want, field)))
        assert torch.equal(getattr(got, field), getattr(direct, field)), field


def test_kernel1_wrapper_on_cpu_is_the_twin(crop, taps):
    x = torch.from_numpy(np.stack([crop, crop[::-1].copy()]))
    a = fused_frontend_batch(x, threshold=20, contiguous=12, taps=taps)
    b = fused_frontend_reference(x, threshold=20, contiguous=12, taps=taps)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("threshold,contiguous", [(300, 9), (20, 0)])
def test_kernel_limits_bind_only_on_the_card(crop, taps, threshold, contiguous):
    """A threshold or run length outside the kernels' u8/16-pixel limits still runs the CPU twins."""
    x = torch.from_numpy(np.ascontiguousarray(crop[:64, :96]))[None]
    args = dict(threshold=threshold, contiguous=contiguous, taps=taps)
    for u, v in zip(fused_frontend_batch(x, **args), fused_frontend_reference(x, **args)):
        assert torch.equal(u, v)
    for u, v in zip(fused_frontend_nms_batch(x, window=5, **args),
                    fused_frontend_nms_reference(x, window=5, **args)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("contiguous", [9, 12])
def test_fast_matches_reference_stencil(crop, contiguous):
    """Corners equal the reference's mask_run formulation; score equal at corners."""
    corner, score = tfast.fast_response_and_mask(torch.from_numpy(crop)[None], 20, contiguous)
    jc, js = jfast.fast_response_and_mask(jnp.asarray(crop), 20, contiguous)
    np.testing.assert_array_equal(corner[0].numpy(), np.asarray(jc))
    ys, xs = np.nonzero(np.asarray(jc))
    assert len(ys) > 100
    np.testing.assert_array_equal(score[0].numpy()[ys, xs], np.asarray(js)[ys, xs])


@pytest.mark.parametrize("window,max_kp", [(12, 256), (5, 64)])
def test_select_keypoints_matches(crop, window, max_kp):
    corner, score = jfast.fast_response_and_mask(jnp.asarray(crop), 20, 12)
    want = jfast.select_keypoints(corner, score, nms=True, window=window, max_keypoints=max_kp)
    got = tfast.select_keypoints(
        torch.from_numpy(np.array(corner))[None],
        torch.from_numpy(np.array(score))[None],
        nms=True, window=window, max_keypoints=max_kp,
    )
    np.testing.assert_array_equal(got.xy[0].numpy(), np.asarray(want.xy))
    np.testing.assert_array_equal(got.response[0].numpy(), np.asarray(want.response))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))


def test_local_max_nms_matches(crop):
    corner, score = jfast.fast_response_and_mask(jnp.asarray(crop), 20, 12)
    want = np.asarray(jfast.local_max_nms(corner, score, 12))
    got = tfast.local_max_nms(
        torch.from_numpy(np.array(corner))[None], torch.from_numpy(np.array(score))[None], 12
    )
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.fixture(scope="module")
def detector_pair(data_dir):
    cfg = data_dir.parent.parent / "configs" / "feature_detector.yml"
    jcfg = dataclasses.replace(JDetectorConfig.from_yaml(cfg), max_keypoints=512)
    tcfg = dataclasses.replace(TDetectorConfig.from_yaml(cfg), max_keypoints=512)
    return JDetector(jcfg), TDetector(tcfg, device="cpu")


def test_detector_batch_matches_reference(kitti_frames, detector_pair):
    """Keypoints and descriptors bit-exact with the reference's CPU path on full frames."""
    jd, td = detector_pair
    frames = np.stack(kitti_frames[:2])
    jk, jdesc = jax.jit(jd.detect_and_compute_batch)(jnp.asarray(frames))
    tk, tdesc = td.detect_and_compute_batch(torch.from_numpy(frames))
    assert int(np.asarray(jk.valid).sum()) > 600
    np.testing.assert_array_equal(tk.xy.numpy(), np.asarray(jk.xy))
    np.testing.assert_array_equal(tk.response.numpy(), np.asarray(jk.response))
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jk.valid))
    # atan2 is a libm call in each framework: allow float32 rounding.
    np.testing.assert_allclose(tk.angle.numpy(), np.asarray(jk.angle), atol=1e-4)
    np.testing.assert_array_equal(tdesc.numpy(), np.asarray(jdesc))


def test_detector_rejects_unported_options(data_dir):
    cfg = TDetectorConfig()
    with pytest.raises(NotImplementedError, match="BriefQuantizedBins"):
        TDetector(dataclasses.replace(cfg, brief_quantized_bins=0), device="cpu")
