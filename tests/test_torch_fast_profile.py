"""The ``configs/fast`` profile: tpuslam_torch against tpuslam on the CPU.

The profile differs from ``configs/`` only in ``pose_estimator.yml``
(``NumHypotheses: 512``).  Both packages read it the same way, and the VO
slice runs at the profile's own 512 hypotheses with the small shapes of
``test_torch_slam.py`` (MaxKeypoints 512, batch 4, the 10 fixtures), the
port's ``draw_fn`` replaying the reference's per-frame draws.  Bars: the VO
slice's (integer fields identical, inliers ±2, rotations 1e-4, positions
1e-3).  The port runs on one CPU thread (``one_torch_thread``).
"""

import dataclasses

import numpy as np
import pytest

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_slam import BATCH, K_CAP, _jax_draws
from tpuslam.common.camera import Camera as JCamera
from tpuslam.config.schema import SlamConfig as JSlamConfig
from tpuslam.model.slam import SlamPipeline as JPipeline
from tpuslam_torch.common.camera import Camera as TCamera
from tpuslam_torch.config.schema import SlamConfig as TSlamConfig
from tpuslam_torch.model import slam as tslam
from tpuslam_torch.pre.stream import FrameStream


@pytest.fixture(scope="module")
def fast_dir(data_dir):
    return data_dir.parent.parent / "configs" / "fast"


def test_fast_profile_reads_512_hypotheses_in_both_packages(fast_dir):
    """The profile's configs equal the reference's field for field and differ from configs/ only in NumHypotheses."""
    t = TSlamConfig.from_yaml_dir(fast_dir)
    j = JSlamConfig.from_yaml_dir(fast_dir)
    assert t.pose.num_hypotheses == j.pose.num_hypotheses == 512
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    default = TSlamConfig.from_yaml_dir(fast_dir.parent)
    assert default.pose.num_hypotheses == 1024
    assert dataclasses.replace(t, pose=dataclasses.replace(t.pose, num_hypotheses=1024)) == default


def _small(cfg):
    return dataclasses.replace(cfg, detector=dataclasses.replace(cfg.detector, max_keypoints=K_CAP))


def test_fast_slice_matches_reference(fast_dir, data_dir):
    batches = list(FrameStream(data_dir / "images").batches(BATCH))
    jp = JPipeline(JCamera.from_yaml(fast_dir / "camera.yml"),
                   _small(JSlamConfig.from_yaml_dir(fast_dir, batch_size=BATCH)))
    want = jp.run(iter(batches), seed=0)
    tp = tslam.SlamPipeline(TCamera.from_yaml(fast_dir / "camera.yml"),
                            _small(TSlamConfig.from_yaml_dir(fast_dir, batch_size=BATCH)),
                            device="cpu", draw_fn=_jax_draws)
    assert tp.config.pose.num_hypotheses == 512
    got = tp.run(iter(batches), seed=0)
    np.testing.assert_array_equal(got["num_matches"], want["num_matches"])
    np.testing.assert_array_equal(got["pose_ok"], want["pose_ok"])
    assert got["pose_ok"][1:].all()
    assert np.all(np.abs(got["num_inliers"].astype(int) - want["num_inliers"].astype(int)) <= 2)
    np.testing.assert_allclose(got["poses"][:, :3, :3], want["poses"][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["poses"][:, :3, 3], want["poses"][:, :3, 3], atol=1e-3)
    assert got["poses"][-1, 2, 3] > 5.0  # forward motion along +z
