"""The port's stage profiles (``tpuslam_torch/tools/profile_stages.py``, ``profile_slam.py``) on the CPU.

Both run at the small shapes (K 512, 256 two-view hypotheses) and return
every named stage with a finite time: the profile of one VO chunk of 10
fixture frames with ``configs/`` and of 4 with ``configs/multiscale``
(kernel 5's stages, through its plain twin), each stage timed on its first
call (``reps`` 0); and the stages of full SLAM over 10 frames in VO and PnP
mode and of localization against the PnP run's map (batch 5, the tree
vocabulary; the frozen run relocalizes its first frame).  No time here is
a device time: the device fields are None.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from test_torch_system import _small
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.tools import profile_slam, profile_stages

STAGES = ["undistort", "NMS + top-k", "kernels 2-3, orientation, bits", "matching", "draws (a generator a frame)",
          "estimate_relative_pose", "triangulation", "scale and chaining"]


@pytest.mark.parametrize("cfg", ["", "multiscale"])
def test_profile_stages_on_the_cpu(data_dir, cfg):
    cfg_dir = data_dir.parent.parent / "configs" / cfg
    batch = 4 if cfg else 10
    pipeline = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"),
                            _small(SlamConfig.from_yaml_dir(cfg_dir, batch_size=batch)), device="cpu",
                            nms_fused=bool(cfg))
    report = profile_stages.profile_stages(pipeline, torch.from_numpy(profile_stages.fixture_chunk(batch)), reps=0)
    names = [r["stage"] for r in report["stages"]]
    want = STAGES if not cfg else ["undistort", "resize (3 levels)", "kernel 5 (4 levels)", "top-k"] + STAGES[2:]
    if not cfg:
        want = want[:1] + ["kernel 1 (1 level)"] + want[1:]
    assert names == want
    for r in report["stages"]:
        assert math.isfinite(r["ms"]) and r["ms"] > 0 and r["bound_us"] > 0 and r["bound_by"] in ("bytes", "operations")
    assert math.isfinite(report["chunk_ms"]) and report["busy_share"] is None and report["device_kernels"] is None
    assert report["batch"] == batch and "estimate_relative_pose" in profile_stages.format_table(report)


def test_profile_slam_on_the_cpu(data_dir):
    cfg_dir = data_dir.parent.parent / "configs"
    report = profile_slam.profile_slam(Camera.from_yaml(cfg_dir / "camera.yml"),
                                       _small(SlamConfig.from_yaml_dir(cfg_dir, batch_size=5)),
                                       cfg_dir / "vocabulary_tree.npz", profile_stages.fixture_chunk(10), "cpu",
                                       warmup=False)
    common = ["chunk", "tracker", "bow", "relocalization", "loop closure", "loop closure: the rest", "BA",
              "host fold (with the pose graph)"]
    for mode, extra in (("vo", ["map fold", "loop closure: ransac_pnp"]), ("pnp", ["loop closure: ransac_pnp"]),
                        ("localize", ["relocalization: fired", "relocalization: fired: ransac_pnp"])):
        stages = report[mode]["stages"]
        for name in common + extra:
            if mode == "localize" and name == "BA":  # a frozen map runs no BA
                assert name not in stages
                continue
            row = stages[name]
            value = row["ms"] if "ms" in row else row["ms_per_chunk"]
            assert math.isfinite(value) and value >= 0, (mode, name, row)
        assert report[mode]["chunks"] == 2 and report[mode]["frames"] == 10
    assert report["localize"]["localization_only"] and report["localize"]["stages"]["relocalization: fired"]["calls"]
    assert np.isclose(report["vo"]["stages"]["loop closure: the rest"]["ms_per_chunk"]
                      + report["vo"]["stages"]["loop closure: ransac_pnp"]["ms_per_chunk"],
                      report["vo"]["stages"]["loop closure"]["ms_per_chunk"])
    assert "localize" in profile_slam.format_table(report)
