"""The port's stage profiles (``tpuslam_torch/tools/profile_stages.py``, ``profile_slam.py``) on the CPU.

Both run at the small shapes (K 512, 256 two-view hypotheses) and return
every named stage with a finite time: the span table of one VO step of 10
fixture frames with ``configs/`` and of 4 with ``configs/multiscale``
(kernel 5's level spans, through its plain twin), each span of the step's
own ``vo.step`` tree; and the stages of full SLAM over 10 frames in VO and
PnP mode and of localization against the PnP run's map (batch 5, the tree
vocabulary; the frozen run relocalizes its first frame).  No time here is
a device time: the device fields are None.  The span table's reduction of
device rows (each launch booked to the innermost span its launch call ran
in, by correlation id; idle gaps by their middle) is held on a few
synthetic profiler events.
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

SPANS = ["vo.step", "vo.upload", "vo.undistort", "vo.detect", "detect.corners", "detect.describe", "vo.match",
         "vo.draws", "vo.pose", "pose.hypotheses", "pose.msac", "pose.lo", "pose.cheirality", "vo.triangulate",
         "vo.chain", "vo.split"]


@pytest.mark.parametrize("cfg", ["", "multiscale"])
def test_profile_stages_on_the_cpu(data_dir, cfg):
    cfg_dir = data_dir.parent.parent / "configs" / cfg
    batch = 4 if cfg else 10
    pipeline = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"),
                            _small(SlamConfig.from_yaml_dir(cfg_dir, batch_size=batch)), device="cpu",
                            nms_fused=bool(cfg))
    report = profile_stages.profile_stages(pipeline, torch.from_numpy(profile_stages.fixture_chunk(batch))[None])
    rows = {r["span"]: r for r in report["spans"]}
    want = SPANS if not cfg else SPANS[:6] + ["detect.resize"] + SPANS[6:]
    assert list(rows) == want
    levels = 4 if cfg else 1
    assert rows["detect.corners"]["calls"] == rows["detect.describe"]["calls"] == levels
    assert rows.get("detect.resize", {"calls": 0})["calls"] == levels - 1
    for r in report["spans"]:
        assert r["calls"] >= 1 and math.isfinite(r["host_ms"]) and r["host_ms"] >= r["self_ms"] >= 0
        assert r["launches"] is None and r["device_ms"] is None and r["idle_ms"] is None and r["syncs"] is None
        kernel_span = r["span"] in ("detect.corners", "detect.describe", "pose.msac", "pose.hypotheses", "pose.lo",
                                    "pose.cheirality", "vo.triangulate")
        assert (r["bound_us"] is not None and r["bound_us"] > 0) == kernel_span
    assert abs(sum(r["self_ms"] for r in report["spans"]) - report["step_ms"]) < 1e-6 * report["step_ms"] + 1e-9
    assert report["host_syncs"] is None and report["launches"] is None and report["device_ms"] is None
    assert report["batch"] == batch and report["sequences"] == 1 and "pose.msac" in profile_stages.format_table(report)


class _Event:
    """The few fields of a profiler event that the span table reads."""

    def __init__(self, name, start, end, corr, device=False, annotation=False):
        self._v = (name, start, end, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[5]


def test_span_table_books_device_rows_to_spans():
    """Two launches from ``vo.pose`` (one of them kernel 4), one from ``vo.step`` itself, one launched
    before the step and one never linked; idle gaps by their middle."""
    from tpuslam_torch.utils.profiling import SpanRecord, StepRecord

    step = StepRecord(0, "vo.step", {})
    for name, parent, (s, e) in (("vo.step", None, (0, 100)), ("vo.pose", 0, (10, 50)), ("pose.msac", 1, (20, 30))):
        step.spans.append(SpanRecord(name, parent, s))
        step.spans[-1].end_ns = e
    step.spans[2].counts["vo.host_syncs"] = 1
    step.counters["vo.host_syncs"] = 1
    events = [
        _Event("cudaLaunchKernel", 12, 13, 1),
        _Event("cudaLaunchKernel", 22, 23, 2),
        _Event("cudaMemcpyAsync", 60, 61, 3),
        _Event("cudaLaunchKernel", -5, -4, 4),
        _Event("aten::mul", 12, 14, 1),  # an operator whose own id is a launch's: not a launch call
        _Event("void mul_kernel<float>(float*)", 15, 25, 1, device=True),
        _Event("void msac_kernel<128>(float const*)", 25, 45, 2, device=True),
        _Event("Memcpy HtoD", 62, 70, 3, device=True),
        _Event("before", -3, 2, 4, device=True),
        _Event("unlinked", 80, 90, 99, device=True),
        _Event("vo.pose", 10, 50, 0, device=True, annotation=True),  # a GPU annotation row: not a launch
    ]
    out = profile_stages.span_table(events, step, on_card=True, bounds={"pose.msac": 2.0})
    rows = {r["span"]: r for r in out["spans"]}
    assert [rows[n]["launches"] for n in ("vo.step", "vo.pose", "pose.msac")] == [1, 1, 1]
    ms = [rows[n]["device_ms"] for n in ("vo.step", "vo.pose", "pose.msac")]
    assert ms == pytest.approx([8e-6, 10e-6, 20e-6], rel=1e-12)
    assert rows["pose.msac"]["kernel_ms"] == pytest.approx(20e-6, rel=1e-12) and rows["vo.pose"]["kernel_ms"] == 0
    assert rows["pose.msac"]["bound_share"] == pytest.approx(2e-3 / 20e-6) and rows["vo.pose"]["bound_share"] is None
    # device busy [0, 2], [15, 45], [62, 70], [80, 90] in the step's [0, 100]: the gaps [2, 15] (middle 8.5, before
    # vo.pose opens), [45, 62], [70, 80] and [90, 100] all lie in vo.step alone
    assert rows["vo.step"]["idle_ms"] == pytest.approx(50e-6, rel=1e-12) and rows["vo.pose"]["idle_ms"] == 0
    assert rows["pose.msac"]["syncs"] == 1 and out["host_syncs"] == 1
    assert out["launches"] == 3 and out["unlinked_launches"] == 1
    assert rows["vo.step"]["self_ms"] == pytest.approx(60e-6, rel=1e-12)


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
