"""The benchmark's arithmetic: rates, tails, unions of intervals, the frozen work counts and the readers."""

import json
import statistics
from types import SimpleNamespace

import pytest
import torch

from portbench.core import bounds
from portbench.core.cell import HERE, load_json, metric_reader
from portbench.core.stats import covered, gaps, percentile, rate, spread, union
from portbench.core.trace import base_name, reduce

VO = load_json(HERE / "configs" / "kitti-vo.json")["params"]
PYR = load_json(HERE / "configs" / "kitti-vo-pyramid.json")["params"]


def test_rate_is_all_work_over_all_time():
    assert rate(256 * 10, 8.0) == 320.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_p90_takes_every_step():
    steps = [100.0] * 90 + [200.0] * 10
    assert percentile(steps, 90) == pytest.approx(190.0)  # the exclusive method's 90.9th of 101 ranks
    assert percentile(steps + [1000.0] * 20, 90) == 1000.0  # a tail added moves it
    assert percentile(list(range(1, 101)), 50) == statistics.median(range(1, 101))


def test_spread_is_iqr_over_median():
    v = [10.0, 10.0, 11.0, 12.0, 12.0, 12.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_idle_share_is_a_union():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert union(iv, 0, 10) == [(0, 3), (5, 6), (9, 10)]
    assert covered(iv, 0, 10) == 5  # overlaps count once, clipped to the window
    assert gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert gaps([], 0, 1) == [(0, 1)]


def test_work_at_the_main_paths_shapes():
    """The frozen counts give the bounds the port's kernel table states at 16 frames (µs)."""
    assert bounds.frontend_work(16, 512, 1392).bound_s() * 1e6 == pytest.approx(23.83, abs=0.01)
    assert bounds.patches_work(16, 512, 1392, 1024, 31).bound_s() * 1e6 == pytest.approx(14.71, abs=0.01)
    assert bounds.dots_work(16, 1024, 256, 31, 16).bound_s() * 1e6 == pytest.approx(19.13, abs=0.01)
    assert bounds.msac_work(16, 1024, 1024).bound_s() * 1e6 == pytest.approx(24.29, abs=0.01)
    pyr4 = {**PYR, "detector": {**PYR["detector"], "num_levels": 4}}  # the table's pyramid: configs/multiscale
    k5 = bounds.step_kernels(pyr4, 16, nms_fused=True)["frontend_nms"]
    assert sum(w.bound_s() for w in k5) * 1e6 == pytest.approx(85.53, abs=0.01)


def test_step_kernels_by_cell():
    vo = bounds.step_kernels(VO, 256, nms_fused=False)
    assert {k: len(v) for k, v in vo.items()} == {"frontend": 1, "brief_patches": 1, "brief_dots": 1, "msac": 1}
    pyr = bounds.step_kernels(PYR, 256, nms_fused=True)
    assert {k: len(v) for k, v in pyr.items()} == {"frontend_nms": 8, "brief_patches": 8, "brief_dots": 8, "msac": 1}
    assert [k for *_, k in bounds.levels(PYR)] == [324, 230, 160, 111, 77, 53, 37, 32]


class Ev(SimpleNamespace):
    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.n.startswith("portbench.")


def _events():
    host = [Ev(s=0, d=1000, n="portbench.window", dev=False), Ev(s=100, d=200, n="aten::item", dev=False),
            Ev(s=500, d=300, n="aten::add", dev=False), Ev(s=550, d=50, n="cudaLaunchKernel", dev=False)]
    dev = [Ev(s=0, d=100, n="void msac_kernel(float const*)", dev=True),
           Ev(s=300, d=250, n="void ns::own_bin_kernel<16>(signed char const*)", dev=True),
           Ev(s=320, d=30, n="Memcpy DtoH (Device -> Pinned)", dev=True),
           Ev(s=850, d=100, n="void msac_kernel(float const*)", dev=True),
           Ev(s=0, d=1000, n="portbench.window", dev=True)]
    return host + dev


def test_trace_reduction():
    t = reduce(_events())
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["busy_s"] == pytest.approx(450e-9)  # 0-100, 300-550 (the copy inside it), 850-950
    assert t["launches"] == 4
    # each gap named by the innermost host operation open at its middle (200, 700, 975)
    assert t["idle"] == {"aten::item": pytest.approx(200e-9), "aten::add": pytest.approx(300e-9),
                         "host (no operation)": pytest.approx(50e-9)}
    assert base_name("void ns::own_bin_kernel<16>(signed char const*)") == "own_bin_kernel"
    assert base_name("(anonymous namespace)::msac_kernel(float const*, int)") == "msac_kernel"
    assert t["top_ops"][0][0].startswith("void ns::own_bin_kernel")


def test_readers_on_a_traced_record():
    t = reduce(_events())
    rec = {"trace": t, "traced_steps": 2, "frames_per_step": 1, "kernels": {"msac": [bounds.Work(0, 67e12 * 50e-9, 67e12)]},
           "chunk_ms": [1.0, 3.0], "dispatch_ms": [0.5], "readback_ms": [0.25], "frames": 4, "window_s": 2.0,
           "setup_s": 7.0}
    assert metric_reader("launches_per_frame")(rec) == 2.0
    assert metric_reader("device_idle_pct")(rec) == pytest.approx(55.0)
    assert metric_reader("msac_roofline")(rec) == pytest.approx(50.0)  # 2 × 50 ns of bound in 200 ns
    assert metric_reader("brief_patches_roofline")(rec) is None  # a kernel absent from the trace reads nothing
    assert metric_reader("kernel_device_pct")(rec) == pytest.approx(100.0 * 450 / 480)
    assert metric_reader("frames_per_s")(rec) == 2.0
    assert metric_reader("chunk_p50_ms")(rec) == 2.0
    rec["trace"]["ops"]["void msac_kernel(float const*)"]["count"] = 3  # three calls in two steps
    assert metric_reader("msac_roofline")(rec) is None  # calls the yardstick does not know
