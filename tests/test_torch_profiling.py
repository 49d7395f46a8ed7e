"""``tpuslam_torch.utils.profiling`` on the CPU: ``StageTimer``'s report, ``time_fn`` and a ``device_trace`` file.

``StageTimer`` is the reference's (``tpuslam/utils/profiling.py``); the
report's keys and counts are compared with the reference's own timer
driven the same way.  On the card ``time_fn`` ends in
``torch.cuda.synchronize()`` and the trace holds CUDA kernels
(``chip_smoke.py``'s ``[profiling]`` phase).
"""

import json
import time

import torch

from tpuslam.utils.profiling import StageTimer as JStageTimer
from tpuslam_torch.utils import profiling


def test_stage_timer_report_matches_reference():
    reports = []
    for timer in (profiling.StageTimer(), JStageTimer()):
        for name in ("detect", "pose", "detect"):
            with timer.stage(name):
                time.sleep(0.002)
        reports.append(timer.report())
    got, want = reports
    assert list(got) == list(want) == ["detect", "pose"]
    for k in got:
        assert set(got[k]) == set(want[k]) == {"total_s", "mean_ms", "count"}
        assert got[k]["count"] == want[k]["count"]
        assert got[k]["total_s"] >= 0.002 * got[k]["count"]
        assert abs(got[k]["mean_ms"] - 1e3 * got[k]["total_s"] / got[k]["count"]) < 1e-9


def test_stage_timer_counts_a_stage_that_raises():
    timer = profiling.StageTimer()
    try:
        with timer.stage("fails"):
            raise RuntimeError
    except RuntimeError:
        pass
    assert timer.report()["fails"]["count"] == 1


def test_time_fn_on_the_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    out = profiling.time_fn(fn, torch.ones(64, 64), warmup=2, iters=5)
    assert len(calls) == 7 and out["iters"] == 5
    assert out["total_s"] > 0 and abs(out["per_call_ms"] - out["total_s"] / 5 * 1e3) < 1e-9


def test_device_trace_writes_chrome_json(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.ones(256, 256) @ torch.ones(256, 256)
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages() is not None
