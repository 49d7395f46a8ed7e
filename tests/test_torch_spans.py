"""The port's span recorder (``tpuslam_torch/utils/profiling.py``) and the VO step's spans, on the CPU.

One ``SlamPipeline.process_chunks`` step of two sequences at a small
configuration (K 512, 256 hypotheses, 3 frames a sequence), on the single
level and on the ``configs/multiscale`` pyramid (4 levels, kernel 5's plain
twin), runs once with no profiler and once under ``torch.profiler`` (CPU
activity).  Recorded, the step is exactly the ``vo.step`` tree with one
``detect.*`` set a level; each in-memory span agrees with its
``record_function`` event of the same session within 1 ms; the outputs are
the same bits either way; the benchmark's seven span readers read it, the
six host-ms ones summing to ``vo.step``, and the sync count is None (not
measured) on the CPU.  With no profiler the recorder holds nothing and a
span is the shared do-nothing context; the log keeps its last steps only;
a count lands on the innermost span; a step that raises leaves the
recorder closed.  The card's sync counter is held in
``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.core.cell import metric_reader
from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.tools.profile_stages import fixture_chunk
from tpuslam_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
SEQ, B = 2, 3
TOP = ["vo.upload", "vo.undistort", "vo.detect", "vo.match", "vo.draws", "vo.pose", "vo.triangulate", "vo.chain"]
POSE = ["pose.hypotheses", "pose.msac", "pose.lo", "pose.cheirality"]
READERS = ["detect_host_ms", "match_host_ms", "draws_host_ms", "pose_host_ms", "chain_host_ms",
           "step_rest_host_ms"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipeline(cfg: str) -> SlamPipeline:
    cfg_dir = REPO / "configs" / cfg
    c = SlamConfig.from_yaml_dir(cfg_dir, batch_size=B)
    c = dataclasses.replace(c, detector=dataclasses.replace(c.detector, max_keypoints=512),
                            pose=dataclasses.replace(c.pose, num_hypotheses=256))
    return SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"), c, device="cpu", nms_fused=bool(cfg))


@pytest.fixture(scope="module", params=["", "multiscale"], ids=["single", "pyramid"])
def runs(request):
    """The same step with no profiler and under one; the recorded step and the session's events."""
    pipe = _pipeline(request.param)
    chunk = fixture_chunk(SEQ * B)
    frames = torch.from_numpy(chunk).reshape(SEQ, B, *chunk.shape[1:])
    valid = torch.ones((SEQ, B), dtype=torch.bool)
    states = [pipe.initial_state() for _ in range(SEQ)]
    before = list(profiling.RECORDER.steps)
    off = pipe.process_chunks(frames, valid, states, [7, 8])
    unrecorded = list(profiling.RECORDER.steps) == before
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = pipe.process_chunks(frames, valid, states, [7, 8])
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    return {"levels": pipe.config.detector.num_levels, "off": off, "on": on, "step": profiling.RECORDER.steps[-1],
            "events": events, "unrecorded": unrecorded}


def _tree(step) -> list[tuple[str, str | None]]:
    return [(s.name, None if s.parent is None else step.spans[s.parent].name) for s in step.spans]


def test_step_records_the_span_tree(runs):
    step, levels = runs["step"], runs["levels"]
    assert step.name == "vo.step" and step.meta == {"S": SEQ, "B": B} and step.counters == {}
    detect = []
    for level in range(levels):
        detect += ([("detect.resize", "vo.detect")] if level else []) + [("detect.corners", "vo.detect"),
                                                                        ("detect.describe", "vo.detect")]
    want = ([("vo.step", None)] + [(n, "vo.step") for n in TOP[:3]] + detect + [(n, "vo.step") for n in TOP[3:6]]
            + [(n, "vo.pose") for n in POSE] + [(n, "vo.step") for n in TOP[6:]] + [("vo.split", "vo.chain")])
    assert _tree(step) == want
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in step.spans)
    assert sum(s.name == "vo.step" for s in step.spans) == 1 and step.spans[0].ns == max(s.ns for s in step.spans)
    assert [r.step_id for r in profiling.RECORDER.steps].count(step.step_id) == 1


def test_spans_agree_with_the_profiler_events(runs):
    """In-memory stamps are on the profiler's clock: each span against its ``record_function`` event."""
    step, events = runs["step"], runs["events"]
    for name in {s.name for s in step.spans}:
        mine = [(s.start_ns, s.end_ns) for s in step.spans if s.name == name]
        theirs = sorted((s, e) for n, s, e in events if n == name)
        assert len(theirs) == len(mine), name
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 1_000_000 and abs(e0 - e1) < 1_000_000, (name, s0 - s1, e0 - e1)


def test_outputs_are_the_same_bits_recorded_or_not(runs):
    assert runs["unrecorded"]
    for part in (0, 1):  # results, then carries
        for a, b in zip(runs["off"][part], runs["on"][part]):
            for x, y in zip(a, b):
                if isinstance(x, torch.Tensor):
                    assert x.dtype == y.dtype and torch.equal(x, y)
                elif isinstance(x, tuple):
                    assert all(torch.equal(u, v) for u, v in zip(x, y))
                else:
                    assert x == y


def test_span_readers_on_a_recorded_step(runs, monkeypatch):
    step = runs["step"]
    monkeypatch.setattr(profiling.RECORDER, "steps", [step])
    got = {name: metric_reader(name)({}) for name in READERS}
    assert all(v is not None and v >= 0 for v in got.values()), got
    total = step.total_ns("vo.step") / 1e6
    assert abs(sum(got.values()) - total) <= 0.01 * total
    assert got["pose_host_ms"] == step.total_ns("vo.pose") / 1e6
    assert metric_reader("host_syncs_per_step")({}) is None  # the CPU does not count syncs
    monkeypatch.setattr(profiling.RECORDER, "steps", [])
    assert all(metric_reader(name)({}) is None for name in [*READERS, "host_syncs_per_step"])


def test_off_a_span_is_the_shared_do_nothing_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened while nothing records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = profiling.StageTimer()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert rec.span("a") is rec.span("b") is rec.step("c", sync_counter="d") is profiling._OFF
    with rec.step("c"), rec.span("a"):
        rec.count("n")
    with rec.stage("s"):
        pass
    assert list(rec.steps) == [] and rec.report()["s"]["count"] == 1


def test_the_log_keeps_the_last_steps():
    rec = profiling.StageTimer()
    n = profiling.MAX_STEPS + 3
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with rec.step("t.step", i=i):
                with rec.span("t.a"):
                    pass
    kept = list(range(3, n))
    assert [s.step_id for s in rec.steps] == kept and [s.meta["i"] for s in rec.steps] == kept
    assert all(_tree(s) == [("t.step", None), ("t.a", "t.step")] for s in rec.steps)
    rec.clear()
    assert len(rec.steps) == 0


def test_counts_land_on_the_innermost_span_and_a_raising_step_closes():
    rec = profiling.StageTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        rec.count("n")  # outside a step: dropped
        with rec.step("t.step"):
            rec.count("n")
            with rec.span("t.a"):
                with rec.span("t.b"):
                    rec.count("n", 2)
                with rec.span("t.c"):
                    rec.count("n")
                with rec.step("t.inner"):  # inside a step: a span
                    pass
        with pytest.raises(ValueError), rec.step("t.fails"):
            with rec.span("t.a"):
                raise ValueError
        with rec.step("t.after"):
            pass
    first, failed, after = rec.steps
    assert first.counters == {"n": 4}
    assert [s.counts for s in first.spans] == [{"n": 1}, {}, {"n": 2}, {"n": 1}, {}]
    assert _tree(first)[-1] == ("t.inner", "t.a")
    assert all(s.end_ns is not None for s in failed.spans) and _tree(after) == [("t.after", None)]
    assert rec._current is None and rec._open == []


def test_the_profiler_stamps_the_host_on_time_ns():
    """Kineto's host stamps follow ``time.time_ns``, the clock the recorder stamps with."""
    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("clock.a", "clock.b"):
            t0 = time.time_ns()
            with torch.profiler.record_function(name):
                time.sleep(0.002)
            stamps.append((name, t0, time.time_ns()))
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("clock.")}
    for name, t0, t1 in stamps:
        e = events[name]
        assert t0 - 1_000_000 < e.start_ns() <= e.start_ns() + e.duration_ns() < t1 + 1_000_000, name
