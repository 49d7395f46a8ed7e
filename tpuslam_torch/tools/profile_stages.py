"""Where one VO step's time goes, read from the step's own spans: ``python -m tpuslam_torch.tools.profile_stages``.

The port's counterpart of ``tools/profile_stages.py``::

    python -m tpuslam_torch.tools.profile_stages [--pyramid [--levels N]] [--sequences S] [--device cuda]
                                                 [--span-cost N]

runs ``SlamPipeline.process_chunks`` on S sequences (default 1) of a chunk
of 16 KITTI fixture frames (ping-pong tiled; sequence s seeded s), once to
warm up and once under ``utils/profiling.py::device_trace``, and reduces
that trace by the spans the step records itself (the recorder's
``vo.step`` tree: nothing is run again or synchronised apart).  For each
span name, in the order the step first opens it: its calls, host ms (its
length, children included) and self ms (less its children); and, each
booked to the innermost span open where it happened, the device launches
(kernels, copies, sets) whose launch call ran inside the span with their
device ms — the profiler's link from a launch call to what it ran, their
shared correlation id —, the device's idle ms (each gap of the step's
device activity by its middle) and, on the card, the host syncs.  The
spans that run the six kernels add their bound, the least time an H100
could take for those kernels at the step's shapes (``kernels/bounds.py``:
``detect.corners`` kernel 1 or 5, ``detect.describe`` kernels 2 and 3
with every keypoint's bin in range and every bin used, ``pose.msac``
kernel 4, ``pose.hypotheses``, ``pose.lo``, ``pose.cheirality`` and
``vo.triangulate`` kernel 6), the kernels' own device ms and the bound's
share of it.  ``--pyramid`` takes ``configs/multiscale`` (4 levels) with
kernel 5, ``--levels`` another number of levels (8 is ORB-SLAM2's KITTI
pyramid).  On the CPU every time is the CPU's and the device fields are
None.

``--span-cost N`` measures what the spans cost instead: N pairs of traced
steps (under ``torch.profiler``, each ended by reading its poses to the
host) with the spans and with ``profiling.span`` and ``profiling.step``
stubbed out, in turns, and the ns a span takes with no profiler running
and inside a recorded step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]
BATCH = 16
RUNTIME = "cu"  # the name prefix of a CUDA runtime or driver call on the host (cudaLaunchKernel, cuLaunchKernel)
# the CUDA functions of the six kernels (kernel 3 launches two), as the profiler names their launches
KERNEL_FUNCTIONS = ("frontend_kernel", "frontend_nms_kernel", "extract_kernel", "bin_sort_kernel", "own_bin_kernel",
                    "msac_kernel", "jacobi_kernel")


def fixture_chunk(batch: int, directory: Path | None = None) -> np.ndarray:
    """``batch`` fixture frames, ping-pong tiled (0..9, 8..1, …) as the card's runs tile them."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(directory or REPO / "tests" / "data" / "images")
    base = stream.read_frames(list(range(stream.total_frames)))
    stream.close()
    period = 2 * (len(base) - 1)
    return base[[min(i % period, period - i % period) for i in range(batch)]]


def kernel_bounds(pipeline, frames: int, height: int, width: int) -> dict[str, float]:
    """µs: the bound of the kernels each kernel span runs in one step over ``frames`` frames."""
    from tpuslam_torch.kernels.brief import extract_patches_work, own_bin_dots_work
    from tpuslam_torch.kernels.frontend import frontend_nms_work, frontend_work
    from tpuslam_torch.kernels.jacobi import jacobi_work
    from tpuslam_torch.kernels.pose import msac_work

    det = pipeline.detector
    c = det.config
    levels = det._feasible_levels(height, width) if c.num_levels > 1 else [(0, height, width)]
    caps = det._level_capacities(levels) if c.num_levels > 1 else [c.max_keypoints]
    pose = pipeline.config.pose
    m = c.max_keypoints  # match slots a pair
    out = {"detect.corners": 0.0, "pose.msac": msac_work(frames, pose.num_hypotheses, m).bound_us(),
           # kernel 6: LO's three refits of the best 4, cheirality's 4 x 256 and triangulation's 4 x 4 systems
           "pose.lo": 3 * jacobi_work(frames * min(4, pose.num_hypotheses), m, 9, 5).bound_us(),
           "pose.cheirality": jacobi_work(frames * 4 * min(256, m), 4, 4, 4).bound_us(),
           "vo.triangulate": jacobi_work(frames * m, 4, 4, 8).bound_us()}
    if pose.sample_size == 8:  # the five-point solver takes the hypotheses' place
        out["pose.hypotheses"] = jacobi_work(frames * pose.num_hypotheses, 8, 9, 3).bound_us()
    for (_, h, w), k in zip(levels, caps):
        work = frontend_nms_work if det._fused_nms_ok(h, w, k) else frontend_work
        out["detect.corners"] += work(frames, h, w).bound_us()
        if c.brief_quantized_bins > 0:  # exact BRIEF (bins 0) runs neither kernel 2 nor 3
            bins = torch.arange(frames * k).reshape(frames, k) % c.brief_quantized_bins
            out["detect.describe"] = out.get("detect.describe", 0.0) + (
                extract_patches_work(frames, h, w, k, c.patch_size).bound_us()
                + own_bin_dots_work(bins, det.bin_weights).bound_us())
    return out


def _innermost(spans: list, t: np.ndarray) -> np.ndarray:
    """Index of the innermost of ``spans`` (opened in order, nested) open at each time of ``t``; -1
    where none is."""
    starts = np.array([s.start_ns for s in spans], dtype=np.int64)
    ends = np.array([s.end_ns for s in spans], dtype=np.int64)
    inside = (starts[None, :] <= t[:, None]) & (t[:, None] < ends[None, :])
    last = len(spans) - 1 - np.argmax(inside[:, ::-1], axis=1)
    return np.where(inside.any(axis=1), last, -1)


def span_table(events, step, on_card: bool, bounds: dict[str, float] | None = None) -> dict:
    """The step's spans with what each holds, from the profiler's events (see the module docstring)."""
    spans = step.spans
    n = len(spans)
    child_ns = [0] * n
    depth = [0] * n
    for i, s in enumerate(spans):
        if s.parent is not None:
            child_ns[s.parent] += s.ns
            depth[i] = depth[s.parent] + 1
    launches = np.zeros(n, dtype=np.int64)
    device_ns = np.zeros(n, dtype=np.int64)
    kernel_ns = np.zeros(n, dtype=np.int64)
    idle_ns = np.zeros(n, dtype=np.int64)
    unlinked = 0
    lo, hi = spans[0].start_ns, spans[0].end_ns
    if on_card:
        cuda = torch.autograd.DeviceType.CUDA
        launch_at, rows = {}, []
        for e in events:
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    rows.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                                 any(k in e.name() for k in KERNEL_FUNCTIONS)))
            elif e.name().startswith(RUNTIME):
                launch_at[e.correlation_id()] = e.start_ns()
        linked = np.array([r[2] in launch_at for r in rows], dtype=bool)
        at = np.array([launch_at.get(r[2], 0) for r in rows], dtype=np.int64)
        unlinked = int((~linked).sum())
        mine = linked & (at >= lo) & (at < hi)
        owner = _innermost(spans, at[mine])
        booked = owner >= 0
        length = np.array([r[1] - r[0] for r in rows], dtype=np.int64)[mine][booked]
        ours = np.array([r[3] for r in rows], dtype=bool)[mine][booked]
        np.add.at(launches, owner[booked], 1)
        np.add.at(device_ns, owner[booked], length)
        np.add.at(kernel_ns, owner[booked], np.where(ours, length, 0))
        busy = sorted((max(r[0], lo), min(r[1], hi)) for r in rows if r[0] < hi and r[1] > lo)
        gaps, cursor = [], lo
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < hi:
            gaps.append((cursor, hi))
        if gaps:
            mids = np.array([(s + e) // 2 for s, e in gaps], dtype=np.int64)
            owner = _innermost(spans, mids)
            np.add.at(idle_ns, owner[owner >= 0], np.array([e - s for s, e in gaps], dtype=np.int64)[owner >= 0])
    rows_out: dict[str, dict] = {}
    for i, s in enumerate(spans):
        r = rows_out.setdefault(s.name, {"span": s.name, "depth": depth[i], "calls": 0, "host_ms": 0.0,
                                         "self_ms": 0.0, "launches": 0, "device_ms": 0.0, "kernel_ms": 0.0,
                                         "idle_ms": 0.0, "syncs": 0})
        r["calls"] += 1
        r["host_ms"] += s.ns / 1e6
        r["self_ms"] += (s.ns - child_ns[i]) / 1e6
        r["launches"] += int(launches[i])
        r["device_ms"] += device_ns[i] / 1e6
        r["kernel_ms"] += kernel_ns[i] / 1e6
        r["idle_ms"] += idle_ns[i] / 1e6
        r["syncs"] += s.counts.get("vo.host_syncs", 0)
    for r in rows_out.values():
        if not on_card:
            r.update(launches=None, device_ms=None, kernel_ms=None, idle_ms=None, syncs=None)
        bound = (bounds or {}).get(r["span"])
        r["bound_us"] = bound
        r["bound_share"] = bound / 1e3 / r["kernel_ms"] if bound and r["kernel_ms"] else None
    return {"spans": list(rows_out.values()), "step_ms": spans[0].ns / 1e6,
            "launches": int(launches.sum()) if on_card else None,
            "device_ms": device_ns.sum() / 1e6 if on_card else None,
            "idle_ms": idle_ns.sum() / 1e6 if on_card else None,
            "host_syncs": step.counters.get("vo.host_syncs"), "unlinked_launches": unlinked if on_card else None}


def profile_stages(pipeline, frames: torch.Tensor) -> dict:
    """The span table of one ``process_chunks`` step of (S, B, H, W) uint8 ``frames`` on the pipeline's
    device (VO mode), after one warm-up step."""
    S, B, H, W = frames.shape
    frames = frames.to(pipeline.device)
    valid = torch.ones((S, B), dtype=torch.bool)  # a host mask, as the callers pass it
    states = [pipeline.initial_state() for _ in range(S)]
    seeds = list(range(S))
    pipeline.process_chunks(frames, valid, states, seeds)
    with tempfile.TemporaryDirectory(prefix="profile_stages_") as tmp:
        with profiling.device_trace(tmp) as prof:
            pipeline.process_chunks(frames, valid, states, seeds)
        events = prof.profiler.kineto_results.events()
    step = profiling.RECORDER.steps[-1]
    if step.name != "vo.step":
        raise RuntimeError(f"the recorder's last step is {step.name!r}, not the VO step")
    on_card = pipeline.device.type == "cuda"
    table = span_table(events, step, on_card, kernel_bounds(pipeline, S * B, H, W))
    return {"device": str(pipeline.device), "sequences": S, "batch": B, "frame_shape": [H, W],
            "levels": pipeline.config.detector.num_levels, "step_id": step.step_id, **table}


def span_cost(pipeline, frames: torch.Tensor, pairs: int, reps: int = 100_000) -> dict:
    """Host ms of traced steps of (S, B, H, W) ``frames`` with their spans and without them, in turns
    (on, off, off, on, ...) after a warm-up step, and ns a span costs with no profiler and inside a
    recorded step (mean of ``reps``)."""
    from torch.profiler import ProfilerActivity, profile

    S, B = frames.shape[:2]
    frames = frames.to(pipeline.device)
    valid = torch.ones((S, B), dtype=torch.bool)
    states = [pipeline.initial_state() for _ in range(S)]
    seeds = list(range(S))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if pipeline.device.type == "cuda" else [])

    def traced(spans: bool) -> float:
        saved = profiling.span, profiling.step
        if not spans:
            profiling.span = profiling.step = lambda *args, **kwargs: profiling._OFF
        try:
            with profile(activities=activities):
                t0 = time.perf_counter()
                results, _ = pipeline.process_chunks(frames, valid, states, seeds)
                torch.stack([r.poses for r in results]).cpu()
                return 1e3 * (time.perf_counter() - t0)
        finally:
            profiling.span, profiling.step = saved

    pipeline.process_chunks(frames, valid, states, seeds)
    on, off = [], []
    for i in range(pairs):
        for spans in ((True, False) if i % 2 == 0 else (False, True)):
            (on if spans else off).append(traced(spans))

    def ns_a_span(rec: profiling.StageTimer) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            with rec.span("vo.cost"):
                pass
        return (time.perf_counter_ns() - t0) / reps

    spans_a_step = len(profiling.RECORDER.steps[-1].spans)
    off_ns = ns_a_span(profiling.RECORDER)
    rec = profiling.StageTimer()
    with profile(activities=activities), rec.step("vo.cost"):
        on_ns = ns_a_span(rec)
    return {"traced_ms_spans_on": on, "traced_ms_spans_off": off, "median_on_ms": float(np.median(on)),
            "median_off_ms": float(np.median(off)), "span_off_ns": off_ns, "span_on_ns": on_ns,
            "spans_a_step": spans_a_step, "off_us_a_step": off_ns * spans_a_step / 1e3,
            "on_us_a_step": on_ns * spans_a_step / 1e3}


def format_table(report: dict) -> str:
    def num(v, fmt):
        width = int("".join(ch for ch in fmt.split(".")[0] if ch.isdigit()) or 0)
        return "n/m".rjust(width) if v is None else format(v, fmt)

    lines = [f"{'span':24s} {'calls':>5s} {'host ms':>9s} {'self ms':>9s} {'launches':>8s} {'device ms':>9s} "
             f"{'kernel ms':>9s} {'idle ms':>8s} {'syncs':>5s} {'bound µs':>9s} {'share':>7s}"]
    for r in report["spans"]:
        share = "" if r["bound_share"] is None else f"{100 * r['bound_share']:.2f}%"
        lines.append(f"{'  ' * r['depth'] + r['span']:24s} {r['calls']:5d} {r['host_ms']:9.3f} {r['self_ms']:9.3f} "
                     f"{num(r['launches'], '8d')} {num(r['device_ms'], '9.3f')} {num(r['kernel_ms'], '9.3f')} "
                     f"{num(r['idle_ms'], '8.3f')} "
                     f"{num(r['syncs'], '5d')} {num(r['bound_us'], '9.2f')} {share:>7s}")
    lines.append(f"step {report['step_id']}: {report['sequences']} x {report['batch']} frames on {report['device']}, "
                 f"{report['step_ms']:.3f} ms host, launches {report['launches']}, device ms "
                 f"{num(report['device_ms'], '.3f')}, idle ms {num(report['idle_ms'], '.3f')}, host syncs "
                 f"{report['host_syncs']}, launches not linked to a call {report['unlinked_launches']} "
                 "(n/m: not measured)")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pyramid", action="store_true", help="configs/multiscale with kernel 5 (nms_fused)")
    parser.add_argument("--levels", type=int, help="pyramid levels in place of the configuration's")
    parser.add_argument("--sequences", type=int, default=1, help="sequences in the step (default 1)")
    parser.add_argument("--device", default="cuda", help="the card (default) or cpu")
    parser.add_argument("--span-cost", type=int, metavar="N", help="time N pairs of traced steps, spans on and off")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: the profile runs on the card (--device cpu to run it on the CPU)")
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline

    cfg_dir = REPO / "configs" / ("multiscale" if args.pyramid else "")
    config = SlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH)
    if args.levels:
        config = dataclasses.replace(config, detector=dataclasses.replace(config.detector, num_levels=args.levels))
    pipeline = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"), config, device=args.device,
                            nms_fused=args.pyramid)
    chunk = torch.from_numpy(fixture_chunk(BATCH))[None].repeat(args.sequences, 1, 1, 1)
    if args.span_cost:
        print(json.dumps(span_cost(pipeline, chunk, args.span_cost)))
        return 0
    report = profile_stages(pipeline, chunk)
    print(format_table(report))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
