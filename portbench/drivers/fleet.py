"""The fleet traffic's closed loop: S recorded drives through the port's batched VO step.

Each step hands the step one chunk of B frames of every sequence, gathered
on the card from a bank of the drives' frames (one exposure a sequence),
as one ``SlamPipeline.process_chunks`` call with a host validity mask, and
reads that step's poses back to the host before the next step starts, as
a caller that writes each chunk's trajectory out would.  Every sequence
runs on for the whole window, carrying its state.

Set-up: the port's pipeline from the configuration's directory (checked
against the configuration's file), the frames decoded by the benchmark's
own PNG decoder, the bank on the card, and ``warmup_steps`` steps of the
cell's own shape.  With ``trace``, ``trace_steps`` more steps follow the
window under the profiler, inside a ``WINDOW`` span; the window's host
spans, which never carry the profiler's cost, feed the host-clock readers.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import numpy as np
import torch

from portbench.core import bounds
from portbench.core.cell import ROOT, Cell, frame_paths
from portbench.core.png import decode_gray8
from portbench.core.traffic import exposure_bank, fleet_plan
from portbench.core.vo_check import Reservoir, Sample, compare


def _check_stated(config, camera, params: dict) -> None:
    """The configuration as the port loads it has to be the one the configuration's file states."""
    stated = {
        **{f"detector.{k}": v for k, v in params["detector"].items()},
        **{f"matcher.{k}": v for k, v in params["matcher"].items()},
        **{f"pose.{k}": v for k, v in params["pose"].items()},
        **{f"map.{k}": v for k, v in params["map"].items()},
        "batch_size": params["batch_size"],
    }
    for key, want in stated.items():
        obj = config
        for part in key.split("."):
            obj = getattr(obj, part)
        if obj != want:
            raise ValueError(f"the port loads {key} = {obj!r}; the configuration's file states {want!r}")
    cam = params["camera"]
    if (camera.width, camera.height) != (cam["width"], cam["height"]) or not (
            np.allclose(camera.K.reshape(-1), cam["K"], rtol=0, atol=0)
            and np.allclose(camera.D.reshape(-1), cam["D"], rtol=0, atol=0)):
        raise ValueError("the port's camera is not the one the configuration's file states")


def port_pipeline(cell: Cell, device: str):
    """The system under test: the port's ``SlamPipeline`` on the configuration's directory, with the
    settings the configuration's ``overrides`` give each group (``{"detector": {"num_levels": 8}}``)."""
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline

    p = cell.params
    cfg_dir = ROOT / cell.config["config_dir"]
    config = SlamConfig.from_yaml_dir(cfg_dir, batch_size=p["batch_size"])
    for group, values in cell.config.get("overrides", {}).items():
        config = dataclasses.replace(config, **{group: dataclasses.replace(getattr(config, group), **values)})
    camera = Camera.from_yaml(cfg_dir / "camera.yml")
    _check_stated(config, camera, p)
    return SlamPipeline(camera, config, device=device, with_features=True, nms_fused=cell.config["nms_fused"])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        steps: int | None = None, make_pipeline: Callable = port_pipeline, log: Callable = print,
        check: bool = True) -> dict:
    """One run of the cell: set-up, the window (``seconds``, or exactly ``steps`` steps), the check
    (``check=False`` leaves it out, for sweeps of the step alone)."""
    tp = cell.workload["params"]
    S, B = tp["sequences"], tp["chunk_frames"]
    if B != cell.params["batch_size"]:
        raise ValueError("a step's chunk is the configuration's batch_size")
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as the configuration states
    torch.backends.cudnn.allow_tf32 = False

    t_pipe = time.perf_counter()
    pipe = make_pipeline(cell, device)
    t_frames = time.perf_counter()
    frames = torch.from_numpy(np.stack([decode_gray8(p) for p in frame_paths(cell.config)])).to(device)
    plan = fleet_plan(tp, frames.shape[0], seed)
    bank = exposure_bank(frames, plan.gains)
    table = torch.from_numpy(plan.chunk_table()).to(device)
    seeds = list(plan.seeds)
    valid = torch.ones((S, B), dtype=torch.bool)  # a host mask: the step reads no device value for it

    def frames_of(k: int, last: bool = False) -> torch.Tensor:
        f = bank[table[k % table.shape[0]]]
        return f[:, -1] if last else f

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    t_warm = time.perf_counter()
    for k in range(tp["warmup_steps"]):  # every shape of the window, built and warmed
        states = [pipe.initial_state() for _ in range(S)] if k == 0 else states
        results, states = pipe.process_chunks(frames_of(k), valid, states, seeds)
        torch.stack([r.poses for r in results]).cpu()
    del results, states
    sync()
    log(f"[setup] to the pipeline {t_pipe - t_start:.3f} s, pipeline {t_frames - t_pipe:.3f} s, frames and bank "
        f"{t_warm - t_frames:.3f} s, {tp['warmup_steps']} warm-up steps {time.perf_counter() - t_warm:.3f} s")

    reservoir = Reservoir(size=tp["sample_steps"], seed=seed)
    spans = {"chunk_ms": [], "dispatch_ms": [], "readback_ms": []}
    states = [pipe.initial_state() for _ in range(S)]
    k = 0

    def step() -> None:
        """Step k: the call, then its poses on the host; its three host spans."""
        nonlocal k, states
        x = frames_of(k)
        t0 = time.perf_counter()
        results, new_states = pipe.process_chunks(x, valid, states, seeds)
        t1 = time.perf_counter()
        poses = torch.stack([r.poses for r in results]).cpu().numpy()
        t2 = time.perf_counter()
        spans["chunk_ms"].append(1e3 * (t2 - t0))
        spans["dispatch_ms"].append(1e3 * (t1 - t0))
        spans["readback_ms"].append(1e3 * (t2 - t1))
        reservoir.offer(lambda: Sample(k, states, results, new_states, poses))
        states = new_states
        k += 1

    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way: the window's collections stay small
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    while True:
        step()
        t_end = time.perf_counter()
        if k == steps or (steps is None and t_end - t_win >= seconds):
            break
    window_steps = k
    if trace:  # after the window: its host spans never carry the profiler's cost
        from portbench.core.trace import WINDOW, DeviceTrace, reduce

        tracer = DeviceTrace()
        tracer.start()
        with torch.profiler.record_function(WINDOW):
            for _ in range(tp["trace_steps"]):
                step()
        events = tracer.stop()
        for v in spans.values():
            del v[window_steps:]
    del states
    sync()
    gc.unfreeze()
    log(f"[steps] {window_steps} in the window: ms " + ", ".join(
        f"{q} {v:.1f}" for q, v in zip(("min", "q1", "median", "q3", "max"),
                                        np.percentile(spans["chunk_ms"], [0, 25, 50, 75, 100])))
        + "; means of the first and second halves " + ", ".join(
        f"{np.mean(h):.1f}" for h in np.array_split(np.array(spans["chunk_ms"]), 2)))
    record = {
        "setup_s": setup_s, "window_s": t_end - t_win, "steps": window_steps, "frames": window_steps * S * B,
        "attempted": k * S * B, "frames_per_step": S * B, "traced_steps": k - window_steps, **spans,
        "kernels": bounds.step_kernels(cell.params, S * B, cell.config["nms_fused"]),
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if on_card else None,
    }
    if trace:
        record["trace"] = reduce(events)
        del events, tracer

    if not check:
        return record
    from portbench.reference.vo import ReferenceVO

    t0 = time.perf_counter()
    numbers, compared = compare(reservoir.kept, frames_of, ReferenceVO(cell.params, device), B, seeds,
                                tp["check_group"])
    log(f"[check] {len(reservoir.kept)} steps ({sorted(s.k for s in reservoir.kept)}), {compared} frames against "
        f"the reference in {time.perf_counter() - t0:.1f} s")
    record["numbers"] = numbers
    return record
