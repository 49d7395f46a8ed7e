"""Stage times of full SLAM, each stage timed in place: ``python -m tpuslam_torch.tools.profile_slam``.

Port of ``tools/profile_slam.py``::

    python -m tpuslam_torch.tools.profile_slam [--device cuda]

The reference's chunk is one fused XLA program, so it times a ladder of
configurations and reads each stage's cost off the differences.  The
port's chunk is eager: here each stage is timed where it runs, the card
synchronised on either side (``utils/profiling.py::synced_call``), by
wrapping the methods of one ``SlamSystem`` for one staged run of
``run_sequence`` over 96 fixture frames ping-pong tiled (as the card's runs
tile them), batch 16, the tree vocabulary and ``configs/``.  Stages, in ms a
chunk: the tracker (``process_chunk`` / ``process_chunk_pnp``: the two-view
stage, and the PnP tracker), the BoW transform, relocalization (with the
count of chunks where it fired), the map fold (VO), the loop-closure stage
split into ``ransac_pnp`` verification and the rest (relocalization's
``ransac_pnp`` is booked under it), BA, and, once a run,
the pose graph and the host fold, beside the chunk's wall synchronised.
A warm-up run comes first.  A stage that runs in some chunks only is
averaged over all of them.

Then the PnP mapping run's map and DB warm-start a ``localization_only``
system over the same frames, so a frozen chunk's stages stand beside a
mapping chunk's.  On the CPU every time is the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.tools.profile_stages import fixture_chunk
from tpuslam_torch.utils.profiling import synced_call

REPO = Path(__file__).resolve().parents[2]
BATCH = 16
N_FRAMES = 96


class _Timed:
    """Synchronised host time and call count of each wrapped stage.

    A stage wrapped ``nested`` is booked under the stage that called it
    ("loop closure: ransac_pnp"), so a parent's own time is its total less
    its nested stages'.
    """

    ORDER = ("chunk", "tracker", "bow", "relocalization", "relocalization: fired",
             "relocalization: fired: ransac_pnp", "map fold", "loop closure", "loop closure: ransac_pnp",
             "loop closure: the rest", "BA", "pose graph", "host fold (with the pose graph)")

    def __init__(self) -> None:
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self._undo: list = []
        self._active: list[str] = []

    def wrap(self, owner, attr: str, name: str, nested: bool = False) -> None:
        fn = getattr(owner, attr)

        def timed(*a, **k):
            key = f"{self._active[-1]}: {name}" if nested and self._active else name
            self._active.append(key)
            try:
                out, ms = synced_call(lambda: fn(*a, **k))
            finally:
                self._active.pop()
            self.ms[key] = self.ms.get(key, 0.0) + ms
            self.calls[key] = self.calls.get(key, 0) + 1
            return out

        in_dict = attr in vars(owner)
        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn if in_dict else None))

    def undo(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._undo.clear()


def staged_run(system, frames: np.ndarray, seed: int = 0, warm_start: dict | None = None) -> tuple[dict, dict]:
    """One ``run_sequence`` with its stages timed in place → (stage table, the run's result)."""
    import tpuslam_torch.model.system as system_module

    pnp = system.tracking == "pnp"
    t = _Timed()
    t.wrap(system, "_step", "chunk")
    t.wrap(system.pipeline, "process_chunk_pnp" if pnp else "process_chunk", "tracker")
    if system.loop_closure is not None:
        t.wrap(system.loop_closure.vocabulary, "transform", "bow")
        t.wrap(system, "_reloc_chunk_pnp" if pnp else "_reloc_chunk", "relocalization")
        t.wrap(system, "_relocalize", "fired", nested=True)
        t.wrap(system, "_lc_chunk", "loop closure")
        t.wrap(system.loop_closure, "_ransac", "ransac_pnp", nested=True)
    if not pnp:
        t.wrap(system_module, "update_map_chunk_batched" if system.use_batched_map else "update_map_chunk",
               "map fold")
    if system.enable_ba:
        t.wrap(system, "_ba_cond", "BA")
    t.wrap(system, "_apply_pose_graph", "pose graph")
    t.wrap(system, "_fold_sequence", "host fold (with the pose graph)")
    try:
        out = system.run_sequence(frames, seed=seed, warm_start=warm_start)
    finally:
        t.undo()
    chunks = t.calls["chunk"]
    rows = {name: {"ms_per_chunk": ms / chunks, "calls": t.calls[name]} for name, ms in t.ms.items()}
    if "loop closure" in rows:
        ransac = rows.get("loop closure: ransac_pnp", {"ms_per_chunk": 0.0})["ms_per_chunk"]
        rows["loop closure: the rest"] = {"ms_per_chunk": rows["loop closure"]["ms_per_chunk"] - ransac,
                                          "calls": rows["loop closure"]["calls"]}
    for once in ("pose graph", "host fold (with the pose graph)"):
        if once in rows:
            rows[once] = {"ms": t.ms[once], "calls": t.calls[once]}
    order = {name: i for i, name in enumerate(_Timed.ORDER)}
    rows = dict(sorted(rows.items(), key=lambda kv: order.get(kv[0], len(order))))
    return {"chunks": chunks, "stages": rows}, out


def profile_run(system, frames: np.ndarray, warmup: bool = True, warm_start: dict | None = None) -> tuple[dict, dict]:
    """A warm-up run, then the staged run → (report, the staged run's result)."""
    if warmup:
        system.run_sequence(frames, seed=1, warm_start=warm_start)
    table, out = staged_run(system, frames, 0, warm_start)
    table.update(frames=len(frames), tracking=system.tracking,
                 localization_only=system.localization_only, loops=len(out["loops"]),
                 pose_ok=float(np.asarray(out["pose_ok"]).mean()), reloc_frames=int(np.asarray(out["reloc_ok"]).sum()))
    return table, out


def profile_slam(camera, config, vocabulary, frames: np.ndarray, device: str = "cuda",
                 trackings: tuple[str, ...] = ("vo", "pnp"), localize: bool = True, warmup: bool = True,
                 **system_kw) -> dict:
    """Stage tables of full SLAM in each tracking mode and, from the PnP run's map and DB, of localization."""
    from tpuslam_torch.model.system import SlamSystem

    report = {"device": str(device), "batch": config.batch_size}
    mapped = None
    for tracking in trackings:
        system = SlamSystem(camera, config, vocabulary=vocabulary, tracking=tracking, device=device, **system_kw)
        report[tracking], out = profile_run(system, frames, warmup)
        if tracking == "pnp":
            mapped = {"map": out["map"], "db": out["db"]}
    if localize and mapped is not None:
        system = SlamSystem(camera, config, vocabulary=vocabulary, tracking="pnp", localization_only=True,
                            device=device, **system_kw)
        report["localize"], _ = profile_run(system, frames, warmup, warm_start=mapped)
    return report


def format_table(report: dict) -> str:
    modes = [m for m in ("vo", "pnp", "localize") if m in report]
    names = []
    for m in modes:
        names += [n for n in report[m]["stages"] if n not in names]
    order = {name: i for i, name in enumerate(_Timed.ORDER)}
    names.sort(key=lambda n: order.get(n, len(order)))
    lines = [f"{'ms a chunk (synchronised)':40s}" + "".join(f"{m:>14s}" for m in modes)]
    for n in names:
        cells = []
        for m in modes:
            row = report[m]["stages"].get(n)
            if row is None:
                cells.append(f"{'—':>14s}")
            elif "ms" in row:
                cells.append(f"{row['ms']:11.2f} ms")  # once a run
            else:
                cells.append(f"{row['ms_per_chunk']:10.2f} x{row['calls']:<2d}" if n.endswith("fired")
                             else f"{row['ms_per_chunk']:14.2f}")
        lines.append(f"{n:40s}" + "".join(cells))
    lines.append(f"{'loops / relocalized frames / pose_ok':40s}" + "".join(
        f"{report[m]['loops']:>5d}/{report[m]['reloc_frames']:>3d}/{report[m]['pose_ok']:.2f}" for m in modes))
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: the profile runs on the card (--device cpu to run it on the CPU)")
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig

    report = profile_slam(Camera.from_yaml(REPO / "configs" / "camera.yml"),
                          SlamConfig.from_yaml_dir(REPO / "configs", batch_size=BATCH),
                          REPO / "configs" / "vocabulary_tree.npz", fixture_chunk(N_FRAMES), args.device)
    print(format_table(report))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
