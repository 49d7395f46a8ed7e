"""Long-sequence full-SLAM soak: past the keyframe ring, on the card.

Port of ``tools/soak.py``::

    python -m tpuslam_torch.tools.soak [--frames 1536] [--policy fifo|redundancy] [--tracking vo|pnp]
        [--vocabulary configs/vocabulary_tree.npz] [--device cuda]

runs ``SlamSystem.run_sequence`` over ~1.5k frames, three times the
512-keyframe DB ring, made of the 10 KITTI fixture frames as *distinctive
prologue → self-similar filler → revisit* (``sequence_indices``):

* prologue: frames 0..9 forward, then 8..4 (ids 0-14);
* filler: ping-pong over frames 3..6 only, the redundancy policy's victim;
* bridge 5..8, then the revisit 9..0, which sees the prologue again.

It prints one JSON report and exits 0 when the run passes: a finite
trajectory, ``pose_ok`` on more than 95% of the frames, and at least one
loop from the revisit into keyframe ids < 10 (unless the policy is FIFO,
which is meant to lose them).  The report also lists the prologue ids
(< 15) left in the DB at the end and, on the card, the memory allocated
after each chunk.  DB and map shapes are fixed, so from the chunk that
first overflows the ring (the last code path to run for the first time,
and allocate its workspaces) to the last chunk it must stay flat, within
``MEMORY_SLACK``: the per-chunk outputs stay on the card until the run
reads them back once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
BATCH = 16
PROLOGUE = 15  # frames 0..9, 8..4
MEMORY_SLACK = 16 << 20  # bytes the allocated memory may grow from the settled chunk to the last


def sequence_indices(n_frames: int) -> tuple[list[int], int]:
    """(the fixture frame of each soak frame, filler_end).

    Every segment boundary joins adjacent fixture frames, so tracking
    never teleports: the prologue ascends 0..9 and descends to the filler
    band, the filler ping-pongs 3..6, climbs back to 9, then revisits 8..0;
    a stationary tail of frame 0 pads to ``n_frames``.
    """
    prologue = list(range(10)) + list(range(8, 3, -1))
    cycle = [3, 4, 5, 6, 5, 4]  # full cycles end at 4, descending
    bridge = [5, 6, 7, 8]
    revisit = list(range(9, -1, -1))
    n_fixed = len(prologue) + len(bridge) + len(revisit)
    n_filler = max(((n_frames - n_fixed) // len(cycle)) * len(cycle), len(cycle))
    idx = prologue + [cycle[i % len(cycle)] for i in range(n_filler)] + bridge + revisit
    idx += [0] * (n_frames - len(idx))
    return idx[:n_frames], len(prologue) + n_filler + len(bridge)


def build_sequence(n_frames: int, directory: Path | None = None) -> tuple[np.ndarray, int]:
    """(frames (n, H, W) uint8, filler_end) from the fixture directory, decoded once."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(directory or REPO / "tests" / "data" / "images")
    base = stream.read_frames(list(range(stream.total_frames)))
    stream.close()
    idx, filler_end = sequence_indices(n_frames)
    return base[idx], filler_end


def soak_system(policy: str | None = None, tracking: str = "vo", vocabulary: str | Path = "configs/vocabulary_tree.npz",
                device: str = "cuda", batch: int = BATCH):
    """The reference's soak system: ``configs/`` at ``batch``, the eviction policy replaced when given."""
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.system import SlamSystem

    config = SlamConfig.from_yaml_dir(REPO / "configs", batch_size=batch)
    if policy:
        config = dataclasses.replace(
            config, loop_closure=dataclasses.replace(config.loop_closure, eviction_policy=policy))
    vocabulary = Path(vocabulary)
    return SlamSystem(Camera.from_yaml(REPO / "configs" / "camera.yml"), config,
                      vocabulary=vocabulary if vocabulary.is_absolute() else REPO / vocabulary,
                      tracking=tracking, device=device)


def _carry_shapes(carry) -> list[tuple]:
    out = []
    for x in carry:
        if isinstance(x, torch.Tensor):
            out.append(tuple(x.shape))
        elif isinstance(x, tuple):
            out.extend(_carry_shapes(x))
    return out


def run_soak(system, frames: np.ndarray, filler_end: int, seed: int = 0) -> tuple[dict, dict]:
    """``system.run_sequence(frames)`` with the soak's report → (report, the run's result).

    Each chunk's step is wrapped to read ``memory_allocated`` and the
    carry's shapes after it, and the fold is timed; nothing else changes
    in the run.
    """
    on_card = system.device.type == "cuda"
    after: list[tuple[int, list]] = []
    step, fold = system._step, system._fold_sequence
    fold_s = []

    def recorded(carry, frames_c, valid, seed_):
        carry, out = step(carry, frames_c, valid, seed_)
        after.append((torch.cuda.memory_allocated(system.device) if on_card else 0, _carry_shapes(carry)))
        return carry, out

    def timed_fold(*a):
        t = time.perf_counter()
        result = fold(*a)
        fold_s.append(time.perf_counter() - t)
        return result

    system._step, system._fold_sequence = recorded, timed_fold
    try:
        t0 = time.perf_counter()
        out = system.run_sequence(frames, seed=seed)
        wall = time.perf_counter() - t0
    finally:
        del system._step, system._fold_sequence
    n = len(frames)
    pose_ok = np.asarray(out["pose_ok"])
    loops = out["loops"]
    revisit = [lp for lp in loops if lp["frame_id"] >= filler_end and lp["matched_keyframe_id"] < 10]
    db_ids = out["db"].ids.cpu().numpy()
    policy = system.config.loop_closure.eviction_policy
    report = {
        "frames": n,
        "wall_s": wall,
        "fold_s": fold_s[0],  # BA snapshots and the pose graph, on the host and the device, after the chunks
        "fps": n / wall,
        "pose_ok_rate": float(pose_ok.mean()),
        "finite_trajectory": bool(np.isfinite(out["poses"]).all()),
        "loops_total": len(loops),
        "revisit_loops_matching_prologue": len(revisit),
        "revisit_examples": [(lp["frame_id"], lp["matched_keyframe_id"]) for lp in revisit[:6]],
        "prologue_ids_in_db": sorted(int(i) for i in db_ids if 0 <= i < PROLOGUE),
        "db_keyframes": int((db_ids >= 0).sum()),
        "db_capacity": int(db_ids.shape[0]),
        "pose_graph_applied": out["pose_graph_applied"],
        "carry_shapes_fixed": all(shapes == after[0][1] for _, shapes in after),
        "policy": policy,
        "tracking": system.tracking,
        "device": str(system.device),
    }
    # the first chunk that overflows the ring runs the last code path a chunk can take (eviction)
    settled = min(db_ids.shape[0] // system.config.batch_size, len(after) - 1)
    mem = [m for m, _ in after]
    grew = mem[-1] - mem[settled]
    report.update(
        memory_allocated_by_chunk=mem if on_card else None,
        memory_settled_chunk=settled,
        memory_growth=mem[-1] - mem[0] if on_card else None,
        memory_growth_settled=grew if on_card else None,
    )
    report["ok"] = (report["finite_trajectory"] and report["pose_ok_rate"] > 0.95
                    and (report["revisit_loops_matching_prologue"] > 0 or policy == "fifo")
                    and report["carry_shapes_fixed"] and grew <= MEMORY_SLACK)
    return report, out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=1536)
    parser.add_argument("--policy", default=None, help="override EvictionPolicy (fifo|redundancy)")
    parser.add_argument("--tracking", default="vo", choices=("vo", "pnp"))
    parser.add_argument("--vocabulary", default="configs/vocabulary_tree.npz")
    parser.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: the soak runs on the card (--device cpu to run it on the CPU)")
    n = args.frames - args.frames % BATCH
    frames, filler_end = build_sequence(n)
    system = soak_system(args.policy, args.tracking, args.vocabulary, args.device)
    report, _ = run_soak(system, frames, filler_end)
    report["vocabulary"] = args.vocabulary
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
