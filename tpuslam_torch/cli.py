"""tpuslam_torch CLI — monocular tracking or full SLAM over an image directory or a video.

The port of ``tools/cli.py``::

    python -m tpuslam_torch.cli -c configs -v tests/data/images -o traj.txt \\
        [--tracking vo|pnp] [--batch-size 16] [--stats] [--device cpu] [--nms-fused] \\
        [--slam [--vocabulary V]] [--save-state S.npz] [--resume S.npz] [--localize S.npz] \\
        [--timeshard N] [--plot traj.png] [--debug]

reads the frames of ``-v``, a directory of PNG or JPEG frames or a Motion
JPEG AVI (``pre/stream.py``; any other video raises, naming why), in every
mode, and writes a KITTI-format trajectory (12 values per row).  It runs on the card
unless ``--device cpu`` is given; without a card it fails.  ``--stats`` prints
one JSON line with the frame count, wall time and pose statistics;
``--debug`` logs at the DEBUG level.
``-c configs/multiscale`` runs the 4-level image pyramid; ``--nms-fused``
detects with kernel 5 (blur + FAST + NMS in one pass) where a level allows.
``--tracking pnp`` tracks each frame against a persistent landmark map
(``SlamPipeline.run_pnp``) instead of chaining scaled two-view poses.

``--slam`` streams the frames through ``SlamSystem.run``: keyframes,
windowed bundle adjustment, loop closure with the vocabulary (default: the
config directory's ``vocabulary_tree.npz``, else ``vocabulary.npz``) and the
pose graph.  ``--save-state`` writes a checkpoint of the run and
``--resume`` continues the stream from one, so that the split run writes
the uninterrupted run's trajectory (at the same batch size).
``--localize CKPT`` is a mode of its own: it tracks the stream against the
map and keyframe DB of a ``--slam --tracking pnp`` checkpoint, frozen, an
unknown start pose bootstrapping by relocalization.

``--timeshard N`` cuts the video in time into N overlapping segments
(``dist/timeshard.py``): the frames (``--max-frames`` of them, after
``--frame-skip``) decode once into a memmap, each segment tracks with its
own state, and the segments are stitched by Sim(3); with ``--slam`` each
segment runs full SLAM and loops across segments close in a global pose
graph.  The segments spread over the first min(N, visible cards) cards,
one worker process a card, segment d on card ``d % cards``; with one card
(or ``--device cpu``) they run in this process.  It takes no ``--resume``
or ``--save-state``, and ``--tracking pnp`` only with ``--slam``.
``--plot PATH`` draws the trajectory's top-down (x, z) path into a PNG
(``post/visualizer.py::plot_trajectory``) in every mode.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path

import numpy as np

from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.post.trajectory import save_kitti_trajectory
from tpuslam_torch.pre.stream import FrameStream
from tpuslam_torch.utils.checkpoint import load_state, save_state


def _limited(batches, limit: int):
    seen = 0
    for item in batches:
        yield item
        seen += int(item[2].sum())
        if seen >= limit:
            break


def _plot(args, poses, log) -> None:
    """``--plot``: the trajectory's top-down plot."""
    if args.plot:
        from tpuslam_torch.post.visualizer import plot_trajectory

        plot_trajectory(poses, args.plot)
        log.info("Trajectory plot written to %s", args.plot)


def _timeshard(args, runner, stream: FrameStream, log) -> int:
    """``--timeshard N``: the frames decoded once into a memmap, then ``run_timesharded`` (VO) or
    ``run_timesharded_system`` (``--slam``)."""
    from tpuslam_torch.dist.timeshard import default_mesh, run_timesharded, run_timesharded_system
    from tpuslam_torch.pre.stream import frames_to_memmap

    indices = stream.frame_indices()  # honours --frame-skip
    if args.max_frames:
        indices = indices[: args.max_frames]
    frames = frames_to_memmap(stream, indices)
    devices = default_mesh(runner, args.timeshard)
    try:
        t0 = time.perf_counter()
        run = run_timesharded_system if args.slam else run_timesharded
        result = run(runner, frames, n_shards=args.timeshard, devices=devices)
        dt = time.perf_counter() - t0
    finally:
        path = frames.filename
        del frames
        os.unlink(path)
    n = len(indices)
    log.info("Time-sharded %d frames over %d segments (S=%d, V=%d) on %s in %.2f s", n, args.timeshard,
             result["S"], result["V"], ", ".join(str(d) for d in devices), dt)
    save_kitti_trajectory(result["poses"], args.output)
    log.info("Trajectory written to %s", args.output)
    _plot(args, result["poses"], log)
    for lp in result.get("loops", []):
        log.info("Loop closure: frame %d -> keyframe %d (%d inliers)%s", lp["frame_id"],
                 lp["matched_keyframe_id"], lp["num_inliers"], " across segments" if lp.get("cross_segment") else "")
    if args.stats:
        stats = {
            "frames": n,
            "seconds": dt,
            "fps": n / dt if dt > 0 else 0.0,
            "pose_ok": int(result["pose_ok"].sum()),
            "segments": args.timeshard,
        }
        if args.slam:
            stats["loops"] = len(result["loops"])
            stats["ba_events"] = len(result["ba_events"])
        print(json.dumps(stats))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpuslam_torch", description="Monocular visual odometry and SLAM (PyTorch/CUDA port)"
    )
    parser.add_argument("-c", "--config", required=True,
                        help="config directory holding camera.yml, feature_detector.yml, ...")
    parser.add_argument("-v", "--stream", required=True,
                        help="image directory (PNG or JPEG frames, optional timestamps.txt) or a Motion JPEG "
                             "AVI")
    parser.add_argument("-o", "--output", default="trajectory.txt",
                        help="output trajectory path (KITTI 12-value rows)")
    parser.add_argument("--camera-index", type=int, default=0)
    parser.add_argument("--frame-skip", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop after the chunk that reaches this many frames (0 = all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; pass cpu to run without a card)")
    parser.add_argument("--tracking", choices=["vo", "pnp"], default="vo",
                        help="vo: chained scaled two-view poses; pnp: absolute PnP against a landmark map")
    parser.add_argument("--nms-fused", action="store_true",
                        help="detect with the fused blur+FAST+NMS kernel where a level allows it")
    parser.add_argument("--slam", action="store_true",
                        help="full SLAM: keyframes, windowed bundle adjustment, loop closure, pose graph")
    parser.add_argument("--vocabulary", default=None,
                        help="BoW vocabulary .npz (default: the config directory's vocabulary_tree.npz, "
                             "else vocabulary.npz)")
    parser.add_argument("--save-state", default=None, help="write a checkpoint of the run (.npz)")
    parser.add_argument("--resume", default=None,
                        help="continue from a --save-state checkpoint of the same mode at its saved frame")
    parser.add_argument("--localize", default=None, metavar="CKPT",
                        help="track against the frozen map and keyframe DB of a --slam --tracking pnp "
                             "checkpoint (no inserts, no BA; the start bootstraps by relocalization)")
    parser.add_argument("--timeshard", type=int, default=0, metavar="N",
                        help="cut the video's time axis into N overlapping segments, each tracked with its own "
                             "state, stitched by Sim(3) over the overlaps (with --slam: cross-segment loops and "
                             "a global pose graph); the segments run in turn on the device")
    parser.add_argument("--plot", default=None, help="write a top-down trajectory plot (PNG)")
    parser.add_argument("--stats", action="store_true", help="print run stats as JSON")
    parser.add_argument("--debug", action="store_true", help="log at the DEBUG level")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO,
                        format="[%(asctime)s] [%(levelname)s] %(message)s")
    log = logging.getLogger("tpuslam_torch")
    if args.plot and Path(args.plot).suffix.lower() != ".png":
        parser.error("--plot writes a PNG: give it a .png path")

    if args.timeshard:
        if args.resume:
            parser.error("--timeshard does not support --resume")
        if args.save_state:
            parser.error("--timeshard does not checkpoint (--save-state): per-shard state is not resumable")
        if args.tracking != "vo" and not args.slam:
            parser.error("--timeshard --tracking pnp requires --slam (the map-centric tracker needs its "
                         "per-shard map)")

    cfg_dir = Path(args.config)
    camera = Camera.from_yaml(cfg_dir / "camera.yml", camera_index=args.camera_index)
    config = SlamConfig.from_yaml_dir(
        cfg_dir, frame_skip=args.frame_skip, batch_size=args.batch_size
    )
    tree = cfg_dir / "vocabulary_tree.npz"
    vocab = args.vocabulary or (tree if tree.is_file() else cfg_dir / "vocabulary.npz")
    stream = FrameStream(args.stream, frame_skip=args.frame_skip)

    def batches(start_frame: int = 0):
        it = stream.batches(args.batch_size, start_frame=start_frame)
        return _limited(it, args.max_frames) if args.max_frames else it

    if args.localize:
        if args.slam or args.resume or args.save_state or args.timeshard:
            parser.error("--localize is its own mode (no --slam/--resume/--save-state/--timeshard)")
        from tpuslam_torch.model.system import SlamSystem

        system = SlamSystem(camera, config, vocabulary=vocab, tracking="pnp", localization_only=True,
                            device=args.device)
        loaded = load_state(args.localize, device=system.device, slam=system.checkpoint_template())["slam"]
        log.info("Localization: %s against the frozen map and DB of %s on %s", args.stream, args.localize,
                 args.device)
        t0 = time.perf_counter()
        result = system.run(batches(), warm_start={"map": loaded["world_map"], "db": loaded["db"]})
        dt = time.perf_counter() - t0
        save_kitti_trajectory(result["poses"], args.output)
        log.info("Trajectory written to %s", args.output)
        _plot(args, result["poses"], log)
        if args.stats:
            n = len(result["poses"])
            print(json.dumps({
                "frames": n,
                "seconds": dt,
                "fps": n / dt if dt > 0 else 0.0,
                "device": str(system.device),
                "pose_ok": int(result["pose_ok"].sum()),
                "relocalizations": int(result["reloc_ok"].sum()),
            }))
        return 0

    if args.slam:
        from tpuslam_torch.model.system import SlamSystem

        runner = SlamSystem(camera, config, vocabulary=vocab, tracking=args.tracking, device=args.device)
        device = runner.device
        log.info("Full SLAM, %s tracking (vocabulary: %s)", args.tracking, vocab)
    else:
        runner = SlamPipeline(
            camera, config, tracking=args.tracking, device=args.device, nms_fused=args.nms_fused
        )
        device = runner.device
    log.info("Stream %s: %d frames on %s", args.stream, stream.total_frames, args.device)

    if args.timeshard:
        return _timeshard(args, runner, stream, log)

    resume_state = resume_poses = slam_resume = None
    start_frame = 0
    if args.resume:
        if args.slam:
            slam_resume = load_state(args.resume, device=device, slam=runner.checkpoint_template())["slam"]
            start_frame = int(slam_resume["counters"][0])
        else:
            template = runner.initial_pnp_state() if args.tracking == "pnp" else runner.initial_state()
            loaded = load_state(args.resume, device=device, state=template, trajectory=np.zeros((0, 4, 4)))
            resume_state = loaded["state"]
            resume_poses = loaded["trajectory"].cpu().numpy()
            start_frame = len(resume_poses)
        log.info("Resuming at frame %d from %s", start_frame, args.resume)

    t0 = time.perf_counter()
    if args.slam:  # a SLAM checkpoint carries the trajectory so far: the poses cover the whole run
        result = runner.run(batches(start_frame), resume=slam_resume)
    else:
        run = runner.run_pnp if args.tracking == "pnp" else runner.run
        result = run(batches(start_frame), initial_state=resume_state)
        if resume_poses is not None:
            result["poses"] = np.concatenate([resume_poses.astype(result["poses"].dtype), result["poses"]])
    dt = time.perf_counter() - t0
    save_kitti_trajectory(result["poses"], args.output)
    log.info("Trajectory written to %s", args.output)
    for lp in result.get("loops", []):
        log.info("Loop closure: frame %d -> keyframe %d (%d inliers)",
                 lp["frame_id"], lp["matched_keyframe_id"], lp["num_inliers"])
    if args.save_state:
        if args.slam:
            save_state(args.save_state, slam=result["checkpoint"])
        else:
            save_state(args.save_state, trajectory=result["poses"], state=result["state"])
        log.info("State checkpoint written to %s", args.save_state)
    _plot(args, result["poses"], log)
    if args.stats:
        n = len(result["poses"])
        stats = {
            "frames": n,
            "seconds": dt,
            "fps": n / dt if dt > 0 else 0.0,
            "device": str(device),
            "tracking": args.tracking,
            "pose_ok": int(np.asarray(result["pose_ok"]).sum()),
            "mean_matches": float(np.mean(result["num_matches"])) if n else 0.0,
            "mean_inliers": float(np.mean(result["num_inliers"])) if n else 0.0,
        }
        if "reloc_ok" in result:
            stats["relocalizations"] = int(result["reloc_ok"].sum())
        if args.slam:
            stats["loops"] = len(result["loops"])
            stats["ba_events"] = len(result["ba_events"])
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
