"""tpuslam_torch CLI — monocular tracking over an image directory.

The VO and PnP-tracking subset of ``tools/cli.py``::

    python -m tpuslam_torch.cli -c configs -v tests/data/images -o traj.txt \\
        [--tracking vo|pnp] [--batch-size 16] [--stats] [--device cpu] [--nms-fused]

writes a KITTI-format trajectory (12 values per row).  It runs on the card
unless ``--device cpu`` is given; without a card it fails.  ``--stats`` prints
one JSON line with the frame count, wall time and pose statistics.
``-c configs/multiscale`` runs the 4-level image pyramid; ``--nms-fused``
detects with kernel 5 (blur + FAST + NMS in one pass) where a level allows.
``--tracking pnp`` tracks each frame against a persistent landmark map
(``SlamPipeline.run_pnp``) instead of chaining scaled two-view poses.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from tpuslam_torch.common.camera import Camera
from tpuslam_torch.config.schema import SlamConfig
from tpuslam_torch.model.slam import SlamPipeline
from tpuslam_torch.post.trajectory import save_kitti_trajectory
from tpuslam_torch.pre.stream import FrameStream


def _limited(batches, limit: int):
    seen = 0
    for item in batches:
        yield item
        seen += int(item[2].sum())
        if seen >= limit:
            break


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="tpuslam_torch", description="Monocular visual odometry (PyTorch/CUDA port)"
    )
    parser.add_argument("-c", "--config", required=True,
                        help="config directory holding camera.yml, feature_detector.yml, ...")
    parser.add_argument("-v", "--stream", required=True,
                        help="image directory of 8-bit grayscale PNGs (optional timestamps.txt)")
    parser.add_argument("-o", "--output", default="trajectory.txt",
                        help="output trajectory path (KITTI 12-value rows)")
    parser.add_argument("--camera-index", type=int, default=0)
    parser.add_argument("--frame-skip", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop after this many frames (0 = all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; pass cpu to run without a card)")
    parser.add_argument("--tracking", choices=["vo", "pnp"], default="vo",
                        help="vo: chained scaled two-view poses; pnp: absolute PnP against a landmark map")
    parser.add_argument("--nms-fused", action="store_true",
                        help="detect with the fused blur+FAST+NMS kernel where a level allows it")
    parser.add_argument("--stats", action="store_true", help="print run stats as JSON")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] %(message)s")
    log = logging.getLogger("tpuslam_torch")

    cfg_dir = Path(args.config)
    camera = Camera.from_yaml(cfg_dir / "camera.yml", camera_index=args.camera_index)
    config = SlamConfig.from_yaml_dir(
        cfg_dir, frame_skip=args.frame_skip, batch_size=args.batch_size
    )
    pipeline = SlamPipeline(
        camera, config, tracking=args.tracking, device=args.device, nms_fused=args.nms_fused
    )
    stream = FrameStream(args.stream, frame_skip=args.frame_skip)
    log.info("Stream %s: %d frames on %s", args.stream, stream.total_frames, args.device)

    batches = stream.batches(args.batch_size)
    if args.max_frames:
        batches = _limited(batches, args.max_frames)
    t0 = time.perf_counter()
    result = (pipeline.run_pnp if args.tracking == "pnp" else pipeline.run)(batches)
    dt = time.perf_counter() - t0
    save_kitti_trajectory(result["poses"], args.output)
    log.info("Trajectory written to %s", args.output)
    if args.stats:
        n = len(result["poses"])
        print(json.dumps({
            "frames": n,
            "seconds": dt,
            "fps": n / dt if dt > 0 else 0.0,
            "device": str(pipeline.device),
            "tracking": args.tracking,
            "pose_ok": int(np.asarray(result["pose_ok"]).sum()),
            "mean_matches": float(np.mean(result["num_matches"])) if n else 0.0,
            "mean_inliers": float(np.mean(result["num_inliers"])) if n else 0.0,
        }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
