"""Evaluate an estimated trajectory against ground truth (KITTI format).

The port's counterpart of ``tools/evaluate.py``::

    python -m tpuslam_torch.evaluate estimate.txt groundtruth.txt [--no-scale] [--rpe-delta N] [--plot out.png]

prints one JSON line: the frame count, the ATE RMSE after Sim(3) alignment
(SE(3) with ``--no-scale``) and the RPE statistics at frame step N.
``--plot`` draws the estimate's top-down path with the ground truth into a
PNG (``post/visualizer.py::plot_trajectory``).
"""

from __future__ import annotations

import argparse
import json
import sys

from tpuslam_torch.post.trajectory import ate_rmse, load_kitti_trajectory, rpe_stats


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Trajectory evaluation (ATE/RPE)")
    parser.add_argument("estimate")
    parser.add_argument("groundtruth")
    parser.add_argument("--no-scale", action="store_true", help="SE(3) alignment instead of Sim(3)")
    parser.add_argument("--rpe-delta", type=int, default=1)
    parser.add_argument("--plot", default=None, help="write a top-down plot with the ground truth (PNG)")
    args = parser.parse_args(argv)
    if args.plot and not args.plot.lower().endswith(".png"):
        parser.error("--plot writes a PNG: give it a .png path")

    est = load_kitti_trajectory(args.estimate)
    gt = load_kitti_trajectory(args.groundtruth)
    print(json.dumps({
        "frames": int(min(len(est), len(gt))),
        "ate_rmse": ate_rmse(est, gt, align_scale=not args.no_scale),
        **rpe_stats(est, gt, delta=args.rpe_delta),
    }))
    if args.plot:
        from tpuslam_torch.post.visualizer import plot_trajectory

        plot_trajectory(est, args.plot, gt_poses=gt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
