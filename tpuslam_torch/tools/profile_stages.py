"""Stage times of one VO chunk, each stage timed in place: ``python -m tpuslam_torch.tools.profile_stages``.

Port of ``tools/profile_stages.py``::

    python -m tpuslam_torch.tools.profile_stages [--pyramid] [--device cuda]

runs the functions ``SlamPipeline.process_chunk`` composes, one at a time
in its order, on a chunk of 16 KITTI fixture frames (ping-pong tiled), each timed by ``utils/profiling.py::synced_ms`` — the median
over ``reps`` (10) calls after a first one, with the card synchronised on
either side (with ``reps`` 0, the first call's time) — so their
sum is near the synchronised chunk, timed last as a whole.  Stages:
undistort, kernel 1 (blur + FAST), NMS and top-k, kernels 2-3 with the
orientation and the bits, matching, the draws, ``estimate_relative_pose``
(kernel 4 inside), triangulation, and scale and chaining; under
``--pyramid`` (``configs/multiscale``) the detector's stages are the
pyramid's resize, kernel 5 (kernel 1 on a level it does not take), top-k
and kernels 2-3 over every level.

Each stage's bound is the least time an H100 could take for it
(``kernels/bounds.py``: 3.35 TB/s, and the peak rate of its operations'
type): a kernel stage from its kernel's ``*_work``; any other stage counts
only the bytes of its inputs and outputs, so its bound is a lower bound.
``torch.profiler`` gives the device kernels of the whole chunk and its
device-busy share.  On the CPU every time is the CPU's and the device
fields are None.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.kernels.bounds import PEAK_F32_OPS, Work
from tpuslam_torch.utils.profiling import device_profile, synced_call, synced_ms

REPO = Path(__file__).resolve().parents[2]
BATCH = 16
REPS = 10


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor in ``objs`` (tuples, lists and named tuples walked)."""
    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, (tuple, list)):
            total += tensor_bytes(*o)
    return total


def fixture_chunk(batch: int, directory: Path | None = None) -> np.ndarray:
    """``batch`` fixture frames, ping-pong tiled (0..9, 8..1, …) as the card's runs tile them."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(directory or REPO / "tests" / "data" / "images")
    base = stream.read_frames(list(range(stream.total_frames)))
    stream.close()
    period = 2 * (len(base) - 1)
    return base[[min(i % period, period - i % period) for i in range(batch)]]


class _Stages:
    """Runs and times stages in order; each row keeps its ms and its bound."""

    def __init__(self, reps: int):
        self.reps = reps
        self.rows: list[dict] = []

    def __call__(self, name: str, fn, inputs=(), work: Work | None = None):
        out, ms = synced_call(fn)  # the call whose output the next stage takes
        if self.reps:
            ms = synced_ms(fn, reps=self.reps, warmup=0)
        if work is None:  # a stage with no kernel: its bytes alone
            work = Work(bytes=tensor_bytes(inputs, out), ops=0, peak=PEAK_F32_OPS)
        bound_us = work.bound_us()
        self.rows.append({"stage": name, "ms": ms, "bound_us": bound_us, "bound_by": work.bound_by(),
                          "bound_share": bound_us / 1e3 / ms if ms > 0 else None})
        return out


def _detector_stages(stage: _Stages, pipeline, und: torch.Tensor):
    """The detector's stages on (B, H, W) undistorted frames → (KeypointSet, descriptors)."""
    from tpuslam_torch.frontend.brief import quantize_angles
    from tpuslam_torch.frontend.detector import resize_batch_u8
    from tpuslam_torch.frontend.fast import KeypointSet, select_from_key, select_keypoints
    from tpuslam_torch.kernels.brief import extract_patches_work, own_bin_dots_work
    from tpuslam_torch.kernels.frontend import (
        fused_frontend_batch, fused_frontend_nms_batch, frontend_nms_work, frontend_work)

    det = pipeline.detector
    c = det.config
    B, H, W = und.shape
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    window = c.suppression_window_size
    if c.num_levels <= 1:
        levels, caps, imgs = [(0, H, W)], [c.max_keypoints], [und]
    else:
        levels = det._feasible_levels(H, W)
        caps = det._level_capacities(levels)
        imgs = stage(f"resize ({len(levels) - 1} levels)",
                     lambda: [und] + [resize_batch_u8(und, h, w) for _, h, w in levels[1:]], inputs=und)
    fused = [det._fused_nms_ok(h, w, cap) for (_, h, w), cap in zip(levels, caps)]
    work = [frontend_nms_work(B, h, w) if f else frontend_work(B, h, w) for (_, h, w), f in zip(levels, fused)]
    name = "kernel 5" if all(fused) else ("kernel 1" if not any(fused) else "kernels 5 and 1")
    planes = stage(f"{name} ({len(levels)} level{'s' if len(levels) > 1 else ''})",
                   lambda: [fused_frontend_nms_batch(im, window=window, **args) if f else fused_frontend_batch(im, **args)
                            for im, f in zip(imgs, fused)],
                   work=Work(sum(w.bytes for w in work), sum(w.ops for w in work), PEAK_F32_OPS))

    def select():
        return [select_from_key(p[1], window=window, max_keypoints=cap) if f else
                select_keypoints(p[1], p[2], nms=c.non_max_suppression, window=window, max_keypoints=cap)
                for p, f, cap in zip(planes, fused, caps)]

    kps_levels = stage("top-k" if all(fused) else "NMS + top-k", select, inputs=[p[1:] for p in planes])

    def compute():
        return [det.compute_from_blurred(p[0], k) for p, k in zip(planes, kps_levels)]

    work = None  # exact BRIEF (bins 0) runs no kernel: its bytes alone
    if c.brief_quantized_bins > 0:
        work = Work(0, 0, PEAK_F32_OPS)
        for (_, h, w), (kp, _) in zip(levels, compute()):
            bins = quantize_angles(kp.angle, c.brief_quantized_bins)
            wk = [extract_patches_work(B, h, w, kp.xy.shape[1], c.patch_size),
                  own_bin_dots_work(bins, det.bin_weights)]
            work = Work(work.bytes + sum(x.bytes for x in wk), work.ops + sum(x.ops for x in wk), wk[1].peak)
    computed = stage("kernels 2-3, orientation, bits", compute, inputs=(planes, kps_levels), work=work)
    parts = [(kp._replace(xy=kp.xy * torch.tensor(c.scale_factor ** lv, dtype=torch.float32, device=kp.xy.device)),
              d) for (lv, _, _), (kp, d) in zip(levels, computed)]
    kps = KeypointSet(*(torch.cat(f, dim=1) for f in zip(*(kp for kp, _ in parts))))
    return kps, torch.cat([d for _, d in parts], dim=1)


def profile_stages(pipeline, frames: torch.Tensor, reps: int = 10, seed: int = 0) -> dict:
    """Stage table of one chunk of (B, H, W) uint8 ``frames`` on the pipeline's device (VO mode)."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.fast import KeypointSet
    from tpuslam_torch.frontend.matcher import match_descriptors
    from tpuslam_torch.frontend.pose import estimate_relative_pose, triangulate_matched_points
    from tpuslam_torch.kernels.pose import msac_work

    frames = frames.to(pipeline.device)
    B = frames.shape[0]
    mcfg, pcfg, mapc = pipeline.config.matcher, pipeline.config.pose, pipeline.config.map
    state = pipeline.initial_state()
    valid = torch.ones(B, dtype=torch.bool)  # a host mask, as `run()` passes it
    stage = _Stages(reps)
    und = stage("undistort", lambda: undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid),
                inputs=(frames, pipeline.undistort_idx, pipeline.undistort_valid))
    kps, desc = _detector_stages(stage, pipeline, und)

    # consecutive pairs within the chunk; the first frame pairs with itself (no previous chunk)
    kps_q = KeypointSet(*(torch.cat([f[:1], f[:-1]]) for f in kps))
    desc_q = torch.cat([desc[:1], desc[:-1]])
    match = stage("matching", lambda: match_descriptors(
        desc_q, desc, kps_q.valid, kps.valid, kps_q.xy, kps.xy, ratio_threshold=mcfg.ratio_test_threshold,
        max_jump_radius=mcfg.max_jump_radius, use_ratio_test=mcfg.use_ratio_test, filter_matches=False,
        use_spatial_penalty=True), inputs=(desc_q, desc, kps.valid, kps.xy))
    q = torch.clamp_min(match.query_idx, 0)
    t = torch.clamp_min(match.train_idx, 0)
    pts1 = torch.gather(kps_q.xy, 1, q[..., None].expand(*q.shape, 2))
    pts2 = torch.gather(kps.xy, 1, t[..., None].expand(*t.shape, 2))
    mvalid = match.valid
    H = pcfg.num_hypotheses
    n_valid = mvalid.sum(dim=-1)
    draws = stage("draws (a generator a frame)",
                  lambda: pipeline._draws([list(range(B))], n_valid, [seed], H, [pipeline.draw_fn]),
                  inputs=n_valid)
    M = mvalid.shape[1]
    k4 = msac_work(B, H, M)
    res = stage("estimate_relative_pose", lambda: estimate_relative_pose(
        pts1, pts2, mvalid, pipeline.K, draws=draws, num_hypotheses=H, sample_size=pcfg.sample_size,
        inlier_threshold_px=pcfg.inlier_threshold_px, min_matches=pcfg.min_matches),
        work=Work(tensor_bytes(pts1, pts2, mvalid, draws) + B * (9 + 3 + M + 2) * 4, k4.ops, k4.peak))

    def triangulate():
        X_prev = triangulate_matched_points(pipeline.K, res.R, res.t, pts1, pts2)
        X_cur = torch.einsum("bij,bmj->bmi", res.R, X_prev) + res.t[:, None, :]
        point_ok = (res.inliers & mvalid & (X_prev[..., 2] > mapc.min_triangulation_depth)
                    & (X_prev[..., 2] < mapc.max_triangulation_depth)
                    & (X_cur[..., 2] > mapc.min_triangulation_depth) & res.success[:, None])
        return X_prev, X_cur, point_ok

    X_prev, X_cur, point_ok = stage("triangulation", triangulate, inputs=(res.R, res.t, pts1, pts2))
    stage("scale and chaining", lambda: pipeline._scale_and_chain(
        [state], [B], kps, desc, match, mvalid, res, X_prev, X_cur, point_ok), inputs=(X_prev, X_cur, point_ok))

    def chunk():
        return pipeline.process_chunk(frames, valid, state, seed)

    chunk_ms = synced_ms(chunk, reps=max(reps, 1), warmup=min(reps, 1))
    on_card = pipeline.device.type == "cuda"
    prof = device_profile(chunk) if on_card else {"device_kernels": None, "device_ms": None, "busy_share": None}
    return {
        "device": str(pipeline.device),
        "batch": B,
        "frame_shape": list(frames.shape[1:]),
        "levels": pipeline.config.detector.num_levels,
        "stages": stage.rows,
        "stages_sum_ms": sum(r["ms"] for r in stage.rows),
        "chunk_ms": chunk_ms,
        **prof,
    }


def format_table(report: dict) -> str:
    lines = [f"{'stage':34s} {'ms/chunk':>10s} {'bound µs':>10s}  by          share"]
    for r in report["stages"]:
        share = "" if r["bound_share"] is None else f"{100 * r['bound_share']:.3f}%"
        lines.append(f"{r['stage']:34s} {r['ms']:10.3f} {r['bound_us']:10.2f}  {r['bound_by']:11s} {share}")
    busy = report["busy_share"]
    lines.append(f"{'sum of stages':34s} {report['stages_sum_ms']:10.3f}")
    lines.append(f"{'whole chunk (process_chunk)':34s} {report['chunk_ms']:10.3f}   device kernels "
                 f"{report['device_kernels']}, busy {'not measured' if busy is None else f'{100 * busy:.1f}%'}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pyramid", action="store_true", help="configs/multiscale with kernel 5 (nms_fused)")
    parser.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        parser.error("no CUDA device: the profile runs on the card (--device cpu to run it on the CPU)")
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.model.slam import SlamPipeline

    cfg_dir = REPO / "configs" / ("multiscale" if args.pyramid else "")
    pipeline = SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"),
                            SlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH), device=args.device,
                            nms_fused=args.pyramid)
    report = profile_stages(pipeline, torch.from_numpy(fixture_chunk(BATCH)), reps=REPS)
    print(format_table(report))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
