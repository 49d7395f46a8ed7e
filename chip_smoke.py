#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each fatal on failure (no CPU fallback, no caught phase):

1. device — require CUDA; print the card's name and power limit;
2. build — compile ``tpuslam_torch/csrc/*.cu`` for sm_90a from this checkout;
3. kernels — each of the four kernels against its plain PyTorch twin on the
   card, at the main path's shapes, on inputs made from the KITTI fixtures:
   kernels 1-3 exact, kernel 4 to rtol 1e-5; median times of both (CUDA events);
4. frontend — ``FeatureDetector`` on 2 frames on the card and on the CPU:
   keypoints and descriptors identical;
5. main path — VO with ``configs/`` at batch 16 over 96 frames (the fixtures
   ping-pong tiled, as ``bench.py`` does), one warm-up pass, then a timed
   pass with the kernels' launch counters zeroed just before it: every
   counter must be > 0, ``pose_ok`` must hold on >= 90% of frames 1..95, and
   the inter-frame motion must be dominantly along +-z.

The last three lines of standard output are the kernels' JSON record, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 16
N_FRAMES = 96
RTOL_MSAC = 1e-5  # kernel 4 sums its 1024 matches in another order than the twin

# Kernel wrapper name → (its CUDA source, the Pallas kernel it replaces).
KERNELS = {
    "fused_frontend_batch": ("tpuslam_torch/csrc/frontend.cu", "tpuslam/kernels/frontend_pallas.py:115"),
    "extract_brief_patches": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:62"),
    "brief_own_bin_dots": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:159"),
    "msac_scores": ("tpuslam_torch/csrc/pose.cu", "tpuslam/kernels/pose_pallas.py:54"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def load_frames(n_frames: int) -> np.ndarray:
    """The 10 fixture frames ping-pong tiled (0..9, 8..1, 0..9, …): a continuous path."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(REPO / "tests" / "data" / "images")
    base = [stream.read_frame(i)[0] for i in range(stream.total_frames)]
    period = 2 * (len(base) - 1)
    idx = [min(i % period, period - i % period) for i in range(n_frames)]
    return np.stack([base[i] for i in idx])


def phase_kernels(pipeline, frames: torch.Tensor) -> list[dict]:
    """Kernels 1-4 against their twins at the main path's shapes."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.fast import select_keypoints
    from tpuslam_torch.frontend.matcher import match_descriptors
    from tpuslam_torch.frontend.pose import _eight_point_rows, _solve_e_from_rows, draw_ranks
    from tpuslam_torch.common.geometry import normalize_points
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf
    from tpuslam_torch.kernels import pose as kp

    det = pipeline.detector
    c = det.config
    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    records = []

    def record(name, got, want, ms, plain_ms, exact):
        if exact:
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(f"{name}: kernel disagrees with its twin at {bad} elements")
            err = 0.0
        else:
            g, w = got[0], want[0]
            if not torch.allclose(g, w, rtol=RTOL_MSAC, atol=0.0):
                raise AssertionError(
                    f"{name}: max rel err {float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())}"
                )
            err = float((g - w).abs().max())
        src, replaces = KERNELS[name]
        records.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        log(f"[kernels] {name}: {tuple(got[0].shape)} max_abs_err={err} "
            f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")

    # Kernel 1: blur + FAST on (16, 512, 1392) u8.
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    got = kf.fused_frontend_batch(und, **args)
    want = kf.fused_frontend_reference(und, **args)
    ms = time_ms(lambda: kf.fused_frontend_batch(und, **args))
    plain = time_ms(lambda: kf.fused_frontend_reference(und, **args))
    record("fused_frontend_batch", got, want, ms, plain, exact=True)
    blur, corner, score = got
    kps = select_keypoints(corner, score, nms=c.non_max_suppression,
                           window=c.suppression_window_size, max_keypoints=c.max_keypoints)
    if int(kps.valid.sum()) < BATCH * 300:
        raise AssertionError(f"too few keypoints: {int(kps.valid.sum())}")

    # Kernel 2: patches (16, 1024, 2304) i8.
    got = kb.extract_brief_patches(blur, kps.xy, c.patch_size)
    want = kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size)
    ms = time_ms(lambda: kb.extract_brief_patches(blur, kps.xy, c.patch_size))
    plain = time_ms(lambda: kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size))
    record("extract_brief_patches", (got,), (want,), ms, plain, exact=True)
    patches = got

    # Kernel 3: own-bin dots (16, 1024, 256) i32.
    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    W = det.bin_weights_3d
    got = kb.brief_own_bin_dots(patches, bins, W)
    want = kb.brief_own_bin_dots_reference(patches, bins, W)
    ms = time_ms(lambda: kb.brief_own_bin_dots(patches, bins, W))
    plain = time_ms(lambda: kb.brief_own_bin_dots_reference(patches, bins, W))
    record("brief_own_bin_dots", (got,), (want,), ms, plain, exact=True)

    # Kernel 4: MSAC scores of 1024 hypotheses x 1024 matches per pair, 16 pairs.
    kps2, desc = det.compute_from_blurred(blur, kps)
    q, t = slice(0, BATCH - 1), slice(1, BATCH)
    m = match_descriptors(desc[q], desc[t], kps2.valid[q], kps2.valid[t], kps2.xy[q], kps2.xy[t],
                          filter_matches=False)
    # pair 0 against itself keeps the batch at 16 pairs, as in the pipeline
    qi = torch.cat([m.query_idx[:1].clamp_min(0), m.query_idx.clamp_min(0)])
    ti = torch.cat([m.query_idx[:1].clamp_min(0), m.train_idx.clamp_min(0)])
    valid = torch.cat([m.valid[:1], m.valid])
    xy_q = torch.cat([kps2.xy[:1], kps2.xy[:-1]])
    pts1 = torch.gather(xy_q, 1, qi[..., None].expand(-1, -1, 2))
    pts2 = torch.gather(kps2.xy, 1, ti[..., None].expand(-1, -1, 2))
    K = pipeline.K
    x1, x2 = normalize_points(K, pts1), normalize_points(K, pts2)
    H = pipeline.config.pose.num_hypotheses
    gen = torch.Generator(device=frames.device).manual_seed(0)
    draws = draw_ranks(valid.sum(-1), H, 8, gen)
    rank_to_idx = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    sample = torch.gather(rank_to_idx, 1, draws.reshape(BATCH, -1))
    rows = torch.gather(_eight_point_rows(x1, x2), 1, sample[..., None].expand(-1, -1, 9))
    E = _solve_e_from_rows(rows.reshape(BATCH, H, 8, 9), project=False, sweeps=3).reshape(BATCH, H, 9)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    P = kp.build_msac_operand(x1, x2, valid, (1.0 / focal) ** 2)
    got = kp.msac_scores(E, P)
    want = kp.msac_scores_reference(E, P)
    ms = time_ms(lambda: kp.msac_scores(E, P))
    plain = time_ms(lambda: kp.msac_scores_reference(E, P))
    record("msac_scores", (got,), (want,), ms, plain, exact=False)
    return records


def phase_frontend(config_dir: Path, frames: np.ndarray) -> None:
    """FeatureDetector on 2 frames, card vs CPU: identical keypoints and descriptors."""
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg = DetectorConfig.from_yaml(config_dir / "feature_detector.yml")
    x = torch.from_numpy(frames[:2].copy())
    kg, dg = FeatureDetector(cfg, device="cuda").detect_and_compute_batch(x.cuda())
    kc, dc = FeatureDetector(cfg, device="cpu").detect_and_compute_batch(x)
    for name in ("xy", "response", "valid"):
        if not torch.equal(getattr(kg, name).cpu(), getattr(kc, name)):
            raise AssertionError(f"frontend: keypoint {name} differs between the card and the CPU")
    if not torch.equal(dg.cpu(), dc):
        raise AssertionError("frontend: descriptors differ between the card and the CPU")
    angle_err = float((kg.angle.cpu() - kc.angle).abs().max())
    if angle_err > 1e-3:  # atan2 is a libm call on each side
        raise AssertionError(f"frontend: angles differ by {angle_err} deg")
    log(f"[frontend] card == CPU on 2 frames: {int(kc.valid.sum())} keypoints, "
        f"descriptors identical, max angle diff {angle_err:.2e} deg")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts
    from tpuslam_torch.kernels.build import library
    from tpuslam_torch.model.slam import SlamPipeline

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = library()
    log(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    config_dir = REPO / "configs"
    camera = Camera.from_yaml(config_dir / "camera.yml")
    config = SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH)
    pipeline = SlamPipeline(camera, config, device="cuda")
    frames_np = load_frames(N_FRAMES)
    frames = torch.from_numpy(frames_np).cuda()

    records = phase_kernels(pipeline, frames[:BATCH])
    phase_frontend(config_dir, frames_np)

    chunks = frames.reshape(-1, BATCH, *frames.shape[1:])
    valid = torch.ones(chunks.shape[:2], dtype=torch.bool)
    t0 = time.perf_counter()
    pipeline.process_sequence(chunks, valid, pipeline.initial_state(), seed=1)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    t0 = time.perf_counter()
    result, state = pipeline.process_sequence(chunks, valid, pipeline.initial_state(), seed=0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    log(f"[main] launches {counts}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path did not launch: {missing}")
    poses = result.poses.reshape(-1, 4, 4).cpu().numpy().astype(np.float64)
    pose_ok = result.pose_ok.reshape(-1).cpu().numpy()
    n_inl = result.num_inliers.reshape(-1).cpu().numpy()
    if not np.isfinite(poses).all():
        raise AssertionError("non-finite poses")
    ok_frac = float(pose_ok[1:].mean())
    rel = np.stack([np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, len(poses))])
    step = rel[:, :3, 3][pose_ok[1:]]
    z_dominant = float(np.mean(np.abs(step[:, 2]) >= 0.9 * np.linalg.norm(step, axis=1)))
    fps = N_FRAMES / run_s
    log(f"[main] VO {N_FRAMES} frames batch {BATCH}: warm-up {warm_s:.2f} s, timed {run_s:.3f} s "
        f"= {fps:.2f} frames/s on {card}; pose_ok {ok_frac:.3f} of frames 1..{N_FRAMES - 1}, "
        f"median inliers {float(np.median(n_inl[1:])):.0f}, z-dominant steps {z_dominant:.3f}, "
        f"z after frame 9 {poses[9, 2, 3]:.3f}")
    if ok_frac < 0.9:
        raise AssertionError(f"pose_ok on only {ok_frac:.3f} of frames")
    if z_dominant < 0.9 or poses[9, 2, 3] <= 0:
        raise AssertionError("motion is not dominantly along +z")

    for r in records:
        r["launches"] = counts[r["name"]]
    log(json.dumps({"kernels": records, "vo_fps": fps, "vo_frames": N_FRAMES, "batch": BATCH}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
