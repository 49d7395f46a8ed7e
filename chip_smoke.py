#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each fatal on failure (no CPU fallback, no caught phase):

1. device — require CUDA; print the card's name and power limit;
2. build — compile ``tpuslam_torch/csrc/*.cu`` for sm_90a from this checkout;
3. kernels — each of the five kernels against its plain PyTorch twin on the
   card, on inputs made from the KITTI fixtures: kernels 1-4 at the main
   path's shapes (1-3 exact, 4 to rtol 1e-5), kernel 5 exact at the
   pyramid's four level shapes; median device times of both (CUDA events,
   the card held back while the host queues the call), each kernel's bound
   (``*_work`` beside its wrapper, ``tpuslam_torch/kernels/bounds.py``) and,
   for kernel 3, cuBLAS's int8 product over all bins as a yardstick;
4. frontend — ``FeatureDetector`` on 2 frames on the card and on the CPU,
   with ``configs/`` and with ``configs/multiscale`` (fused NMS): keypoints
   and descriptors identical;
5. main path — VO with ``configs/`` at batch 16 over 96 frames (the fixtures
   ping-pong tiled, as ``bench.py`` does), one warm-up pass, then a timed
   pass with the kernels' launch counters zeroed just before it: kernels
   1-4 launched (6 each), kernel 5 not; ``pose_ok`` on >= 90% of frames
   1..95, and the inter-frame motion dominantly along +-z;
6. pyramid path — the same with ``configs/multiscale`` (4 levels, full
   width) and ``nms_fused=True``: exactly 24 launches of kernel 5 (4 levels
   x 6 chunks) and none of kernel 1 in the timed pass, then the same path
   with ``nms_fused=False`` (24 of kernel 1, none of kernel 5), timed in
   turns (fused, kernel 1, kernel 1, fused) for frames/s of each.

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
SLEEP_CYCLES = 2_000_000  # ~1 ms of card time, longer than the host takes to queue one call

# Kernel wrapper name → (its CUDA source, the Pallas kernel it replaces).
KERNELS = {
    "fused_frontend_batch": ("tpuslam_torch/csrc/frontend.cu", "tpuslam/kernels/frontend_pallas.py:115"),
    "fused_frontend_nms_batch": ("tpuslam_torch/csrc/nms.cu", "tpuslam/kernels/frontend_pallas.py:397"),
    "extract_brief_patches": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:62"),
    "brief_own_bin_dots": ("tpuslam_torch/csrc/brief.cu", "tpuslam/kernels/brief_pallas.py:159"),
    "msac_scores": ("tpuslam_torch/csrc/pose.cu", "tpuslam/kernels/pose_pallas.py:54"),
}
# Why library_ms is null: no single PyTorch call computes the kernel's function.
NO_LIBRARY = {
    "fused_frontend_batch": "no single PyTorch call computes a blur with FAST corners and SAD scores",
    "fused_frontend_nms_batch": "no single PyTorch call computes blur, FAST and a windowed-NMS key plane",
    "extract_brief_patches": "no single PyTorch call gathers zero-padded patches around float keypoints",
    "brief_own_bin_dots": "no single PyTorch call dots each row with its own bin's weights; "
                          "library_ms_all_bins times torch._int_mm over all bins",
    "msac_scores": "no single PyTorch call computes truncated-Sampson MSAC scores",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, hold: bool = True) -> float:
    """Median device milliseconds of ``fn()`` (CUDA events, after a warm-up).

    With ``hold`` the card sleeps before each start event while the host
    queues ``fn``'s work, so the time is the card's, not the host's
    dispatch; without it, a host gap between ``fn``'s launches adds to it.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(SLEEP_CYCLES)
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


def check_record(name, got, want, ms, plain_ms, exact, work) -> dict:
    """Hold a kernel's outputs against its twin's; its JSON record with its bound."""
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
    bound_us = work.bound_us()
    rec = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_us / 1e3, "bound_us": bound_us, "bound_by": work.bound_by(),
           "bound_share": bound_us / (ms * 1e3), "bytes": work.bytes, "ops": work.ops,
           "library_ms": None, "library_note": NO_LIBRARY[name]}
    log(f"[kernels] {name}: {tuple(got[0].shape)} max_abs_err={err} "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_us:.2f} us "
        f"({work.bound_by()}), {100 * rec['bound_share']:.1f}% of bound")
    return rec


def int_mm_all_bins(patches, bins, weights, got) -> float:
    """cuBLAS's int8 product of all patches by all bins' weights (16x kernel 3's
    multiply-accumulates): its time, after checking it agrees with kernel 3
    at each keypoint's own bin.  A yardstick only: the port never calls it."""
    b, k, s2p = patches.shape
    n_bins, p, _ = weights.t.shape
    a = patches.reshape(b * k, s2p)
    w_all = weights.t.reshape(n_bins * p, s2p).t()  # (S2p, bins·P), column-major
    dots = torch._int_mm(a, w_all)
    own = dots.reshape(b, k, n_bins, p).gather(
        2, bins.clamp(0, n_bins - 1).to(torch.int64)[..., None, None].expand(b, k, 1, p))[:, :, 0]
    in_range = (bins >= 0) & (bins < n_bins)
    if not torch.equal(own[in_range], got[in_range]):
        raise AssertionError("brief_own_bin_dots disagrees with torch._int_mm at the own bins")
    return time_ms(lambda: torch._int_mm(a, w_all))


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

    def record(name, got, want, ms, plain_ms, exact, work):
        records.append(check_record(name, got, want, ms, plain_ms, exact, work))
        return records[-1]

    # Kernel 1: blur + FAST on (16, 512, 1392) u8.
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold, taps=det.blur_kernel)
    got = kf.fused_frontend_batch(und, **args)
    want = kf.fused_frontend_reference(und, **args)
    ms = time_ms(lambda: kf.fused_frontend_batch(und, **args))
    plain = time_ms(lambda: kf.fused_frontend_reference(und, **args))
    record("fused_frontend_batch", got, want, ms, plain, exact=True, work=kf.frontend_work(*und.shape))
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
    record("extract_brief_patches", (got,), (want,), ms, plain, exact=True,
           work=kb.extract_patches_work(*blur.shape, kps.xy.shape[1], c.patch_size))
    patches = got

    # Kernel 3: own-bin dots (16, 1024, 256) i32.
    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    W, W3 = det.bin_weights, det.bin_weights_3d  # packed at detector init; the twin's view
    got = kb.brief_own_bin_dots(patches, bins, W)
    want = kb.brief_own_bin_dots_reference(patches, bins, W3)
    ms = time_ms(lambda: kb.brief_own_bin_dots(patches, bins, W))
    plain = time_ms(lambda: kb.brief_own_bin_dots_reference(patches, bins, W3))
    rec = record("brief_own_bin_dots", (got,), (want,), ms, plain, exact=True,
                 work=kb.own_bin_dots_work(bins, W))
    rec["library_ms_all_bins"] = int_mm_all_bins(patches, bins, W, got)
    rec["library_all_bins_note"] = ("torch._int_mm (cuBLAS int8) of the (B*K, S2p) patches by all "
                                    "bins' (S2p, bins*P) weights: 16x the kernel's multiply-accumulates")
    log(f"[kernels] brief_own_bin_dots: torch._int_mm over all bins {rec['library_ms_all_bins']:.4f} ms")

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
    record("msac_scores", (got,), (want,), ms, plain, exact=False,
           work=kp.msac_work(BATCH, H, P.shape[-1] // 5))
    return records


def phase_kernel5(pipeline, frames: torch.Tensor) -> dict:
    """Kernel 5 against its twin at the pyramid's level shapes, on resized undistorted frames."""
    from tpuslam_torch.common.camera import undistort_batch
    from tpuslam_torch.frontend.detector import resize_batch_u8
    from tpuslam_torch.kernels import frontend as kf

    det = pipeline.detector
    c = det.config
    und = undistort_batch(frames, pipeline.undistort_idx, pipeline.undistort_valid)
    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold,
                window=c.suppression_window_size, taps=det.blur_kernel)
    levels = det._feasible_levels(*und.shape[-2:])
    shapes = []
    for level, h, w in levels:
        img = und if level == 0 else resize_batch_u8(und, h, w)
        got = kf.fused_frontend_nms_batch(img, **args)
        want = kf.fused_frontend_nms_reference(img, **args)
        ms = time_ms(lambda: kf.fused_frontend_nms_batch(img, **args))
        plain = time_ms(lambda: kf.fused_frontend_nms_reference(img, **args))
        shapes.append(check_record("fused_frontend_nms_batch", got, want, ms, plain, exact=True,
                                   work=kf.frontend_nms_work(*img.shape)))
        if int((got[1] > 0).sum()) < BATCH * 100:
            raise AssertionError(f"kernel 5: too few survivors at {tuple(img.shape)}")
    rec = dict(shapes[0])
    rec["ms"] = sum(r["ms"] for r in shapes)  # one 16-frame chunk: the four level shapes
    rec["plain_ms"] = sum(r["plain_ms"] for r in shapes)
    for key in ("bound_us", "bytes", "ops"):
        rec[key] = sum(r[key] for r in shapes)
    rec["bound_ms"] = rec["bound_us"] / 1e3
    rec["bound_share"] = rec["bound_us"] / (rec["ms"] * 1e3)
    rec["per_level"] = [{"shape": [BATCH, h, w], "ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_us": r["bound_us"]}
                        for (_, h, w), r in zip(levels, shapes)]
    return rec


def phase_frontend(cfg_path: Path, frames: np.ndarray, nms_fused: bool) -> None:
    """FeatureDetector on 2 frames, card vs CPU: identical keypoints and descriptors."""
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    cfg = DetectorConfig.from_yaml(cfg_path)
    x = torch.from_numpy(frames[:2].copy())
    kg, dg = FeatureDetector(cfg, device="cuda", nms_fused=nms_fused).detect_and_compute_batch(x.cuda())
    kc, dc = FeatureDetector(cfg, device="cpu", nms_fused=nms_fused).detect_and_compute_batch(x)
    label = f"{cfg_path.parent.name}/{cfg_path.name}, {cfg.num_levels} level(s), nms_fused={nms_fused}"
    for name in ("xy", "response", "valid"):
        if not torch.equal(getattr(kg, name).cpu(), getattr(kc, name)):
            raise AssertionError(f"frontend ({label}): keypoint {name} differs between the card and the CPU")
    if not torch.equal(dg.cpu(), dc):
        raise AssertionError(f"frontend ({label}): descriptors differ between the card and the CPU")
    angle_err = float((kg.angle.cpu() - kc.angle).abs().max())
    if angle_err > 1e-3:  # atan2 is a libm call on each side
        raise AssertionError(f"frontend ({label}): angles differ by {angle_err} deg")
    log(f"[frontend] {label}: card == CPU on 2 frames: {int(kc.valid.sum())} keypoints, "
        f"descriptors identical, max angle diff {angle_err:.2e} deg")


def drive(pipeline, chunks: torch.Tensor, valid: torch.Tensor, seed: int):
    """One pass over the chunks with the launch counters zeroed just before it."""
    from tpuslam_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    result, _ = pipeline.process_sequence(chunks, valid, pipeline.initial_state(), seed=seed)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, launch_counts()


def check_launches(label: str, counts: dict, expected: dict) -> None:
    """``expected``: wrapper name → exact count, or None for "at least once"."""
    log(f"[{label}] launches {counts}")
    for name, want in expected.items():
        got = counts[name]
        if (got <= 0) if want is None else (got != want):
            raise AssertionError(f"{label}: {name} launched {got} times, expected "
                                 f"{'> 0' if want is None else want}")


def check_trajectory(label: str, result, run_s: float, card: str) -> float:
    """pose_ok on >= 90% of frames 1.., motion dominantly along +z; returns frames/s."""
    poses = result.poses.reshape(-1, 4, 4).cpu().numpy().astype(np.float64)
    pose_ok = result.pose_ok.reshape(-1).cpu().numpy()
    n_inl = result.num_inliers.reshape(-1).cpu().numpy()
    if not np.isfinite(poses).all():
        raise AssertionError(f"{label}: non-finite poses")
    n = len(poses)
    ok_frac = float(pose_ok[1:].mean())
    rel = np.stack([np.linalg.inv(poses[i - 1]) @ poses[i] for i in range(1, n)])
    step = rel[:, :3, 3][pose_ok[1:]]
    z_dominant = float(np.mean(np.abs(step[:, 2]) >= 0.9 * np.linalg.norm(step, axis=1)))
    fps = n / run_s
    log(f"[{label}] VO {n} frames batch {BATCH}: timed {run_s:.3f} s = {fps:.2f} frames/s on "
        f"{card}; pose_ok {ok_frac:.3f} of frames 1..{n - 1}, median inliers "
        f"{float(np.median(n_inl[1:])):.0f}, z-dominant steps {z_dominant:.3f}, "
        f"z after frame 9 {poses[9, 2, 3]:.3f}")
    if ok_frac < 0.9:
        raise AssertionError(f"{label}: pose_ok on only {ok_frac:.3f} of frames")
    if z_dominant < 0.9 or poses[9, 2, 3] <= 0:
        raise AssertionError(f"{label}: motion is not dominantly along +z")
    return fps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tpuslam_torch.common.camera import Camera
    from tpuslam_torch.config.schema import SlamConfig
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
    pyramid_dir = config_dir / "multiscale"
    camera = Camera.from_yaml(config_dir / "camera.yml")
    pipeline = SlamPipeline(camera, SlamConfig.from_yaml_dir(config_dir, batch_size=BATCH), device="cuda")
    pyr_config = SlamConfig.from_yaml_dir(pyramid_dir, batch_size=BATCH)
    pyr_camera = Camera.from_yaml(pyramid_dir / "camera.yml")
    pyramid = {fused: SlamPipeline(pyr_camera, pyr_config, device="cuda", nms_fused=fused)
               for fused in (True, False)}
    frames_np = load_frames(N_FRAMES)
    frames = torch.from_numpy(frames_np).cuda()

    records = phase_kernels(pipeline, frames[:BATCH])
    records.insert(1, phase_kernel5(pyramid[True], frames[:BATCH]))
    phase_frontend(config_dir / "feature_detector.yml", frames_np, nms_fused=False)
    phase_frontend(pyramid_dir / "feature_detector.yml", frames_np, nms_fused=True)

    chunks = frames.reshape(-1, BATCH, *frames.shape[1:])
    valid = torch.ones(chunks.shape[:2], dtype=torch.bool)
    n_chunks = chunks.shape[0]
    main_uses = ("fused_frontend_batch", "extract_brief_patches", "brief_own_bin_dots", "msac_scores")

    # Main path: configs/, kernels 1-4.
    drive(pipeline, chunks, valid, seed=1)  # warm-up
    result, run_s, main_counts = drive(pipeline, chunks, valid, seed=0)
    check_launches("main", main_counts, {**{k: None for k in main_uses}, "fused_frontend_nms_batch": 0})
    fps = check_trajectory("main", result, run_s, card)

    # Pyramid path: configs/multiscale, kernel 5 on every level, then kernel 1 on every level.
    n_levels = len(pyramid[True].detector._feasible_levels(*frames.shape[-2:]))
    per_level = n_levels * n_chunks
    expected = {
        fused: {"fused_frontend_nms_batch": per_level if fused else 0,
                "fused_frontend_batch": 0 if fused else per_level,
                "extract_brief_patches": per_level, "brief_own_bin_dots": per_level,
                "msac_scores": None}
        for fused in (True, False)
    }
    for fused in (True, False):
        drive(pyramid[fused], chunks, valid, seed=1)  # warm-up
    pyr_fps = {True: [], False: []}
    pyr_counts = {}
    for fused in (True, False, False, True):  # in turns, against drift
        result, run_s, counts = drive(pyramid[fused], chunks, valid, seed=0)
        label = f"pyramid nms_fused={fused}"
        if fused not in pyr_counts:
            check_launches(label, counts, expected[fused])
            pyr_counts[fused] = counts
        pyr_fps[fused].append(check_trajectory(label, result, run_s, card))
    log(f"[pyramid] {n_levels} levels, {N_FRAMES} frames batch {BATCH}: frames/s with kernel 5 "
        f"{pyr_fps[True]}, with kernel 1 + NMS {pyr_fps[False]} on {card}")

    for r in records:
        on_pyramid = r["name"] == "fused_frontend_nms_batch"
        r["path"] = "pyramid (configs/multiscale, nms_fused)" if on_pyramid else "main (configs/)"
        r["launches"] = (pyr_counts[True] if on_pyramid else main_counts)[r["name"]]
        r["launches_per_chunk"] = r["launches"] / n_chunks
    # the main path's kernel time per chunk, from the kernels phase, against its timed chunk
    chunk_ms = 1e3 * N_FRAMES / fps / n_chunks
    kernel_ms = sum(r["ms"] * r["launches_per_chunk"] for r in records if r["path"].startswith("main"))
    log(f"[main] kernels {kernel_ms:.4f} ms of a {chunk_ms:.2f} ms chunk "
        f"({100 * kernel_ms / chunk_ms:.2f}%)")
    log(json.dumps({"kernels": records, "vo_fps": fps, "vo_frames": N_FRAMES, "batch": BATCH,
                    "main_chunk_ms": chunk_ms, "main_kernel_ms_per_chunk": kernel_ms,
                    "pyramid_fps_nms_fused": pyr_fps[True], "pyramid_fps_kernel1": pyr_fps[False]}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
