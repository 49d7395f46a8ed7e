#!/usr/bin/env python3
"""Kernel times of several checkouts of the port, by one yardstick, on one GPU.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example a parent commit
unpacked with ``git archive``, and ``.``); give them in turns (A B B A)
against drift.  Each runs in a process of its own, since each has its own
``tpuslam_torch``: the process builds that checkout's kernels, makes the
main path's inputs from the KITTI fixtures as ``chip_smoke.py`` does
(16 undistorted frames, ``configs/``; kernel 5 at the four level shapes of
``configs/multiscale`` and, as its dense case, on uniform noise at the
largest of them; kernel 4's hypotheses and operand by that script's
``msac_inputs``), checks kernels 1, 2, 3 and 5 bit-exact against that
checkout's twins and kernel 4 within rtol 1e-5 of its twin, and times each
wrapper as the path calls it with ``time_ms`` of the ``chip_smoke.py``
beside this script — with the card held back while the host queues the
call (``hold``, device time) and without (a host gap between launches adds
to it) — whichever checkout's code it times.  A digest of each kernel's
outputs shows whether two checkouts compute the same bits; the run fails
if they do not.  Kernel 4 alone may sum its matches in another order in
another checkout: for it the summary gives the largest difference between
any two checkouts' scores in place of the digest's verdict.

Prints one JSON line per checkout, then a summary line: each kernel's
times run by run and their means per checkout (kernel 5's also level by
level, at the pyramid's four shapes), and a verdict that names the kernels
whose output bits are identical in every checkout.
"""

from __future__ import annotations

import base64
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BATCH = 16


def _yardstick():
    """This checkout's ``chip_smoke.py``, whichever ``tpuslam_torch`` is imported."""
    spec = importlib.util.spec_from_file_location("yardstick", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def pretest_group_share(images, threshold: int) -> float:
    """Share of the aligned 4-pixel groups of (B, H, W) uint8 images in which some pixel
    of the 3-px interior passes FAST's pretest (>= 3 of circle pixels 0, 4, 8, 12 brighter
    than centre + threshold, or >= 3 darker): the groups whose rings kernel 5 computes."""
    import torch

    x = images.to(torch.int16)
    c = x[:, 3:-3, 3:-3]
    ring = (x[:, :-6, 3:-3], x[:, 3:-3, 6:], x[:, 6:, 3:-3], x[:, 3:-3, :-6])
    bright = sum((n > c + threshold).to(torch.int8) for n in ring)
    dark = sum((n < c - threshold).to(torch.int8) for n in ring)
    passes = torch.zeros(images.shape, dtype=torch.bool, device=images.device)
    passes[:, 3:-3, 3:-3] = (bright >= 3) | (dark >= 3)
    w4 = images.shape[-1] // 4 * 4
    return float(passes[..., :w4].reshape(*images.shape[:2], w4 // 4, 4).any(-1).float().mean())


def run_one(root: Path) -> dict:
    """Time one checkout's kernel wrappers; its record."""
    sys.path.insert(0, str(root))
    import torch

    import tpuslam_torch
    from tpuslam_torch.common.camera import Camera, undistort_batch
    from tpuslam_torch.config.schema import SlamConfig
    from tpuslam_torch.frontend.brief import orientations_from_patches, quantize_angles
    from tpuslam_torch.frontend.detector import resize_batch_u8
    from tpuslam_torch.frontend.fast import select_keypoints
    from tpuslam_torch.kernels import brief as kb
    from tpuslam_torch.kernels import frontend as kf
    from tpuslam_torch.kernels import pose as kp
    from tpuslam_torch.kernels.build import library
    from tpuslam_torch.model.slam import SlamPipeline

    if Path(tpuslam_torch.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {tpuslam_torch.__file__}, not the checkout at {root}")
    yard = _yardstick()
    library()
    out = {"root": str(root), "kernels": {}}

    def timed(name, fn, twin, shape=None):
        got, want = fn(), twin()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{root}: {name} disagrees with its twin at {int((g != w).sum())}")
        rec = {"ms": yard.time_ms(fn), "ms_no_hold": yard.time_ms(fn, hold=False),
               "digest": _digest(got)}
        if shape is not None:
            rec["shape"] = shape
        return got, rec

    def pipeline(cfg_dir: Path):
        return SlamPipeline(Camera.from_yaml(cfg_dir / "camera.yml"),
                            SlamConfig.from_yaml_dir(cfg_dir, batch_size=BATCH), device="cuda")

    frames = torch.from_numpy(yard.load_frames(BATCH)).cuda()
    pipe = pipeline(root / "configs")
    det, c = pipe.detector, pipe.detector.config
    und = undistort_batch(frames, pipe.undistort_idx, pipe.undistort_valid)

    args = dict(threshold=c.intensity_threshold, contiguous=c.contiguous_pixels_threshold,
                taps=det.blur_kernel)
    (blur, corner, score), out["kernels"]["fused_frontend_batch"] = timed(
        "kernel 1", lambda: kf.fused_frontend_batch(und, **args),
        lambda: kf.fused_frontend_reference(und, **args))
    kps = select_keypoints(corner, score, nms=c.non_max_suppression,
                           window=c.suppression_window_size, max_keypoints=c.max_keypoints)

    (patches,), out["kernels"]["extract_brief_patches"] = timed(
        "kernel 2", lambda: kb.extract_brief_patches(blur, kps.xy, c.patch_size),
        lambda: kb.extract_brief_patches_reference(blur, kps.xy, c.patch_size))

    angles = orientations_from_patches(patches, det.moment_weights, kps, c.patch_size, blur.shape[-2:])
    bins = quantize_angles(angles, c.brief_quantized_bins)
    # the weights as the detector hands them to the wrapper: packed at init where it does so
    weights = det.bin_weights if hasattr(det, "bin_weights") else det.bin_weights_3d
    _, out["kernels"]["brief_own_bin_dots"] = timed(
        "kernel 3", lambda: kb.brief_own_bin_dots(patches, bins, weights),
        lambda: kb.brief_own_bin_dots_reference(patches, bins, det.bin_weights_3d))

    E, P = yard.msac_inputs(pipe, blur, kps)
    scores = kp.msac_scores(E, P)
    yard.require_msac_close(f"{root}: kernel 4", scores, kp.msac_scores_reference(E, P))
    out["kernels"]["msac_scores"] = {
        "ms": yard.time_ms(lambda: kp.msac_scores(E, P)),
        "ms_no_hold": yard.time_ms(lambda: kp.msac_scores(E, P), hold=False),
        "digest": _digest((scores,)), "shape": [*E.shape[:2], P.shape[-1] // 5],
        "scores_f32": base64.b64encode(scores.cpu().numpy().tobytes()).decode(),
    }

    pyr = pipeline(root / "configs" / "multiscale")
    det5, c5 = pyr.detector, pyr.detector.config
    und5 = undistort_batch(frames, pyr.undistort_idx, pyr.undistort_valid)
    args5 = dict(threshold=c5.intensity_threshold, contiguous=c5.contiguous_pixels_threshold,
                 window=c5.suppression_window_size, taps=det5.blur_kernel)
    levels = []
    for level, h, w in det5._feasible_levels(*und5.shape[-2:]):
        img = und5 if level == 0 else resize_batch_u8(und5, h, w)
        levels.append(timed(f"kernel 5 at {h}x{w}", lambda: kf.fused_frontend_nms_batch(img, **args5),
                            lambda: kf.fused_frontend_nms_reference(img, **args5), [BATCH, h, w])[1])
        levels[-1]["pretest_group_share"] = pretest_group_share(img, c5.intensity_threshold)
    out["kernels"]["fused_frontend_nms_batch"] = {
        "ms": sum(r["ms"] for r in levels), "ms_no_hold": sum(r["ms_no_hold"] for r in levels),
        "digest": hashlib.sha256("".join(r["digest"] for r in levels).encode()).hexdigest()[:16],
        "per_level": levels,
    }
    # Kernel 5's time depends on the data where it lists the pixel groups that pass FAST's
    # pretest: uniform noise at the largest level shape, where most groups do, is its dense case.
    noise = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, *und5.shape[-2:]), dtype=np.uint8)).cuda()
    out["kernels"]["fused_frontend_nms_batch_on_noise"] = timed(
        "kernel 5 on noise", lambda: kf.fused_frontend_nms_batch(noise, **args5),
        lambda: kf.fused_frontend_nms_reference(noise, **args5), list(noise.shape))[1]
    out["kernels"]["fused_frontend_nms_batch_on_noise"]["pretest_group_share"] = pretest_group_share(
        noise, c5.intensity_threshold)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    runs, scores = [], []  # kernel 4's scores of each run, kept out of the printed records
    for root in argv:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root],
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"kernel_ab: {root} failed ({proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        scores.append(np.frombuffer(base64.b64decode(
            runs[-1]["kernels"]["msac_scores"].pop("scores_f32")), dtype=np.float32))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for name in runs[0]["kernels"]:
        recs = [r["kernels"][name] for r in runs]
        by_root = {}
        for r, rec in zip(runs, recs):
            by_root.setdefault(r["root"], []).append(rec)
        summary[name] = {
            "ms": [rec["ms"] for rec in recs], "ms_no_hold": [rec["ms_no_hold"] for rec in recs],
            "mean_ms_by_root": {root: sum(x["ms"] for x in v) / len(v) for root, v in by_root.items()},
            "mean_ms_no_hold_by_root": {root: sum(x["ms_no_hold"] for x in v) / len(v)
                                        for root, v in by_root.items()},
            "same_bits": len({rec["digest"] for rec in recs}) == 1,
        }
        if "pretest_group_share" in recs[-1]:
            summary[name]["pretest_group_share"] = recs[-1]["pretest_group_share"]
        if "per_level" in recs[0]:  # kernel 5: the pyramid's level shapes, one by one
            summary[name]["level_shapes"] = [lv["shape"] for lv in recs[0]["per_level"]]
            summary[name]["level_pretest_group_share"] = [
                lv["pretest_group_share"] for lv in recs[-1]["per_level"]]
            for key in ("ms", "ms_no_hold"):
                summary[name][f"mean_level_{key}_by_root"] = {
                    root: [sum(x["per_level"][i][key] for x in v) / len(v)
                           for i in range(len(v[0]["per_level"]))]
                    for root, v in by_root.items()}
    summary["msac_scores"]["max_abs_diff_between_checkouts"] = max(
        float(np.abs(a - b).max()) for a in scores for b in scores)
    differ = [name for name, s in summary.items() if not s["same_bits"] and name != "msac_scores"]
    same = [name for name in summary if name not in differ and name != "msac_scores"]
    verdict = (f"{len(set(r['root'] for r in runs))} checkout(s), {len(runs)} run(s): identical output "
               f"bits in {same}" + (f", different bits in {differ}" if differ else ""))
    print(json.dumps({"order": [r["root"] for r in runs], "summary": summary, "verdict": verdict}),
          flush=True)
    if differ:
        print(f"kernel_ab: the checkouts compute different bits in {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
