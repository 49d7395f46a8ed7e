"""Calibrate the two loop-closure thresholds for a BoW vocabulary, with the BoW vectors made on the card.

Port of ``tools/calibrate_vocabulary.py``::

    python -m tpuslam_torch.tools.calibrate_vocabulary configs/vocabulary.npz [more.npz ...]
        [-c configs/loop_closure.yml] [--write configs/loop_closure.yml] [--device cuda]

``MinAbsoluteScore`` and ``RelativeScoreFactor`` depend on the
vocabulary's score scale (its words, depth and corpus), so thresholds set
by hand go stale whenever the vocabulary changes.  This tool picks them
from data, as the reference does:

1. the BoW vector of every frame of the loop fixtures
   (``tests/data/images_test_loop`` and ``images_test_loop2``: sequences
   whose last frame revisits frame 0, the true loops that must pass the
   gates) and of the forward-motion fixture (``tests/data/images``: no
   revisit, so whatever passes is a false candidate), computed on the
   device (``FrameStream`` → ``FeatureDetector`` → ``Vocabulary.transform``);
2. a grid of (MinAbsoluteScore × RelativeScoreFactor), each point applying
   the production gates (the grouped second best of
   ``LoopClosure``) to every query, in numpy on the host;
3. among the points where every true loop passes with its match ranked
   first, those with the fewest forward false candidates; of those the
   most balanced corner of the feasible region, then both thresholds
   backed off by 2x towards permissive.

``--write`` rewrites the two threshold keys of the given YAML in place,
comments kept (the first vocabulary's values).
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
DATA = REPO / "tests" / "data"


def _frame_bows(vocab, image_dir: Path, det) -> np.ndarray:
    """(frames, words) float32 BoW vectors of a directory's frames, computed on the detector's device."""
    from tpuslam_torch.pre.stream import FrameStream

    stream = FrameStream(image_dir)
    bows = []
    for i in range(stream.total_frames):
        frame, _ = stream.read_frame(i)
        kps, desc = det.detect_and_compute(torch.from_numpy(frame).to(det.device))
        bows.append(vocab.transform(desc, kps.valid))
    stream.close()
    return torch.stack(bows).cpu().numpy()


def _gate_pass(bows, qi, min_fd: int, abs_thr: float, rel_thr: float):
    """The production BoW gates (grouped second best) for query ``qi`` against frames < qi → (passes, best)."""
    ids = np.arange(qi)  # the DB holds every earlier frame here
    elig = ids <= qi - min_fd
    if not elig.any():
        return False, -1
    scores = bows[:qi] @ bows[qi]
    s = np.where(elig, scores, -np.inf)
    best = int(np.argmax(s))
    near_best = np.abs(ids - best) < min_fd
    second = np.where(elig & ~near_best, scores, -np.inf).max()
    second = max(float(second), 0.0)
    ok = float(s[best]) >= abs_thr and float(s[best]) >= rel_thr * second
    return ok, best


def _false_candidate_rate(fwd_bows, lc_cfg, abs_thr: float, rel_thr: float) -> float:
    queries = range(max(lc_cfg.min_db_size, lc_cfg.min_frames_difference), len(fwd_bows))
    false_cand = sum(int(_gate_pass(fwd_bows, qi, lc_cfg.min_frames_difference, abs_thr, rel_thr)[0])
                     for qi in queries)
    return false_cand / len(queries) if len(queries) else 0.0


def calibrate(vocab_path: Path, lc_cfg, verbose: bool = False, device: torch.device | str = "cuda") -> dict:
    """The calibrated operating point of one vocabulary (the reference's result dict)."""
    from tpuslam_torch.backend.vocabulary import Vocabulary
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    vocab = Vocabulary.load(vocab_path, device=device)
    det = FeatureDetector(DetectorConfig(max_keypoints=512), device=device)
    min_fd = lc_cfg.min_frames_difference
    # (bows, query, required match) of each true loop: the last frame of each loop fixture revisits frame 0
    loop_cases = []
    for name in ("images_test_loop", "images_test_loop2"):
        bows = _frame_bows(vocab, DATA / name, det)
        loop_cases.append((bows, len(bows) - 1, 0))
    fwd_bows = _frame_bows(vocab, DATA / "images", det)

    # absolute score from "accept anything" to the strongest true-loop score; the useful relative range
    true_scores = [float((b[:q] @ b[q]).max()) for b, q, _ in loop_cases]
    abs_grid = np.unique(np.concatenate([np.linspace(0.001, max(true_scores), 40),
                                         np.asarray([lc_cfg.min_absolute_score])]))
    rel_grid = np.unique(np.concatenate([np.linspace(1.0, 2.5, 31), np.asarray([lc_cfg.relative_score_factor])]))
    candidates = []
    for abs_thr in abs_grid:
        for rel_thr in rel_grid:
            if all(_gate_pass(b, qi, min_fd, abs_thr, rel_thr) == (True, want) for b, qi, want in loop_cases):
                candidates.append((_false_candidate_rate(fwd_bows, lc_cfg, abs_thr, rel_thr), float(abs_thr),
                                   float(rel_thr)))
    if not candidates:
        return {"vocabulary": str(vocab_path), "words": vocab.num_words, "feasible": False}
    # the most balanced corner of the fewest-false-candidate points, then 2x back toward permissive:
    # recall is monotone in both thresholds, so the backed-off point stays feasible with headroom
    best_rate = min(c[0] for c in candidates)
    sel = [c for c in candidates if c[0] == best_rate]
    abs_max = max(a for _, a, _ in sel)
    rel_span = max(r - 1.0 for _, _, r in sel)

    def balance(c):
        _, a, r = c
        return min(a / abs_max, (r - 1.0) / max(rel_span, 1e-9))

    _, a_star, r_star = max(sel, key=balance)
    abs_rec = a_star / 2.0
    rel_rec = 1.0 + (r_star - 1.0) / 2.0
    return {
        "vocabulary": str(vocab_path),
        "words": vocab.num_words,
        "tree": vocab.coarse is not None,
        "feasible": True,
        "min_absolute_score": round(float(abs_rec), 4),
        "relative_score_factor": round(float(rel_rec), 3),
        "recall_envelope": (round(float(a_star), 4), round(float(r_star), 3)),
        "forward_false_candidate_rate": round(_false_candidate_rate(fwd_bows, lc_cfg, abs_rec, rel_rec), 4),
        "shipped_abs": lc_cfg.min_absolute_score,
        "shipped_rel": lc_cfg.relative_score_factor,
    }


def write_thresholds(yml_path: Path, abs_thr: float, rel_thr: float) -> None:
    """In-place edit of the two threshold keys, comments preserved."""
    text = yml_path.read_text()
    text = re.sub(r"(?m)^MinAbsoluteScore:.*$", f"MinAbsoluteScore: {abs_thr}", text)
    text = re.sub(r"(?m)^RelativeScoreFactor:.*$", f"RelativeScoreFactor: {rel_thr}", text)
    yml_path.write_text(text)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("vocabularies", nargs="+")
    parser.add_argument("-c", "--config", default="configs/loop_closure.yml")
    parser.add_argument("--write", default=None, metavar="YML",
                        help="write the FIRST vocabulary's calibrated thresholds into this loop_closure.yml")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from tpuslam_torch.config.schema import LoopClosureConfig

    lc_cfg = LoopClosureConfig.from_yaml(REPO / args.config)
    rows = [calibrate(Path(v), lc_cfg, device=args.device) for v in args.vocabularies]
    hdr = f"{'vocabulary':<34} {'words':>6} {'abs':>8} {'rel':>6} {'false-cand':>10}  (shipped abs/rel)"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if not r.get("feasible"):
            print(f"{Path(r['vocabulary']).name:<34} {r['words']:>6} INFEASIBLE — no grid point keeps every true loop")
            continue
        print(f"{Path(r['vocabulary']).name:<34} {r['words']:>6} {r['min_absolute_score']:>8.4f} "
              f"{r['relative_score_factor']:>6.2f} {r['forward_false_candidate_rate']:>9.1%}  "
              f"({r['shipped_abs']}/{r['shipped_rel']}; recall envelope "
              f"{r['recall_envelope'][0]}/{r['recall_envelope'][1]})")
    if args.write and rows and rows[0].get("feasible"):
        write_thresholds(Path(args.write), rows[0]["min_absolute_score"], rows[0]["relative_score_factor"])
        print(f"wrote thresholds to {args.write}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
