"""Retrieval quality of BoW vocabularies (place recognition), with the BoW vectors made on the card.

Port of ``tools/eval_vocabulary.py``::

    python -m tpuslam_torch.tools.eval_vocabulary configs/vocabulary.npz [more.npz ...]
        [-c configs/loop_closure.yml] [--device cuda]

For each vocabulary, on the fixtures:

* loop ranking: on each loop fixture (``tests/data/images_test_loop`` and
  ``images_test_loop2``, whose last frame revisits frame 0), whether the
  last frame's best match beyond ``MinFramesDifference`` is frame 0, with
  the best / second-best margin;
* positive-pair scores: the BoW similarity of each loop fixture's first
  and last frames;
* false-candidate rate: on the KITTI forward motion of ``tests/data/images``
  (no revisit), the share of queries whose best score clears
  ``MinAbsoluteScore`` and whose best / second ratio clears
  ``RelativeScoreFactor`` — the candidates that would cost a geometric
  verification.

The BoW vectors come from ``calibrate_vocabulary._frame_bows`` on the
device; the rankings run in numpy on the host.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.tools.calibrate_vocabulary import DATA, REPO, _frame_bows


def evaluate(vocab_path: Path, lc_cfg, device: torch.device | str = "cuda") -> dict:
    """The reference's result dict of one vocabulary."""
    from tpuslam_torch.backend.vocabulary import Vocabulary
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    vocab = Vocabulary.load(vocab_path, device=device)
    det = FeatureDetector(DetectorConfig(max_keypoints=512), device=device)
    out = {"vocabulary": str(vocab_path), "words": vocab.num_words, "tree": vocab.coarse is not None}

    loops = []
    for name in ("images_test_loop", "images_test_loop2"):
        bows = _frame_bows(vocab, DATA / name, det)
        n = len(bows)
        scores = bows[:-1] @ bows[-1]
        # the temporally recent frames are out, as LoopClosure's gate has them
        eligible = np.arange(n - 1) <= (n - 1) - lc_cfg.min_frames_difference
        s = np.where(eligible, scores, -np.inf)
        order = np.argsort(-s)
        best, second = order[0], order[1] if len(order) > 1 else order[0]
        loops.append({
            "fixture": name,
            "rank0_correct": bool(best == 0),
            "best_score": float(s[best]),
            "margin": float(s[best] / max(s[second], 1e-9)),
            "positive_score": float(scores[0]),
        })
    out["loops"] = loops

    bows = _frame_bows(vocab, DATA / "images", det)
    n = len(bows)
    sim = bows @ bows.T
    false_cand = eligible_queries = 0
    for qi in range(lc_cfg.min_db_size, n):
        elig = np.arange(n) <= qi - lc_cfg.min_frames_difference
        if elig.sum() < 1:
            continue
        eligible_queries += 1
        s = np.where(elig, sim[qi], -np.inf)
        order = np.argsort(-s)
        best = s[order[0]]
        second = s[order[1]] if len(order) > 1 and np.isfinite(s[order[1]]) else 0.0
        if best >= lc_cfg.min_absolute_score and (
            second <= 0 or best / max(second, 1e-9) >= lc_cfg.relative_score_factor
        ):
            false_cand += 1
    out["forward_false_candidate_rate"] = false_cand / eligible_queries if eligible_queries else 0.0
    out["forward_queries"] = eligible_queries
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("vocabularies", nargs="+")
    parser.add_argument("-c", "--config", default="configs/loop_closure.yml")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from tpuslam_torch.config.schema import LoopClosureConfig

    lc_cfg = LoopClosureConfig.from_yaml(REPO / args.config)
    rows = [evaluate(Path(v), lc_cfg, device=args.device) for v in args.vocabularies]
    hdr = (f"{'vocabulary':<34} {'words':>6} {'tree':>5} {'loop1 ok/margin':>16} {'loop2 ok/margin':>16} "
           f"{'pos scores':>13} {'false-cand':>10}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        l1, l2 = r["loops"]
        print(f"{Path(r['vocabulary']).name:<34} {r['words']:>6} {str(r['tree']):>5} "
              f"{str(l1['rank0_correct']):>5}/{l1['margin']:>8.2f}   "
              f"{str(l2['rank0_correct']):>5}/{l2['margin']:>8.2f}   "
              f"{l1['positive_score']:.2f}/{l2['positive_score']:.2f}  "
              f"{r['forward_false_candidate_rate']:>9.1%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
