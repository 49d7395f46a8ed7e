"""Train a binary BoW vocabulary from one or more directories of frames, on the card.

Port of ``tools/train_vocabulary.py``::

    python -m tpuslam_torch.tools.train_vocabulary -o configs/vocabulary.npz \
        tests/data/images tests/data/images_test_loop2 [--words 256 | --tree 64,64] [--iters 12]
        [--max-keypoints 512] [--seed 0] [--augment N] [--device cuda]

Each directory's ``.png``/``.jpg``/``.jpeg`` files, in sorted order, are
read through ``FrameStream`` (the port's loader: PNG and JPEG alike; the
frames of a directory share one size) and go through
``FeatureDetector(DetectorConfig(max_keypoints=...))``; the valid rows of
each ``detect_and_compute`` are one document of ``Vocabulary.fit``, which
trains a flat vocabulary of ``--words`` words or, with ``--tree K1,K2``, a
two-level tree of K1·K2 leaves, and the file is written with
``Vocabulary.save`` (the reference's ``.npz`` layout: either package reads
the other's).  ``--augment N`` adds N variants of each frame, the first N
of nine operations shuffled by ``np.random.default_rng(seed)`` (drawn again
for each frame, as the reference does): rotations by ±10 and ±20 degrees,
rescaling by 0.7 and 1.4 and back, a horizontal flip, and gammas 0.6 and
1.6 — the rotations and rescalings as OpenCV computes them
(``pre/augment.py``), on the device; the gammas in float64 numpy.  A
frame the loader cannot read is skipped with its reason, as the
reference skips a file OpenCV cannot read.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

ANGLES = (-20, -10, 10, 20)
SCALES = (0.7, 1.4)
GAMMAS = (0.6, 1.6)


def augment_ops(h: int, w: int) -> list:
    """The reference's nine operations on an (h, w) uint8 tensor, in its order before the shuffle."""
    from tpuslam_torch.pre.augment import resize_u8, rotation_matrix, warp_affine_u8

    ops = [lambda im, m=rotation_matrix((w / 2, h / 2), a): warp_affine_u8(im, m, (w, h)) for a in ANGLES]
    ops += [lambda im, s=s: resize_u8(resize_u8(im, fx=s, fy=s), (w, h)) for s in SCALES]
    ops.append(lambda im: torch.flip(im, dims=[1]))

    def gamma(im, g):
        out = np.clip(255.0 * (im.cpu().numpy() / 255.0) ** g, 0, 255).astype(np.uint8)
        return torch.from_numpy(out).to(im.device)

    ops += [lambda im, g=g: gamma(im, g) for g in GAMMAS]
    return ops


def variants(img: torch.Tensor, augment: int, seed: int):
    """The frame, then ``augment`` of its variants, in the reference's order."""
    yield img
    if not augment:
        return
    ops = augment_ops(*img.shape)
    np.random.default_rng(seed).shuffle(ops)
    for op in ops[:augment]:
        yield op(img)


def corpus(dirs: list[str], det, augment: int = 0, seed: int = 0) -> list[np.ndarray]:
    """One (n, 32) uint8 array of valid descriptors a frame (and a variant), directory by directory."""
    from tpuslam_torch.pre.native_loader import FrameDecodeError
    from tpuslam_torch.pre.stream import FrameStream

    docs = []
    for d in dirs:
        stream = FrameStream(d)
        for i, path in enumerate(stream._files):
            try:
                frame = stream.read_frames([i])[0]
            except FrameDecodeError as exc:
                print(f"{path.name}: skipped ({exc})")
                continue
            n_desc = 0
            for var in variants(torch.from_numpy(frame).to(det.device), augment, seed):
                kps, desc = det.detect_and_compute(var)
                docs.append(desc[kps.valid].cpu().numpy())
                n_desc += len(docs[-1])
            print(f"{path.name}: {n_desc} descriptors")
        stream.close()
    return docs


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Train a BoW vocabulary")
    parser.add_argument("dirs", nargs="+", help="image directories")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--words", type=int, default=256)
    parser.add_argument("--tree", default=None, metavar="K1,K2",
                        help="train a two-level tree vocabulary (e.g. 64,64 -> 4096 leaves) instead of a flat "
                             "--words one")
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--max-keypoints", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--augment", type=int, default=0,
                        help="per-image geometric/photometric variants to add (rotations, scales, flips, gamma)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)

    from tpuslam_torch.backend.vocabulary import Vocabulary
    from tpuslam_torch.config.schema import DetectorConfig
    from tpuslam_torch.frontend.detector import FeatureDetector

    det = FeatureDetector(DetectorConfig(max_keypoints=args.max_keypoints), device=args.device)
    docs = corpus(args.dirs, det, args.augment, args.seed)
    total = sum(len(c) for c in docs)
    branching = None
    if args.tree:
        k1, k2 = (int(x) for x in args.tree.split(","))
        branching = (k1, k2)
        print(f"training on {total} descriptors from {len(docs)} images → {k1}×{k2} tree ({k1 * k2} leaves)")
    else:
        print(f"training on {total} descriptors from {len(docs)} images → {args.words} words")
    vocab = Vocabulary.fit(docs, num_words=args.words, iters=args.iters, seed=args.seed, branching=branching,
                           device=args.device)
    vocab.save(args.output)
    print(f"saved to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
