"""Binary visual vocabulary: bag-of-words for place recognition.

Port of ``tpuslam/backend/vocabulary.py`` (loading, assignment, TF-IDF
transform, scoring; the trainers stay in the reference package).  Both
packages read the same ``.npz`` files: ``centroids`` (W, B) uint8, ``idf``
(W,) float32 and, for the two-level tree, ``coarse`` (k1, B) uint8 with
leaf ``c·k2 + j`` = child j of coarse word c.

Assignment is a Hamming argmin with the lowest index winning ties, as
``jnp.argmin``: flat, one bit-plane matmul over all W words; tree, the
coarse argmin by the same matmul, then XOR + popcount against the word's
k2 children on 32-bit words (a (…, K, k2, B/4) int32 gather, never
widened to int64).  The BoW vector is the per-word count of valid
keypoints times the IDF, L2-normalised; an empty input gives the zero
vector.  Every function takes leading batch dimensions.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.common.hamming import as_words, hamming_distance, hamming_matrix, popcount_words


class Vocabulary:
    """Centroids (flat or tree leaves), optional coarse words and IDF weights on ``device``."""

    def __init__(
        self,
        centroids,
        idf=None,
        coarse=None,
        device: torch.device | str = "cpu",
    ):
        self.device = torch.device(device)
        self.centroids = torch.as_tensor(np.asarray(centroids), dtype=torch.uint8).to(self.device)  # (W, B)
        w = self.centroids.shape[0]
        self.coarse = None if coarse is None else torch.as_tensor(np.asarray(coarse), dtype=torch.uint8).to(self.device)
        if self.coarse is not None and w % self.coarse.shape[0]:
            raise ValueError(f"leaf count {w} not a multiple of coarse count {self.coarse.shape[0]}")
        idf = np.ones(w) if idf is None else np.asarray(idf)
        self.idf = torch.as_tensor(idf, dtype=torch.float32).to(self.device)

    @property
    def num_words(self) -> int:
        return int(self.centroids.shape[0])

    def __len__(self) -> int:
        return self.num_words

    def to(self, device: torch.device | str) -> "Vocabulary":
        return Vocabulary(self.centroids.cpu(), self.idf.cpu(),
                          None if self.coarse is None else self.coarse.cpu(), device=device)

    # --- persistence -----------------------------------------------------------
    def save(self, path: str | Path) -> None:
        arrays = dict(centroids=self.centroids.cpu().numpy(), idf=self.idf.cpu().numpy())
        if self.coarse is not None:
            arrays["coarse"] = self.coarse.cpu().numpy()
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str | Path, device: torch.device | str = "cpu") -> "Vocabulary":
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"Vocabulary not found at path: {path}")
        data = np.load(path)
        if data["centroids"].size == 0:
            raise ValueError(f"Vocabulary is empty at path: {path}")
        return cls(data["centroids"], data["idf"], coarse=data["coarse"] if "coarse" in data else None,
                   device=device)

    # --- transform / scoring ------------------------------------------------------
    def assign(self, descriptors: torch.Tensor) -> torch.Tensor:
        """(…, K, B) uint8 → (…, K) int64 word (flat) or leaf (tree) ids."""
        if self.coarse is None:
            return torch.argmin(hamming_matrix(descriptors, self.centroids), dim=-1)
        k1 = self.coarse.shape[0]
        return _assign_tree(descriptors, self.coarse, self.centroids.reshape(k1, -1, self.centroids.shape[1]))

    def transform(self, descriptors: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
        """(…, K, B) uint8 (+ optional (…, K) mask) → (…, W) L2-normalised TF-IDF BoW."""
        return _bow_from_assign(self.assign(descriptors), valid, self.num_words, self.idf)

    @staticmethod
    def score(bow1: torch.Tensor, bow2: torch.Tensor) -> torch.Tensor:
        """Cosine similarity of BoW vectors (…, W)."""
        return torch.sum(bow1 * bow2, dim=-1)


def _assign_tree(descriptors: torch.Tensor, coarse: torch.Tensor, leaves_r: torch.Tensor) -> torch.Tensor:
    """Two-level quantisation: (…, K, B) uint8 → (…, K) leaf ids a1·k2 + a2."""
    a1 = torch.argmin(hamming_matrix(descriptors, coarse), dim=-1)  # (…, K)
    k2 = leaves_r.shape[1]
    wq, wl = as_words(descriptors), as_words(leaves_r)
    if wq is not None:
        children = wl[a1]  # (…, K, k2, B/4) int32
        d2 = popcount_words(torch.bitwise_xor(wq[..., None, :], children))
    else:
        d2 = hamming_distance(descriptors[..., None, :], leaves_r[a1])
    return a1 * k2 + torch.argmin(d2, dim=-1)


def _bow_from_assign(assign: torch.Tensor, valid: torch.Tensor | None, num_words: int, idf: torch.Tensor):
    lead = assign.shape[:-1]
    w = torch.ones(assign.shape, dtype=torch.float32, device=assign.device) if valid is None else valid.float()
    tf = torch.zeros((*lead, num_words), dtype=torch.float32, device=assign.device)
    tf = tf.scatter_add_(-1, assign, w)  # integer counts: exact in any order
    v = tf * idf
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(norm > 0, v / torch.clamp_min(norm, 1e-12), v)
