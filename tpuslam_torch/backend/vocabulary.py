"""Binary visual vocabulary: bag-of-words for place recognition.

Port of ``tpuslam/backend/vocabulary.py``: loading, assignment, TF-IDF
transform, scoring, and training (``train_vocabulary``,
``train_vocabulary_tree``, ``Vocabulary.fit``).  Both packages read the
same ``.npz`` files: ``centroids`` (W, B) uint8, ``idf`` (W,) float32 and,
for the two-level tree, ``coarse`` (k1, B) uint8 with leaf ``c·k2 + j`` =
child j of coarse word c.

Assignment is a Hamming argmin with the lowest index winning ties, as
``jnp.argmin``: flat, one bit-plane matmul over all W words; tree, the
coarse argmin by the same matmul, then XOR + popcount against the word's
k2 children on 32-bit words (a (…, K, k2, B/4) int32 gather, never
widened to int64).  The BoW vector is the per-word count of valid
keypoints times the IDF, L2-normalised; an empty input gives the zero
vector.  Every function takes leading batch dimensions.

Training is binary k-means on the device: the numpy ``default_rng(seed)``
draws (initial centroids, thin-cell pads) and the host-side reseed of
empty clusters are the reference's own numpy code, so both packages train
the same words from the same descriptors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpuslam_torch.common.hamming import (
    as_words,
    hamming_distance,
    hamming_matrix,
    pack_bits,
    popcount_words,
    unpack_bits,
)


def train_vocabulary(
    descriptors: np.ndarray,
    num_words: int = 256,
    iters: int = 10,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Binary k-means over (N, B) uint8 descriptors → (num_words, B) uint8 centroids.

    Assignment: the nearest centroid by Hamming distance, the first on a
    tie.  Update: the per-bit majority vote ``sums / max(count, 1) > 0.5``
    in float32 (integer sums: exact in any order).  An empty cluster keeps
    its centroid, then is reseeded on the host from the descriptors
    farthest from theirs (numpy's ``argsort``, as the reference).
    """
    rng = np.random.default_rng(seed)
    desc_np = np.asarray(descriptors, np.uint8)
    n = desc_np.shape[0]
    if n < num_words:
        raise ValueError(f"Need at least {num_words} descriptors, got {n}.")
    init = rng.choice(n, num_words, replace=False)
    desc = torch.from_numpy(desc_np).to(device)
    centroids = desc[torch.from_numpy(init).to(device)]
    bits = unpack_bits(desc)  # (N, 8B) float32
    for _ in range(iters):
        d = hamming_matrix(desc, centroids)  # (N, W) int32
        assign = torch.argmin(d, dim=1)
        min_d = d.amin(dim=1)
        counts = torch.bincount(assign, minlength=num_words).to(torch.float32)
        sums = torch.zeros((num_words, bits.shape[1]), dtype=torch.float32, device=desc.device)
        sums.index_add_(0, assign, bits)
        new = pack_bits(sums / torch.clamp_min(counts[:, None], 1.0) > 0.5)
        centroids = torch.where(counts[:, None] > 0, new, centroids)
        empty = (counts == 0).cpu().numpy()
        if empty.any():
            far = np.argsort(-min_d.cpu().numpy())[: int(empty.sum())]
            cnp = centroids.cpu().numpy()
            cnp[np.nonzero(empty)[0]] = desc_np[far]
            centroids = torch.from_numpy(cnp).to(device)
    return centroids.cpu().numpy()


def train_vocabulary_tree(
    descriptors: np.ndarray,
    branching: tuple[int, int] = (64, 64),
    iters: int = 10,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Two-level tree k-means: (coarse (k1, B), leaves (k1·k2, B)) uint8, leaf c·k2 + j = child j of word c.

    Each coarse cell trains its k2 children with seed + 2 + c; a cell with
    fewer than k2 members takes them all and pads with members drawn by
    ``default_rng(seed + 1)``; an empty cell repeats its coarse word.
    """
    k1, k2 = branching
    descriptors = np.asarray(descriptors, np.uint8)
    coarse = train_vocabulary(descriptors, k1, iters, seed, device)
    d = hamming_matrix(torch.from_numpy(descriptors).to(device), torch.from_numpy(coarse).to(device))
    a1 = torch.argmin(d, dim=1).cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    leaves = np.zeros((k1 * k2, descriptors.shape[1]), np.uint8)
    for c in range(k1):
        sub = descriptors[a1 == c]
        if len(sub) >= k2:
            leaves[c * k2 : (c + 1) * k2] = train_vocabulary(sub, k2, iters, seed + 2 + c, device)
        elif len(sub) > 0:  # a thin cell: every member a leaf, the rest duplicates (argmin picks the first)
            pad = sub[rng.integers(0, len(sub), k2 - len(sub))]
            leaves[c * k2 : (c + 1) * k2] = np.concatenate([sub, pad])
        else:
            leaves[c * k2 : (c + 1) * k2] = coarse[c]
    return coarse, leaves


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
    def load(cls, path: str | Path, device: torch.device | str = "cuda") -> "Vocabulary":
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"Vocabulary not found at path: {path}")
        data = np.load(path)
        if data["centroids"].size == 0:
            raise ValueError(f"Vocabulary is empty at path: {path}")
        return cls(data["centroids"], data["idf"], coarse=data["coarse"] if "coarse" in data else None,
                   device=device)

    @classmethod
    def fit(
        cls,
        descriptors: np.ndarray | list[np.ndarray],
        num_words: int = 256,
        iters: int = 10,
        seed: int = 0,
        branching: tuple[int, int] | None = None,
        device: torch.device | str = "cuda",
    ) -> "Vocabulary":
        """Train centroids and IDF weights from a descriptor corpus, on ``device``.

        A list of per-image descriptor arrays makes each image one document;
        a single array is one document per 500 descriptors.
        ``branching=(k1, k2)`` trains the two-level tree with k1·k2 leaves
        instead of a flat ``num_words``.  IDF = log((docs + 1) / (occurrences
        + 1)) + 1, in float64, stored as float32.
        """
        if isinstance(descriptors, np.ndarray):
            docs = [descriptors[i : i + 500] for i in range(0, len(descriptors), 500)]
        else:
            docs = [d for d in descriptors if len(d)]
        all_desc = np.concatenate(docs)
        if branching is not None:
            coarse, centroids = train_vocabulary_tree(all_desc, branching, iters, seed, device)
            vocab = cls(centroids, coarse=coarse, device=device)
        else:
            vocab = cls(train_vocabulary(all_desc, num_words, iters, seed, device), device=device)
        occurrence = np.zeros(vocab.num_words)
        for doc in docs:
            leaves = vocab.assign(torch.from_numpy(np.asarray(doc, np.uint8)).to(vocab.device))
            occurrence[np.unique(leaves.cpu().numpy())] += 1
        idf = np.log((len(docs) + 1) / (occurrence + 1)) + 1.0
        vocab.idf = torch.as_tensor(idf, dtype=torch.float32).to(vocab.device)
        return vocab

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
