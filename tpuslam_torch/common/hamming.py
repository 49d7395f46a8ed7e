"""Hamming distance over packed binary descriptors (port of ``tpuslam/common/hamming.py``).

The full (N1, N2) distance matrix comes from the bit-plane identity
``ham(a, b) = |a| + |b| − 2·(a_bits · b_bits)``.  The bit planes are 0/1
float32 and the product is a float32 matmul: every partial sum is an
integer below 2^24, so the result is exact (TF32 is off, see the package
docstring).  ``int8 @ int8`` is not an option in torch: it returns int8 and
overflows.

Torch has no popcount.  ``popcount_bytes`` is a 256-entry table lookup;
``hamming_distance`` counts bits SWAR-style on 32-bit words where the byte
count allows (descriptors of 32 bytes are 8 words), so a large gather of
descriptor rows is never widened to int64 indices.
"""

from __future__ import annotations

import functools

import torch

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


@functools.lru_cache(maxsize=None)
def _popcount_table(device: torch.device) -> torch.Tensor:
    return torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32, device=device)


def popcount_bytes(x: torch.Tensor) -> torch.Tensor:
    """Population count of a uint8 tensor, elementwise, as int32 (the reference's LUT)."""
    return _popcount_table(x.device)[x.to(torch.int64)]


def _byte_counts(w: torch.Tensor) -> torch.Tensor:
    """int32 words → each byte holding the popcount of that byte (0..8)."""
    w = w - ((w >> 1) & _M1)  # the arithmetic shift's sign bits are masked away
    w = (w & _M2) + ((w >> 2) & _M2)
    return (w + (w >> 4)) & _M4


def popcount_words(w: torch.Tensor) -> torch.Tensor:
    """Sum of the popcounts of int32 words over the last dim → int32."""
    c = _byte_counts(w)
    if w.shape[-1] <= 15:  # byte sums stay below 128: add the words first, bytes once
        c = c.sum(dim=-1, dtype=torch.int32)
        return (c & 0xFF) + ((c >> 8) & 0xFF) + ((c >> 16) & 0xFF) + ((c >> 24) & 0xFF)
    c = (c & 0xFF) + ((c >> 8) & 0xFF) + ((c >> 16) & 0xFF) + ((c >> 24) & 0xFF)
    return c.sum(dim=-1, dtype=torch.int32)


def as_words(d: torch.Tensor) -> torch.Tensor | None:
    """(..., B) uint8 with B % 4 == 0 → (..., B/4) int32 view (a contiguous copy first), else None."""
    if d.shape[-1] % 4:
        return None
    return d.contiguous().view(torch.int32)


def hamming_distance(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Hamming distance between descriptor byte-vectors (..., B) uint8 → int32 (broadcasting)."""
    w1, w2 = as_words(d1), as_words(d2)
    if w1 is not None:
        return popcount_words(torch.bitwise_xor(w1, w2))
    return popcount_bytes(torch.bitwise_xor(d1, d2)).sum(dim=-1, dtype=torch.int32)


def unpack_bits(descriptors: torch.Tensor) -> torch.Tensor:
    """(..., N, B) uint8 → (..., N, 8·B) float32 {0, 1}, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=descriptors.device)
    bits = (descriptors.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*descriptors.shape[:-1], descriptors.shape[-1] * 8).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8·B) {0, 1} (bool or integer) → (..., B) uint8, LSB-first (the inverse of :func:`unpack_bits`)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 8, 8).to(torch.uint8)
    weights = (1 << torch.arange(8, device=bits.device)).to(torch.uint8)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(..., N1, N2) int32 Hamming distances between (..., N1, B) and (..., N2, B) uint8."""
    b1 = unpack_bits(d1)
    b2 = unpack_bits(d2)
    n1 = b1.sum(dim=-1)
    n2 = b2.sum(dim=-1)
    dot = torch.matmul(b1, b2.transpose(-1, -2))
    return (n1.unsqueeze(-1) + n2.unsqueeze(-2) - 2.0 * dot).to(torch.int32)
