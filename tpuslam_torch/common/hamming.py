"""Hamming distance over packed binary descriptors (port of ``tpuslam/common/hamming.py``).

The full (N1, N2) distance matrix comes from the bit-plane identity
``ham(a, b) = |a| + |b| − 2·(a_bits · b_bits)``.  The bit planes are 0/1
float32 and the product is a float32 matmul: every partial sum is an
integer below 2^24, so the result is exact (TF32 is off, see the package
docstring).  ``int8 @ int8`` is not an option in torch: it returns int8 and
overflows.
"""

from __future__ import annotations

import torch


def unpack_bits(descriptors: torch.Tensor) -> torch.Tensor:
    """(..., N, B) uint8 → (..., N, 8·B) float32 {0, 1}, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=descriptors.device)
    bits = (descriptors.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*descriptors.shape[:-1], descriptors.shape[-1] * 8).to(torch.float32)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(..., N1, N2) int32 Hamming distances between (..., N1, B) and (..., N2, B) uint8."""
    b1 = unpack_bits(d1)
    b2 = unpack_bits(d2)
    n1 = b1.sum(dim=-1)
    n2 = b2.sum(dim=-1)
    dot = torch.matmul(b1, b2.transpose(-1, -2))
    return (n1.unsqueeze(-1) + n2.unsqueeze(-2) - 2.0 * dot).to(torch.int32)
