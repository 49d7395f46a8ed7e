"""Kernel 4 wrapper: MSAC hypothesis scores (``csrc/pose.cu``).

Replaces ``tpuslam/kernels/pose_pallas.py::msac_scores_pallas``.  Every
per-match quantity of the truncated Sampson error is a dot product with
``e = vec(E)``: the numerator ``x2ᵀ E x1`` and the four gradient terms of
the denominator.  :func:`build_msac_operand` packs those five 9-vectors of
every match into a (9, 5M) operand (plain torch, as in the reference
package); the kernel scores all hypotheses against it without
materialising the (H, M) error tensor.
"""

from __future__ import annotations

import torch

from tpuslam_torch.kernels.bounds import PEAK_F32_OPS, Work
from tpuslam_torch.kernels.build import library


def build_msac_operand(
    x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, thr: torch.Tensor | float
) -> torch.Tensor:
    """(..., 9, 5M) operand: [vec(x2ₕx1ₕᵀ)/√thr | E-row terms vs x1ₕ (2) | E-column terms vs x2ₕ (2)].

    Invalid matches are zeroed in every block, so they score exactly 0.
    """
    ones = torch.ones((*x1.shape[:-1], 1), dtype=x1.dtype, device=x1.device)
    v = valid.to(x1.dtype)[..., None]
    x1h = torch.cat([x1, ones], dim=-1) * v  # (..., M, 3)
    x2h = torch.cat([x2, ones], dim=-1) * v
    scale = 1.0 / torch.sqrt(torch.as_tensor(thr, dtype=x1.dtype, device=x1.device))
    t9 = (x2h[..., :, None] * x1h[..., None, :]).reshape(*x1.shape[:-1], 9) * scale
    z = torch.zeros_like(x1h)
    a1 = torch.cat([x1h, z, z], dim=-1)  # (Ex1)_0 = e[0:3]·x1h
    a2 = torch.cat([z, x1h, z], dim=-1)  # (Ex1)_1 = e[3:6]·x1h
    b1 = torch.zeros((*x1.shape[:-1], 9), dtype=x1.dtype, device=x1.device)
    b2 = torch.zeros_like(b1)
    b1[..., 0::3] = x2h  # (Eᵀx2)_0 = Σᵢ E[i,0]·x2h[i]
    b2[..., 1::3] = x2h  # (Eᵀx2)_1
    stacked = torch.cat([t9, a1, a2, b1, b2], dim=-2)  # (..., 5M, 9)
    return stacked.transpose(-1, -2).contiguous()


def msac_scores_reference(E_flat: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel 4: (B, H, 9) × (B, 9, 5M) → (B, H) MSAC scores.

    The nine products are added in index order, each rounded to float32 —
    the kernel's order; only the final sum over matches is reduced in
    another order.
    """
    m = P.shape[-1] // 5
    big = E_flat[..., 0, None] * P[:, None, 0, :]
    for i in range(1, 9):
        big = big + E_flat[..., i, None] * P[:, None, i, :]  # (B, H, 5M)
    err = big[..., :m]
    a1 = big[..., m : 2 * m]
    a2 = big[..., 2 * m : 3 * m]
    b1 = big[..., 3 * m : 4 * m]
    b2 = big[..., 4 * m :]
    denom = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2
    e2 = (err * err) / torch.clamp_min(denom, 1e-18)
    return torch.clamp_max(e2, 1.0).sum(dim=-1)


def msac_scores(E_flat: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """(B, H) truncated-Sampson scores; invalid (zeroed) matches contribute 0."""
    if E_flat.dtype != torch.float32 or E_flat.dim() != 3 or E_flat.shape[-1] != 9:
        raise ValueError(f"E_flat must be (B, H, 9) float32, got {E_flat.dtype} {tuple(E_flat.shape)}")
    b, h, _ = E_flat.shape
    if P.dtype != torch.float32 or P.dim() != 3 or P.shape[0] != b or P.shape[1] != 9 or P.shape[2] % 5:
        raise ValueError(f"P must be (B, 9, 5M) float32, got {P.dtype} {tuple(P.shape)}")
    if P.device != E_flat.device:
        raise ValueError("E_flat and P must be on one device")
    if E_flat.device.type == "cpu":
        return msac_scores_reference(E_flat, P)
    if E_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {E_flat.device}")
    e = E_flat.contiguous()
    p = P.contiguous()
    out = torch.empty((b, h), dtype=torch.float32, device=e.device)
    if b * h:
        with torch.cuda.device(e.device):
            library().call(
                "tpuslam_msac_scores", e.data_ptr(), p.data_ptr(), out.data_ptr(),
                b, h, p.shape[-1] // 5, torch.cuda.current_stream().cuda_stream,
            )
        msac_scores.launches += 1
    return out


msac_scores.launches = 0


def msac_work(b: int, h: int, m: int) -> Work:
    """Bytes and float32 operations of one call: 97 per (hypothesis, match).

    Five 9-term dot products (85), the denominator (7), then square,
    divide, clamp and add (5); E and the operand read once, the scores
    written once.
    """
    return Work(bytes=4 * (b * h * 9 + b * 9 * 5 * m + b * h), ops=97 * b * h * m, peak=PEAK_F32_OPS)
