"""Rotation and rescaling of gray uint8 frames, bit for bit as OpenCV's 8-bit paths compute them.

The vocabulary trainer's ``--augment`` (``tools/train_vocabulary.py``)
rotates with ``cv2.getRotationMatrix2D`` + ``cv2.warpAffine`` and rescales
with ``cv2.resize`` there and back, all ``INTER_LINEAR``.  The port does
this in torch, on the host or the card, and gives the bytes of the OpenCV
the reference runs with (5.0; the tests hold the two bit for bit):

* ``warp_affine_u8`` is OpenCV's 8-bit one-channel ``INTER_LINEAR`` warp
  (``warpAffineLinearInvoker_8UC1``): the inverse map in float64, cast to
  float32; each row's offsets ``y·M[1] + M[2]`` rounded twice; the source
  coordinate ``fma(M[0], x, offset)`` over the first multiple of 16
  columns (its vector loop) and ``fma(x, M[0], y·M[1]) + M[2]`` over the
  rest; bilinear weights applied as three float32 FMAs; round half to
  even; outside the source, 0 (``BORDER_CONSTANT``).  A float32 FMA is a
  float64 product and sum rounded once to float32: exact for these
  operands (the products have at most 35 significant bits).
* ``resize_u8`` is OpenCV's 8-bit ``INTER_LINEAR`` resize: 11-bit
  fixed-point coefficients from float32 offsets, a horizontal pass in
  int32 (edges clamped), and a vertical pass as its vector code computes
  it: each row sum shifted right by 4, multiplied by its coefficient
  keeping the high 16 bits, the two added and rounded by 2 bits.

``cv2.warpAffine``'s older fixed-point path (coefficients in units of
2^-10, 32 sub-pixel steps, 15-bit weights) is not what this OpenCV runs,
and gives other bytes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

VECTOR_COLUMNS = 16  # OpenCV's warp vector loop: 2 x 8 float32 lanes a step


def rotation_matrix(center: tuple[float, float], angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, 1.0)``: (2, 3) float64, ``angle`` in degrees, counter-clockwise."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = (float(np.float32(c)) for c in center)  # OpenCV's Point2f
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The destination → source map ``cv2.warpAffine`` inverts ``m`` into, in its float64 order of operations."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(6)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, np.float64).reshape(2, 3)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add: one rounding of the exact a·b + c."""
    return (a.double() * b.double() + c.double()).float()


def warp_affine_u8(image: torch.Tensor, m: np.ndarray, dsize: tuple[int, int]) -> torch.Tensor:
    """``cv2.warpAffine(image, m, dsize)`` of an (H, W) uint8 tensor: ``INTER_LINEAR``, constant border 0."""
    w, h = dsize
    dev = image.device
    inv = torch.tensor(invert_affine(m).reshape(6), dtype=torch.float32, device=dev)
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)

    def coordinate(c0, c1, c2):
        c0, c1, c2 = (inv[i].expand(h, w) for i in (c0, c1, c2))
        row = y * c1  # float32, rounded
        vector = _fma(c0, x, row + c2)
        tail = _fma(x, c0, row) + c2
        return torch.where(x < (w // VECTOR_COLUMNS) * VECTOR_COLUMNS, vector, tail)

    sx, sy = coordinate(0, 1, 2), coordinate(3, 4, 5)
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = sx - ix, sy - iy
    ix, iy = ix.long(), iy.long()
    src = image.float()
    sh, sw = src.shape

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        return torch.where(inside, src[yy.clamp(0, sh - 1), xx.clamp(0, sw - 1)], torch.zeros((), device=dev))

    p00, p01, p10, p11 = pixel(iy, ix), pixel(iy, ix + 1), pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    v0 = _fma(ax, p01 - p00, p00)
    v1 = _fma(ax, p11 - p10, p10)
    v = _fma(ay, v1 - v0, v0)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def _coefficients(dst: int, src: int, scale: float, clamp: bool, device) -> tuple[torch.Tensor, ...]:
    """Per output index: first source index, second, and the two 11-bit coefficients (``INTER_RESIZE_COEF``)."""
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    second = s + 1
    if clamp:  # the horizontal pass: outside the row, the edge pixel with weight 1
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low], s[high] = 0, src - 1
        second = np.minimum(s + 1, src - 1)
    c1 = np.rint(f * np.float32(2048)).astype(np.int64)
    c0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (np.clip(s, 0, src - 1), np.clip(second, 0, src - 1),
                                                          c0, c1))


def resize_u8(image: torch.Tensor, dsize: tuple[int, int] | None = None, fx: float = 0.0,
              fy: float = 0.0) -> torch.Tensor:
    """``cv2.resize(image, dsize, fx=fx, fy=fy)`` of an (H, W) uint8 tensor, ``INTER_LINEAR``.

    As in OpenCV, ``dsize`` wins when given (the scales are then the size
    ratios); otherwise the size is ``round(W·fx) x round(H·fy)``.
    """
    h, w = image.shape
    if dsize:
        dw, dh = dsize
        inv_x, inv_y = dw / w, dh / h
    else:
        dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
        inv_x, inv_y = fx, fy
    dev = image.device
    x0, x1, a0, a1 = _coefficients(dw, w, 1.0 / inv_x, True, dev)
    y0, y1, b0, b1 = _coefficients(dh, h, 1.0 / inv_y, False, dev)
    src = image.long()
    rows = src[:, x0] * a0 + src[:, x1] * a1  # (h, dw) int32 sums; the edges as S·2048 + S·0

    def high(s, b):  # v_mul_hi of the sum >> 4 (saturated to int16) by the coefficient
        return (torch.clamp(s >> 4, -32768, 32767) * b[:, None]) >> 16

    out = (high(rows[y0], b0) + high(rows[y1], b1) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)
