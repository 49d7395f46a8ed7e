"""A small PNG encoder in numpy and ``zlib``: gray, colour and every other colour type and bit depth.

``encode_png(samples, colour, depth, ...)`` gives the bytes of a PNG file of
``samples``, with libpng's adaptive row filters or the filters asked for,
Adam7-interlaced or not.  ``write_png(path, image)`` writes an 8-bit gray
(H, W) or BGR (H, W, 3) image — OpenCV's channel order, as the
visualizer's arrays are — as an 8-bit gray or RGB PNG.  No image library
is needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _png_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples → (h, row bytes) packed rows: big-endian 16-bit, or bits most significant first."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = (samples.reshape(h, w * c, 1).astype(np.uint8) >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _png_filter(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Filter every row: each row's type from ``filters`` (an int a row), or, for "adaptive", libpng's
    heuristic (the type whose bytes, read as signed, have the least absolute sum)."""
    x = rows.astype(np.int16)
    b = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    a = np.hstack([np.zeros_like(x[:, :bpp]), x[:, :-bpp]])
    c = np.hstack([np.zeros_like(b[:, :bpp]), b[:, :-bpp]])
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth]).astype(np.uint8)  # (5, h, n)
    if isinstance(filters, str):
        cost = np.abs(out.view(np.int8).astype(np.int32)).sum(axis=2)
        filters = np.argmin(cost, axis=0)
    filters = np.asarray(filters)
    chosen = out[filters, np.arange(len(filters))]
    return np.hstack([filters[:, None].astype(np.uint8), chosen]).tobytes()


def encode_png(samples: np.ndarray, colour: int = 0, depth: int = 8, filters="adaptive", interlace: bool = False,
               palette: np.ndarray | None = None, trns: bytes | None = None, level: int = 6) -> bytes:
    """A PNG file of ``samples`` ((h, w) or (h, w, channels) at ``depth`` bits) of colour type ``colour``.

    ``filters``: "adaptive" or a row filter type for each row (of each
    Adam7 pass in turn when ``interlace``: then the pattern repeats).
    """
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    parts = [samples] if not interlace else [samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
    raw = b""
    for part in parts:
        if part.size == 0:
            continue
        f = filters if isinstance(filters, str) else np.resize(np.asarray(filters), part.shape[0])
        raw += _png_filter(_png_rows(part, depth), bpp, f)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                                                   int(interlace)))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", trns)
    return out + _png_chunk(b"IDAT", zlib.compress(raw, level)) + _png_chunk(b"IEND", b"")


def write_png(path: str | Path, image: np.ndarray) -> Path:
    """Write an 8-bit (H, W) gray or (H, W, 3) BGR image as a PNG file at ``path`` (its folder made)."""
    path = Path(path)
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png takes a uint8 (H, W) or (H, W, 3) image, not {image.dtype} {image.shape}")
    if path.suffix.lower() != ".png":
        raise ValueError(f"{path}: only PNG files are written (a .png path)")
    colour = 0 if image.ndim == 2 else 2
    data = encode_png(image if colour == 0 else image[..., ::-1], colour=colour)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path
