"""A plain PNG decoder for 8-bit grayscale, non-interlaced files (numpy and zlib).

Frozen in the benchmark so that the frames both sides receive never depend
on the program's loader.  It checks every chunk's CRC and undoes the five
row filters; Average and Paeth rows run a Python loop over their bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    if ftype == 0:
        return line
    if ftype == 1:
        return np.cumsum(line, dtype=np.uint8)
    if ftype == 2:
        return line + prev
    buf = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(buf)):
        a = buf[x - 1] if x else 0
        b = up[x]
        if ftype == 3:
            buf[x] = (buf[x] + ((a + b) >> 1)) & 0xFF
        elif ftype == 4:
            c = up[x - 1] if x else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            buf[x] = (buf[x] + (a if pa <= pb and pa <= pc else (b if pb <= pc else c))) & 0xFF
        else:
            raise ValueError(f"invalid PNG filter type {ftype}")
    return np.frombuffer(bytes(buf), np.uint8)


def decode_gray8(path: str | Path) -> np.ndarray:
    """(H, W) uint8 of an 8-bit grayscale PNG; raises ``ValueError`` for any other kind of file."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: CRC error in {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: missing IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(f"{path}: only 8-bit grayscale non-interlaced PNGs are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw[: height * (width + 1)].reshape(height, width + 1)
    out = np.empty((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev)
        prev = out[y]
    return out
