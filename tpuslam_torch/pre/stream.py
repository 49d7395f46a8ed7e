"""Host-side frame source: a directory of 8-bit grayscale PNG frames.

Port of ``tpuslam/pre/stream.py`` (directory mode).  The reference package
decodes with OpenCV or its prebuilt native loader; neither is available on
every machine the port runs on, so frames are decoded here with the
standard library's ``zlib`` plus numpy.  Only the format the KITTI fixtures
use is accepted — 8-bit grayscale, non-interlaced PNG with any of the five
row filters — and anything else raises.  Video input is not ported yet.

Undistortion is not done here: it is a gather on the device inside the
pipeline (``tpuslam_torch.common.camera``).
"""

from __future__ import annotations

import datetime as _dt
import queue
import struct
import threading
import zlib
from pathlib import Path
from typing import Iterator

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def parse_timestamps(path: Path) -> list[float]:
    """Parse ``timestamps.txt`` → seconds since epoch (float).

    Format per line: ``YYYY-MM-DD HH:MM:SS.nanoseconds``.  Malformed lines
    are skipped, as in the reference package.
    """
    out: list[float] = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        dot = line.find(".")
        if dot < 0:
            continue
        main, nanos = line[:dot], line[dot + 1 :]
        try:
            t = _dt.datetime.strptime(main, "%Y-%m-%d %H:%M:%S")
            ns = int(nanos)
        except ValueError:
            continue
        out.append(t.replace(tzinfo=_dt.timezone.utc).timestamp() + ns * 1e-9)
    return out


def _unfilter_row_slow(ftype: int, line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    """Average (3) and Paeth (4) filters: sequential along the row."""
    out = np.zeros_like(line)
    for x in range(line.shape[0]):
        a = int(out[x - 1]) if x > 0 else 0
        b = int(prev[x])
        if ftype == 3:
            pred = (a + b) // 2
        else:
            c = int(prev[x - 1]) if x > 0 else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (int(line[x]) + pred) & 0xFF
    return out


def decode_png_gray8(path: str | Path) -> np.ndarray:
    """Decode an 8-bit grayscale, non-interlaced PNG → (H, W) uint8.

    Raises ``ValueError`` for any other PNG format (colour, palette, 16-bit,
    interlaced) and for a corrupt file.
    """
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: missing IHDR or IDAT chunk")
    width, height, depth, color, compression, filt, interlace = header
    if (depth, color, compression, filt, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNG is supported "
            f"(bit depth {depth}, colour type {color}, interlace {interlace})"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != height * (width + 1):
        raise ValueError(f"{path}: decompressed size does not match the header")
    rows = raw.reshape(height, width + 1)
    out = np.empty((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum along the row, mod 256
            cur = np.cumsum(line, dtype=np.uint8)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            cur = _unfilter_row_slow(ftype, line, prev)
        else:
            raise ValueError(f"{path}: invalid PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


class FrameStream:
    """Iterates grayscale uint8 frames from a directory of PNG files."""

    def __init__(self, stream_path: str | Path, frame_skip: int = 0):
        self.path = Path(stream_path)
        self.frame_skip = frame_skip
        if not self.path.is_dir():
            raise NotImplementedError(
                f"{self.path}: only image directories are supported by the port; "
                "video input is not ported yet"
            )
        self._files = sorted(
            p for p in self.path.iterdir() if p.is_file() and p.suffix.lower() == ".png"
        )
        self.total_frames = len(self._files)
        ts_file = self.path / "timestamps.txt"
        if ts_file.is_file():
            self._timestamps = parse_timestamps(ts_file)
            if len(self._timestamps) != self.total_frames:
                raise RuntimeError("Number of timestamps does not match number of frames.")
        else:
            self._timestamps = [float(i) for i in range(self.total_frames)]

    def read_frame(self, index: int) -> tuple[np.ndarray, float]:
        """Decode frame ``index`` → (gray uint8 (H, W), timestamp seconds)."""
        return decode_png_gray8(self._files[index]), self._timestamps[index]

    def frame_indices(self) -> list[int]:
        return list(range(0, self.total_frames, 1 + self.frame_skip))

    def batches(
        self, batch_size: int, prefetch: int = 2, start_frame: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield ``(frames (B, H, W) u8, timestamps (B,), valid (B,))`` chunks.

        The final chunk is padded by repeating the last frame, with ``valid``
        marking the real entries, so shapes stay fixed.  A background thread
        decodes ahead of the consumer.  ``start_frame`` skips that many
        yielded frames (after ``frame_skip``).
        """
        indices = self.frame_indices()[start_frame:]
        if not indices:
            return
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        sentinel = object()
        errors: list[BaseException] = []

        def worker() -> None:
            try:
                for s in range(0, len(indices), batch_size):
                    chunk = indices[s : s + batch_size]
                    frames, stamps = zip(*(self.read_frame(i) for i in chunk))
                    n = len(frames)
                    if n < batch_size:
                        frames = frames + (frames[-1],) * (batch_size - n)
                        stamps = stamps + (stamps[-1],) * (batch_size - n)
                    valid = np.arange(batch_size) < n
                    q.put((np.stack(frames), np.asarray(stamps), valid))
            except Exception as exc:  # handed to the consumer below
                errors.append(exc)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if errors:
            raise errors[0]
