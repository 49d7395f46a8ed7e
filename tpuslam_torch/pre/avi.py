"""The plain AVI demuxer: the native loader's video path in Python.

``open_avi(path)`` lists the frames of a Motion JPEG AVI and
``AviVideo.decode(i)`` decodes frame i with ``pre/jpeg.py``, to the bytes
``native/frameloader.cpp`` gives.  It is written from the formats, not from
the C++, so that a slip in one shows against the other:

* RIFF: a chunk is a FOURCC, a little-endian 32-bit size and a body padded
  to an even size; a "RIFF" or "LIST" body starts with a FOURCC form and
  holds chunks;
* AVI 1.0: the file is a "RIFF" of form "AVI ".  Its "LIST" "hdrl" holds one
  "LIST" "strl" a stream, in stream order, each with an AVISTREAMHEADER
  ("strh": fccType, fccHandler, ..., dwScale at byte 20, dwRate at 24) and a
  format ("strf", for video a BITMAPINFOHEADER: biWidth at 4, biHeight at 8,
  biCompression at 16).  The samples are the chunks of "LIST" "movi" (or of
  the "LIST" "rec " groups in it) whose id is the stream's number in two
  decimal digits and "dc" (compressed video) or "db"; the stream's time
  base is dwScale / dwRate seconds a frame.  "idx1" indexes the movi list of
  this RIFF only;
* OpenDML 1.02: the data past the first RIFF's 1 GB continues in "RIFF"
  forms "AVIX", each with its own "movi" list; "vprp" (VideoPropHeader)
  gives nbFieldPerFrame at byte 32, 2 for an interlaced stream.

So the movi lists are walked in file order, and the index is not read.  A
Motion JPEG frame is one JPEG image.  Refused, raising ``FrameDecodeError``
with the words of ``native_loader.VIDEO_REFUSED``: a codec other than MJPEG
(the handler, when set, or the compression names another), an MP4 /
QuickTime (an "ftyp" box first) or Matroska / WebM (the EBML magic) file,
interlaced Motion JPEG (two fields a frame: "vprp" says so, or the JPEG is
half the stream's height), a zero-length frame chunk (a dropped frame), a
chunk that runs past the end of the file, and a file without video frames.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from tpuslam_torch.pre.jpeg import decode_jpeg_gray8_bytes, jpeg_size
from tpuslam_torch.pre.native_loader import STATUS, VIDEO_NOT_AVI, VIDEO_REFUSED, FrameDecodeError

_EBML = b"\x1a\x45\xdf\xa3"


class _Refused(Exception):
    def __init__(self, status: int):
        self.status = status


@dataclass(frozen=True)
class AviVideo:
    """The frames of a Motion JPEG AVI: each payload's offset and size in the file, and the time base."""

    path: Path
    offsets: np.ndarray  # (n,) int64
    sizes: np.ndarray  # (n,) int64
    scale: int  # dwScale: frame i is at i * scale / rate seconds
    rate: int  # dwRate
    height: int
    width: int
    stream_height: int  # |biHeight| of the stream's BITMAPINFOHEADER

    @property
    def n_frames(self) -> int:
        return len(self.offsets)

    def payload(self, index: int) -> bytes:
        with open(self.path, "rb") as f:
            f.seek(int(self.offsets[index]))
            return f.read(int(self.sizes[index]))

    def decode(self, index: int) -> np.ndarray:
        """Frame ``index`` → (H, W) uint8, the JPEG's luma as ``decode_jpeg_gray8`` gives it."""
        name = f"{self.path} frame {index}"
        data = self.payload(index)
        frame = decode_jpeg_gray8_bytes(data, name)
        if frame.shape != (self.height, self.width):
            if _is_field(frame.shape[0], self.stream_height):
                raise FrameDecodeError(f"{name}: {VIDEO_REFUSED[17]}")
            raise FrameDecodeError(f"{name}: {STATUS[4]}")
        return frame


def _is_field(height: int, stream_height: int) -> bool:
    """A JPEG this high is one field of a frame of the stream's height."""
    return stream_height > height and stream_height in (2 * height, 2 * height - 1)


def _is_mjpg(fcc: bytes) -> bool:
    return fcc.upper() == b"MJPG"


class _Walk:
    """The chunks of the RIFF tree, read with seeks; the first video stream's headers and frames."""

    def __init__(self, f, size: int):
        self.f, self.size = f, size
        self.streams = 0  # strl lists seen
        self.video: int | None = None  # the first video stream's number
        self.scale = self.rate = self.stream_height = 0
        self.chunks: list[tuple[int, int]] = []

    def read(self, at: int, n: int) -> bytes:
        self.f.seek(at)
        data = self.f.read(n)
        if len(data) < n:
            raise _Refused(19)
        return data

    def chunks_of(self, start: int, end: int):
        """(FOURCC, body offset, body size) of each chunk in [start, end)."""
        pos = start
        while pos + 8 <= end:
            fcc, n = struct.unpack("<4sI", self.read(pos, 8))
            body = pos + 8
            if body + n > self.size:
                raise _Refused(19)
            if body + n > end:
                raise _Refused(3)
            yield fcc, body, n
            pos = body + n + (n & 1)

    def walk(self, start: int, end: int, form: bytes) -> None:
        for fcc, body, n in self.chunks_of(start, end):
            if fcc == b"LIST":
                if n < 4:
                    raise _Refused(3)
                kind = self.read(body, 4)
                if kind == b"strl":
                    self.streams += 1
                if kind in (b"hdrl", b"strl", b"movi", b"rec "):
                    self.walk(body + 4, body + n, b"movi" if kind == b"rec " else kind)
            elif form == b"strl":
                self.stream_header(fcc, body, n)
            elif form == b"movi" and self.video is not None and fcc[:2] == b"%02d" % self.video \
                    and fcc[2:] in (b"dc", b"db"):
                if n == 0:
                    raise _Refused(18)
                self.chunks.append((body, n))

    def stream_header(self, fcc: bytes, body: int, n: int) -> None:
        stream = self.streams - 1
        if fcc == b"strh":
            if n < 36:
                raise _Refused(3)
            kind, handler, scale, rate = struct.unpack("<4s4s12xII", self.read(body, 28))
            if kind != b"vids" or self.video is not None:
                return
            if handler != b"\0\0\0\0" and not _is_mjpg(handler):
                raise _Refused(15)
            if stream > 99 or scale == 0 or rate == 0:
                raise _Refused(3)
            self.video, self.scale, self.rate = stream, scale, rate
        elif stream == self.video and fcc == b"strf":
            if n < 20:
                raise _Refused(3)
            _, height, compression = struct.unpack("<4xii4x4s", self.read(body, 20))
            if not _is_mjpg(compression):
                raise _Refused(15)
            self.stream_height = abs(height)
        elif stream == self.video and fcc == b"vprp" and n >= 36:
            (fields,) = struct.unpack("<I", self.read(body + 32, 4))
            if fields == 2:
                raise _Refused(17)

    def riffs(self) -> None:
        """The RIFF AVI, then each RIFF AVIX that follows it."""
        pos, first = 0, True
        while pos + 12 <= self.size:
            fcc, n, form = struct.unpack("<4sI4s", self.read(pos, 12))
            if fcc != b"RIFF" or form != (b"AVI " if first else b"AVIX"):
                break
            if n < 4:
                raise _Refused(3)
            if pos + 8 + n > self.size:
                raise _Refused(19)
            self.walk(pos + 12, pos + 8 + n, form)
            pos += 8 + n + (n & 1)
            first = False


def open_avi(path: str | Path) -> AviVideo:
    """List the frames of the Motion JPEG AVI at ``path``; read the first frame's size.

    Raises ``FrameDecodeError`` for a file the loader refuses (naming why)
    or cannot read.
    """
    path = Path(path)
    try:
        with open(path, "rb") as f:
            size = f.seek(0, 2)
            f.seek(0)
            head = f.read(12)
            if head[4:8] == b"ftyp" or head[:4] == _EBML:
                raise _Refused(16)
            if len(head) < 12:
                raise _Refused(19 if head[:4] == b"RIFF" else 3)
            if head[:4] != b"RIFF" or head[8:] != b"AVI ":
                raise _Refused(3)
            walk = _Walk(f, size)
            walk.riffs()
            if walk.video is None or not walk.chunks:
                raise _Refused(20)
            offset, n = walk.chunks[0]
            f.seek(offset)
            height, width = jpeg_size(f.read(n), f"{path} frame 0")
    except _Refused as refused:
        if refused.status == 3:
            raise FrameDecodeError(f"Could not open video file: {path} ({VIDEO_NOT_AVI})") from None
        raise FrameDecodeError(f"{path}: {VIDEO_REFUSED[refused.status]}") from None
    except OSError as exc:
        raise FrameDecodeError(f"Could not open video file: {path} ({exc})") from None
    if _is_field(height, walk.stream_height):
        raise FrameDecodeError(f"{path}: {VIDEO_REFUSED[17]}")
    offsets, sizes = (np.asarray(c, np.int64) for c in zip(*walk.chunks))
    return AviVideo(path, offsets, sizes, walk.scale, walk.rate, height, width, walk.stream_height)
