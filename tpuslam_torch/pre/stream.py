"""Host-side frame source: a directory of PNG or JPEG frames, or a Motion JPEG AVI.

Port of ``tpuslam/pre/stream.py``.  Frames decode to grayscale uint8
through the port's own threaded C++ loader (``pre/native_loader.py``,
``native/frameloader.cpp``) by default, or, with ``use_native=False``,
through the loader's plain versions: ``decode_png_gray8`` (numpy and the
standard library's ``zlib``), ``decode_jpeg_gray8`` (``pre/jpeg.py``) and
the AVI demuxer ``pre/avi.py``.  JPEG decodes in both to the bytes of the
reference's libjpeg gray output, and the variants neither reads
(``native_loader.JPEG_REFUSED``) raise ``FrameDecodeError`` naming them.
Both accept every PNG the reference's loader accepts — bit depths 1 to 16;
gray, gray + alpha, RGB, RGBA and palette; tRNS; Adam7 interlacing — and
convert as it does: 16-bit samples keep their high byte, low-depth gray
expands to 8 bits, a palette expands to RGB, alpha is dropped, and colour
becomes gray as ``(4899·R + 9617·G + 1868·B + 8192) >> 14``.  Interlaced
files decode to the image (the reference's loader reads Adam7 pass rows
as image rows; its OpenCV path decodes them right).

A path that is a file is read as a Motion JPEG AVI (the reference opens any
video with ``cv2.VideoCapture``).  Its frames are the JPEG payloads of the
video stream's chunks in file order, frame i at ``i * dwScale / dwRate``
seconds, the count ``CAP_PROP_FRAME_COUNT`` gives; each decodes to the
JPEG's luma, the bytes the same JPEG gives as a file in a directory.  The
reference's frames are FFmpeg's decode converted to BGR and back to gray,
within 2 gray levels of these.  Frames are read by index: every Motion JPEG
frame stands alone, so random access decodes the frame sequential reading
would.  A video the demuxers refuse (``native_loader.VIDEO_REFUSED``: another
codec or container, interlaced, a dropped frame, truncated) raises
``FrameDecodeError`` naming why.

Undistortion is not done here: it is a gather on the device inside the
pipeline (``tpuslam_torch.common.camera``).  ``device_prefetch`` stages the
chunks of ``FrameStream.batches()`` on the device ahead of their use;
``frames_to_memmap`` decodes a stream once to disk for the time-sharded
drivers.
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
import torch

from tpuslam_torch.pre.avi import open_avi
from tpuslam_torch.pre.jpeg import decode_jpeg_gray8
from tpuslam_torch.pre.native_loader import FRAME_SUFFIXES, NativeFrameLoader, NativeVideoLoader

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
MEMMAP_CHUNK = 64  # frames_to_memmap decodes this many frames a call
# colour type → (samples a pixel, allowed bit depths)
_PNG_COLOUR = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
               4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


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


class PngError(ValueError):
    """A PNG file the decoders refuse: not a PNG, corrupt, truncated or outside the format."""


def _png_chunks(data: bytes, path) -> tuple[tuple, bytes, bytes]:
    """(IHDR fields, PLTE body, the IDAT bodies joined); critical chunks' CRCs checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise PngError(f"{path}: not a PNG file")
    pos, header, plte, idat = 8, None, b"", []
    while True:
        if pos + 12 > len(data):
            raise PngError(f"{path}: truncated before IEND")
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) < length or pos + 12 + length > len(data):
            raise PngError(f"{path}: truncated {ctype!r} chunk")
        if ctype in _CRITICAL:
            (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
            if zlib.crc32(ctype + body) != crc:
                raise PngError(f"{path}: CRC error in the {ctype.decode()} chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise PngError(f"{path}: IHDR of {length} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise PngError(f"{path}: missing IHDR or IDAT chunk")
    return header, plte, b"".join(idat)


def _pass_sizes(width: int, height: int, interlace: int) -> list[tuple[int, int, int, int, int, int]]:
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass; the whole image when not interlaced."""
    if not interlace:
        return [(0, 0, 1, 1, width, height)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        w, h = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if w > 0 and h > 0:
            out.append((x0, y0, dx, dy, w, h))
    return out


def _unfilter_sequential(ftype: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows in place: each byte needs the one ``bpp`` to its left."""
    n = len(line)
    if ftype == 3:
        for x in range(min(bpp, n)):
            line[x] = (line[x] + (prev[x] >> 1)) & 0xFF
        for x in range(bpp, n):
            line[x] = (line[x] + ((line[x - bpp] + prev[x]) >> 1)) & 0xFF
        return
    for x in range(min(bpp, n)):  # a = c = 0: the predictor is b
        line[x] = (line[x] + prev[x]) & 0xFF
    for x in range(bpp, n):
        a, b, c = line[x - bpp], prev[x], prev[x - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        line[x] = (line[x] + (a if pa <= pb and pa <= pc else (b if pb <= pc else c))) & 0xFF


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int, path) -> np.ndarray:
    """Undo the row filters of one (pass) image → (h, row_bytes) uint8."""
    rows = raw.reshape(h, row_bytes + 1)
    out = np.empty((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum mod 256 in each of the bpp byte lanes
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(ftype, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(buf, np.uint8)
        else:
            raise PngError(f"{path}: invalid PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows → (h, w, channels) samples, 16-bit ones cut to their high byte."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, w, channels, 2)[..., 0]
    if depth == 8:
        return rows.reshape(h, w, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]  # channels == 1 below 8 bits
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


def _to_gray(s: np.ndarray, colour: int, depth: int, plte: bytes) -> np.ndarray:
    """(h, w, channels) samples → (h, w) gray, as the reference's loader converts them."""
    if colour == 3:
        palette = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        palette[: len(entries)] = entries
        s = palette[s[..., 0]]
    elif colour in (0, 4):
        g = s[..., 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))
        return g
    rgb = s[..., :3].astype(np.int32)
    return ((4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2] + 8192) >> 14).astype(np.uint8)


def decode_png_gray8(path: str | Path) -> np.ndarray:
    """Decode a PNG → (H, W) uint8 gray, in numpy and ``zlib``: the native loader's plain version.

    Raises ``PngError`` (a ``ValueError``) for a file the loader refuses.
    Average and Paeth rows run a Python loop over their bytes, so a file
    of such rows decodes slowly.
    """
    header, plte, idat = _png_chunks(Path(path).read_bytes(), path)
    width, height, depth, colour, compression, filt, interlace = header
    if colour not in _PNG_COLOUR or depth not in _PNG_COLOUR[colour][1]:
        raise PngError(f"{path}: invalid bit depth {depth} for colour type {colour}")
    if width == 0 or height == 0 or compression or filt or interlace > 1:
        raise PngError(f"{path}: invalid IHDR (size {width}x{height}, compression {compression}, "
                       f"filter {filt}, interlace {interlace})")
    if colour == 3 and (not plte or len(plte) % 3):
        raise PngError(f"{path}: palette image without a valid PLTE chunk")
    channels = _PNG_COLOUR[colour][0]
    bits = depth * channels
    bpp = max(1, bits // 8)
    passes = _pass_sizes(width, height, interlace)
    sizes = [h * ((w * bits + 7) // 8 + 1) for *_, w, h in passes]
    try:
        raw = zlib.decompressobj().decompress(idat, sum(sizes))
    except zlib.error as exc:
        raise PngError(f"{path}: corrupt image data ({exc})") from None
    if len(raw) < sum(sizes):
        raise PngError(f"{path}: not enough image data")
    raw = np.frombuffer(raw, np.uint8)
    out = np.empty((height, width), np.uint8)
    offset = 0
    for (x0, y0, dx, dy, w, h), size in zip(passes, sizes):
        rows = _unfilter(raw[offset : offset + size], h, (w * bits + 7) // 8, bpp, path)
        offset += size
        out[y0::dy, x0::dx] = _to_gray(_samples(rows, w, depth, channels), colour, depth, plte)
    return out


class FrameStream:
    """Iterates grayscale uint8 frames from a directory of PNG or JPEG files, in lexical order, or from a
    Motion JPEG AVI, in file order.

    ``use_native`` (the default) decodes through the threaded C++ loader,
    built here at first use; a machine where it cannot be built raises
    (``LoaderBuildError``), never decoding in Python unasked.
    ``use_native=False`` decodes with ``decode_png_gray8``,
    ``decode_jpeg_gray8`` and ``pre/avi.py``, the same bytes, slowly.
    """

    def __init__(self, stream_path: str | Path, frame_skip: int = 0, use_native: bool = True):
        self.path = Path(stream_path)
        self.frame_skip = frame_skip
        self._native = self._video = None
        self._files: list[Path] = []
        if self.path.is_dir():
            self.is_directory = True
            self._files = sorted(
                p for p in self.path.iterdir() if p.is_file() and p.suffix.lower() in FRAME_SUFFIXES
            )
            self.total_frames = len(self._files)
            ts_file = self.path / "timestamps.txt"
            if ts_file.is_file():
                self._timestamps = parse_timestamps(ts_file)
                if len(self._timestamps) != self.total_frames:
                    raise RuntimeError("Number of timestamps does not match number of frames.")
            else:
                self._timestamps = [float(i) for i in range(self.total_frames)]
            if use_native and self.total_frames:
                self._native = NativeFrameLoader(self.path)
        elif self.path.is_file():
            self.is_directory = False
            if use_native:
                video = self._native = NativeVideoLoader(self.path)
            else:
                video = self._video = open_avi(self.path)
            self.total_frames = video.n_frames
            self._timestamps = [i * video.scale / video.rate for i in range(self.total_frames)]
        else:
            raise RuntimeError(f"Unsupported stream type: {self.path}")

    def read_frames(self, indices: list[int], out: np.ndarray | None = None) -> np.ndarray:
        """Decode the frames ``indices`` → (n, H, W) uint8, into ``out`` when it is given.

        Through the loader, one call decodes them all on its thread pool.
        """
        if self._native is not None:
            return self._native.decode_indices(indices, out)
        for i, idx in enumerate(indices):
            if self._video is not None:
                frame = self._video.decode(idx)
            else:
                path = self._files[idx]
                frame = decode_png_gray8(path) if path.suffix.lower() == ".png" else decode_jpeg_gray8(path)
            if out is None:
                out = np.empty((len(indices), *frame.shape), np.uint8)
            out[i] = frame
        return out

    def read_frame(self, index: int) -> tuple[np.ndarray, float]:
        """Decode frame ``index`` → (gray uint8 (H, W), timestamp seconds)."""
        return self.read_frames([index])[0], self._timestamps[index]

    def __iter__(self) -> Iterator[tuple[np.ndarray, float]]:
        """(frame, timestamp) of every ``1 + frame_skip``-th frame, decoded one at a time."""
        for i in self.frame_indices():
            yield self.read_frame(i)

    def frame_indices(self) -> list[int]:
        return list(range(0, self.total_frames, 1 + self.frame_skip))

    def batches(
        self, batch_size: int, prefetch: int = 2, start_frame: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield ``(frames (B, H, W) u8, timestamps (B,), valid (B,))`` chunks.

        The final chunk is padded by repeating the last frame, with ``valid``
        marking the real entries, so shapes stay fixed.  A background thread
        decodes up to ``prefetch`` chunks ahead of the consumer, each chunk
        in one ``read_frames`` call.  ``start_frame`` skips that many
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
                    n = len(chunk)
                    frames = self.read_frames(chunk)
                    stamps = [self._timestamps[i] for i in chunk]
                    if n < batch_size:
                        frames = np.concatenate([frames, np.repeat(frames[-1:], batch_size - n, 0)])
                        stamps += [stamps[-1]] * (batch_size - n)
                    q.put((frames, np.asarray(stamps), np.arange(batch_size) < n))
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

    def close(self) -> None:
        """Release the loader's threads (the stream cannot decode afterwards)."""
        if self._native is not None:
            self._native.close()


def frames_to_memmap(
    stream: FrameStream,
    indices: list[int] | None = None,
    path: str | Path | None = None,
) -> np.memmap:
    """Decode a stream once into a disk-backed (N, H, W) uint8 memmap.

    Port of ``tpuslam/pre/stream.py::frames_to_memmap``.  The time-sharded
    drivers (``dist/timeshard.py``) slice one long sequence into per-shard
    windows; a memmap leaves the frames to the page cache, and slicing a
    shard's window reads only its frames, where an in-RAM stack of the
    whole video holds ~0.7 MB a frame.  The frames are decoded ``chunk``
    at a time straight into the file's pages.  ``path`` defaults to a new
    file in the temporary directory, which the caller removes
    (``mm.filename``).
    """
    import tempfile

    if indices is None:
        indices = stream.frame_indices()
    first = stream.read_frames(indices[:1])
    if path is None:
        with tempfile.NamedTemporaryFile(prefix="tpuslam_torch_frames_", suffix=".u8", delete=False) as f:
            path = f.name
    mm = np.memmap(path, dtype=np.uint8, mode="w+", shape=(len(indices), *first.shape[1:]))
    mm[0] = first[0]
    for s in range(1, len(indices), MEMMAP_CHUNK):
        stream.read_frames(indices[s : s + MEMMAP_CHUNK], out=mm[s : s + MEMMAP_CHUNK])
    mm.flush()
    return mm


def device_prefetch(
    batches: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]],
    device: torch.device | str = "cuda",
    depth: int = 2,
) -> Iterator[tuple[torch.Tensor, np.ndarray, np.ndarray]]:
    """Stage frame chunks on ``device`` ``depth`` chunks ahead → ``(frames tensor, stamps, valid)``.

    On a CUDA device each chunk is copied into one of ``depth + 1`` pinned
    host buffers and sent with ``copy_(non_blocking=True)`` on a side
    stream; the consumer's stream waits on the copy's event before the
    chunk is used.  The first chunk is handed over as soon as its copy is
    queued; each later pull, made once the consumer has queued its work on
    the chunk before, stages the chunks up to ``depth`` ahead, so their
    copies run under that work.  A pinned buffer is refilled only after the
    event of its last copy has completed, so no chunk is overwritten under
    a running copy.  Pinning that fails raises: there is no fallback to
    pageable or synchronous copies.  On the CPU the chunks are yielded as
    tensors over the host arrays.
    """
    device = torch.device(device)
    if device.type == "cpu":
        for frames, stamps, valid in batches:
            yield torch.from_numpy(np.ascontiguousarray(frames)), stamps, valid
        return
    copy_stream = torch.cuda.Stream(device=device)
    pinned: list[torch.Tensor | None] = [None] * (depth + 1)
    copied: list[torch.cuda.Event | None] = [None] * (depth + 1)
    source = iter(batches)
    staged: list[tuple] = []
    n_staged = 0

    def stage_until(n: int) -> None:
        nonlocal n_staged
        while len(staged) < n:
            item = next(source, None)
            if item is None:
                return
            frames, stamps, valid = item
            slot = n_staged % (depth + 1)
            n_staged += 1
            host = torch.from_numpy(np.ascontiguousarray(frames))
            if copied[slot] is not None:
                copied[slot].synchronize()  # the buffer's last copy has landed
            buf = pinned[slot]
            if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                buf = pinned[slot] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            buf.copy_(host)
            with torch.cuda.stream(copy_stream):
                dev = torch.empty(host.shape, dtype=host.dtype, device=device)
                dev.copy_(buf, non_blocking=True)
                copied[slot] = torch.cuda.Event()
                copied[slot].record(copy_stream)
            staged.append((dev, copied[slot], stamps, valid))

    stage_until(1)
    while staged:
        dev, event, stamps, valid = staged.pop(0)
        stream = torch.cuda.current_stream(device)
        stream.wait_event(event)
        dev.record_stream(stream)  # the consumer's stream owns the memory from here
        yield dev, stamps, valid
        stage_until(depth)
