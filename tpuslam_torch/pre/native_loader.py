"""The port's threaded frame decoder: ``native/frameloader.cpp`` bound through ``ctypes``.

Port of ``tpuslam/pre/native_loader.py``.  The C++ source is the port's own
(the reference's copy needs libpng; this one decodes PNG over zlib), built
with ``c++ -O3 -std=c++17 -fPIC`` at first use into ``build/tpuslam_torch/``
at the repository root, under a file name keyed on a hash of the source,
flags and libraries — never at import, and never with ``-march=native``, so
a build is only loaded where its key says it belongs.  It links zlib and
nothing else: PNG inflates through zlib, and JPEG decodes with the source's
own decoder to libjpeg's gray bytes, the same code on every machine.

``NativeVideoLoader`` reads a Motion JPEG AVI the same way: the source's
own RIFF walk lists the frame chunks, and each frame's payload is read with
``pread`` and decoded by the same JPEG decoder on the same pool; no libjpeg
and no FFmpeg.

There is no fallback: a failed build raises ``LoaderBuildError`` naming the
compiler's log, and a frame that does not decode raises
``FrameDecodeError`` naming the file and the reason — for a JPEG variant the
decoder refuses, the variant (``JPEG_REFUSED``), at open when it is the
first frame; for a video the loader refuses, why (``VIDEO_REFUSED``), at
open.  ``pre/stream.py::decode_png_gray8``, ``pre/jpeg.py::decode_jpeg_gray8``
and ``pre/avi.py`` are the loader's plain versions, used only where the
caller asks for them (``FrameStream(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tpuslam_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent.parent / "native" / "frameloader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-Wextra")
LIBS = ("-lz", "-lpthread")
FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")  # a directory's frames, as the reference lists them
STATUS = {
    1: "cannot open the file",
    2: "out of memory",
    3: "corrupt, or not a PNG/JPEG frame the loader reads",
    4: "its size differs from the first frame's",
    5: "frame index out of range",
}
# The JPEG variants the decoders refuse (``frameloader.cpp::JpegStatus``), by status.
JPEG_REFUSED = {
    6: "arithmetic-coded JPEG (SOF9-11) is not supported",
    7: "lossless JPEG (SOF3) is not supported",
    8: "JPEG samples of other than 8 bits (12-bit) are not supported",
    9: "hierarchical JPEG (SOF5-7, SOF13-15) is not supported",
    10: "a JPEG of other than one or three components (CMYK, YCCK) is not supported",
    11: "an RGB JPEG (Adobe transform 0, or components R, G, B) is not supported",
    12: "a JPEG whose luma is sampled below another component is not supported",
    13: "a JPEG whose height is given by a DNL marker is not supported",
    14: "a progressive JPEG that leaves luma's AC 1-9 unrefined (libjpeg smooths it) is not supported",
}
# The videos the demuxers refuse (``frameloader.cpp::VideoStatus``, ``pre/avi.py``), by status.
VIDEO_REFUSED = {
    15: "a video codec other than Motion JPEG (MJPG) is not supported",
    16: "a video container other than AVI (MP4, QuickTime, Matroska, WebM) is not supported",
    17: "interlaced Motion JPEG (two fields a frame) is not supported",
    18: "a zero-length video frame chunk (a dropped frame) is not supported",
    19: "a truncated AVI (a chunk runs past the end of the file) is not supported",
    20: "an AVI without a video stream or without frames is not supported",
}
VIDEO_NOT_AVI = "not an AVI file, or a corrupt one"
STATUS.update(JPEG_REFUSED)
STATUS.update(VIDEO_REFUSED)

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_uint)
_SIGNATURES = {
    "fl_open_dir": (_P, (ctypes.c_char_p, _IP, _IP, _IP)),
    "fl_open_video": (_P, (ctypes.c_char_p, _IP, _IP, _IP, _UP, _UP, _IP)),
    "fl_video_chunks": (None, (_P, _P, _P)),
    "fl_decode_batch": (_I, (_P, _I, _I, _P)),
    "fl_decode_indices": (_I, (_P, _IP, _I, _P, _IP)),
    "fl_threads": (_I, (_P,)),
    "fl_probe": (_I, (ctypes.c_char_p, _IP, _IP)),
    "fl_close": (None, (_P,)),
}


class LoaderBuildError(RuntimeError):
    """The frame loader could not be built on this machine."""


class FrameDecodeError(RuntimeError):
    """A frame, or a frame directory, the loader cannot read (names the file and the reason)."""


def _compiler() -> str | None:
    return shutil.which("c++")


def build_library(cxx: str) -> Path:
    """Compile the loader if this exact build is not on disk; return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags, libs = CXX_FLAGS, LIBS
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags + libs).encode())
    target = BUILD_DIR / f"libtpuslam_frameloader_{h.hexdigest()[:16]}.so"
    if target.is_file():
        return target
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [cxx, *flags, "-o", str(tmp), str(SOURCE), *libs]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=600)
    log.write_text(" ".join(cmd) + "\n" + proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise LoaderBuildError(f"building the frame loader failed (exit {proc.returncode}); compiler log: {log}\n"
                               f"{proc.stdout[-2000:]}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return target


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The process's loader library, built and loaded on first call."""
    global _LIB
    if _LIB is None:
        cxx = _compiler()
        if cxx is None:
            raise LoaderBuildError("no C++ compiler (c++) on this machine: the frame loader cannot be built; "
                                   "FrameStream(use_native=False) decodes PNG in Python")
        lib = ctypes.CDLL(str(build_library(cxx)))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the loader runs here: False without a C++ compiler; a build that fails raises."""
    if _LIB is None and _compiler() is None:
        return False
    library()
    return True


class _Loader:
    """A loader handle: frames by index, decoded on its thread pool."""

    _handle = None
    n_frames = height = width = threads = 0

    def _frame_name(self, index: int) -> str:
        raise NotImplementedError

    def decode_indices(self, indices, out: np.ndarray | None = None) -> np.ndarray:
        """Decode the frames ``indices`` (any order, repeats allowed) in one call → (n, H, W) uint8.

        ``out``, when given, is a C-contiguous writable (n, H, W) uint8
        array (for example the numpy view of a pinned tensor) that the
        frames are written into.
        """
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        idx = np.ascontiguousarray(indices, dtype=np.int32).reshape(-1)
        shape = (len(idx), self.height, self.width)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif (out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous
              or not out.flags.writeable):
            raise ValueError(f"out must be a C-contiguous writable uint8 array of shape {shape}, "
                             f"not {out.dtype} {out.shape}")
        bad = (idx < 0) | (idx >= self.n_frames)
        if bad.any():
            raise IndexError(f"frame index {int(idx[bad][0])} out of range for {self.n_frames} frames")
        failed = ctypes.c_int(-1)
        rc = self._lib.fl_decode_indices(self._handle, idx.ctypes.data_as(_IP), len(idx),
                                         out.ctypes.data_as(_P), ctypes.byref(failed))
        if rc != 0:
            frame = self._frame_name(int(idx[failed.value])) if failed.value >= 0 else "a frame"
            raise FrameDecodeError(f"{frame}: {STATUS.get(rc, f'status {rc}')}")
        return out

    def decode_batch(self, start: int, count: int) -> np.ndarray:
        """Decode frames [start, start + count) → (count, H, W) uint8."""
        if start < 0 or count < 0 or start + count > self.n_frames:
            raise IndexError(f"frames [{start}, {start + count}) out of range for {self.n_frames} frames")
        return self.decode_indices(range(start, start + count))

    def close(self) -> None:
        if self._handle:
            self._lib.fl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


class NativeFrameLoader(_Loader):
    """Threaded batch decoder over a directory of .png/.jpg/.jpeg frames, in lexical order."""

    def __init__(self, directory: str | Path):
        self._lib = library()
        self.directory = Path(directory)
        self.files = sorted(p for p in self.directory.iterdir() if p.is_file()
                            and p.suffix.lower() in FRAME_SUFFIXES) if self.directory.is_dir() else []
        n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._handle = self._lib.fl_open_dir(str(directory).encode(), ctypes.byref(n), ctypes.byref(h),
                                             ctypes.byref(w))
        if not self._handle:
            rc = self._lib.fl_probe(str(self.files[0]).encode(), ctypes.byref(h), ctypes.byref(w)) if self.files else 0
            if rc in JPEG_REFUSED:
                raise FrameDecodeError(f"{self.files[0]}: {JPEG_REFUSED[rc]}")
            why = f"the first frame {self.files[0]} cannot be read" if self.files else "no .png/.jpg/.jpeg frames"
            raise RuntimeError(f"Could not open frame directory: {directory} ({why})")
        self.n_frames, self.height, self.width = n.value, h.value, w.value
        self.threads = self._lib.fl_threads(self._handle)

    def _frame_name(self, index: int) -> str:
        return str(self.files[index])


class NativeVideoLoader(_Loader):
    """Threaded batch decoder over the frames of a Motion JPEG AVI, in file order.

    ``scale`` / ``rate`` are the video stream's ``dwScale`` / ``dwRate``:
    frame i is at ``i * scale / rate`` seconds.  ``offsets`` / ``sizes``
    locate each frame's JPEG payload in the file.
    """

    def __init__(self, path: str | Path):
        self._lib = library()
        self.path = Path(path)
        n, h, w, status = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        scale, rate = ctypes.c_uint(), ctypes.c_uint()
        self._handle = self._lib.fl_open_video(str(path).encode(), ctypes.byref(n), ctypes.byref(h),
                                               ctypes.byref(w), ctypes.byref(scale), ctypes.byref(rate),
                                               ctypes.byref(status))
        if not self._handle:
            rc = status.value
            if rc in VIDEO_REFUSED:
                raise FrameDecodeError(f"{path}: {VIDEO_REFUSED[rc]}")
            if rc in JPEG_REFUSED:
                raise FrameDecodeError(f"{self._frame_name(0)}: {JPEG_REFUSED[rc]}")
            why = VIDEO_NOT_AVI if rc == 3 else STATUS.get(rc, f"status {rc}")
            raise FrameDecodeError(f"Could not open video file: {path} ({why})")
        self.n_frames, self.height, self.width = n.value, h.value, w.value
        self.scale, self.rate = scale.value, rate.value
        self.threads = self._lib.fl_threads(self._handle)
        self.offsets = np.empty(self.n_frames, np.int64)
        self.sizes = np.empty(self.n_frames, np.int64)
        self._lib.fl_video_chunks(self._handle, self.offsets.ctypes.data_as(_P), self.sizes.ctypes.data_as(_P))

    def _frame_name(self, index: int) -> str:
        return f"{self.path} frame {index}"
