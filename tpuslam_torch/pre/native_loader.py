"""The port's threaded frame decoder: ``native/frameloader.cpp`` bound through ``ctypes``.

Port of ``tpuslam/pre/native_loader.py``.  The C++ source is the port's own
(the reference's copy needs libpng; this one decodes PNG over zlib), built
with ``c++ -O3 -std=c++17 -fPIC`` at first use into ``build/tpuslam_torch/``
at the repository root, under a file name keyed on a hash of the source,
flags and libraries — never at import, and never with ``-march=native``, so
a build is only loaded where its key says it belongs.  JPEG support is
compiled in where the machine has libjpeg (a probe compile decides);
without it a directory of JPEG frames raises at open.

There is no fallback: a failed build raises ``LoaderBuildError`` naming the
compiler's log, and a frame that does not decode raises
``FrameDecodeError`` naming the file.  ``pre/stream.py::decode_png_gray8``
is the loader's plain version, used only where the caller asks for it
(``FrameStream(use_native=False)``).
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
JPEG = (("-DTPUSLAM_HAVE_JPEG",), ("-ljpeg",))  # added flags and libraries where libjpeg links
_JPEG_PROBE = ("#include <cstdio>\n#include <jpeglib.h>\n"
               "int main() { jpeg_decompress_struct c; jpeg_error_mgr e; c.err = jpeg_std_error(&e);\n"
               "  jpeg_create_decompress(&c); jpeg_destroy_decompress(&c); return 0; }\n")
FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")  # a directory's frames, as the reference lists them
STATUS = {
    1: "cannot open the file",
    2: "out of memory",
    3: "corrupt, or not a PNG/JPEG frame the loader reads",
    4: "its size differs from the first frame's",
    5: "frame index out of range",
    6: "a JPEG frame, and this machine's build of the loader has no libjpeg",
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "fl_open_dir": (_P, (ctypes.c_char_p, _IP, _IP, _IP)),
    "fl_decode_batch": (_I, (_P, _I, _I, _P)),
    "fl_decode_indices": (_I, (_P, _IP, _I, _P, _IP)),
    "fl_threads": (_I, (_P,)),
    "fl_has_jpeg": (_I, ()),
    "fl_close": (None, (_P,)),
}


class LoaderBuildError(RuntimeError):
    """The frame loader could not be built on this machine."""


class FrameDecodeError(RuntimeError):
    """A frame, or a frame directory, the loader cannot read (names the file and the reason)."""


def _compiler() -> str | None:
    return shutil.which("c++")


def _links_libjpeg(cxx: str) -> bool:
    """Whether a program using libjpeg compiles and links here."""
    src = BUILD_DIR / f"jpeg_probe.{os.getpid()}.cpp"
    exe = src.with_suffix(".out")
    src.write_text(_JPEG_PROBE)
    try:
        proc = subprocess.run([cxx, "-std=c++17", str(src), "-o", str(exe), "-ljpeg"],
                              capture_output=True, timeout=120)
        return proc.returncode == 0
    finally:
        src.unlink(missing_ok=True)
        exe.unlink(missing_ok=True)


def build_library(cxx: str) -> Path:
    """Compile the loader if this exact build is not on disk; return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags, libs = CXX_FLAGS, LIBS
    if _links_libjpeg(cxx):
        flags, libs = flags + JPEG[0], libs + JPEG[1]
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


def has_jpeg() -> bool:
    """Whether this machine's build decodes JPEG (libjpeg was found)."""
    return bool(library().fl_has_jpeg())


class NativeFrameLoader:
    """Threaded batch decoder over a directory of .png/.jpg/.jpeg frames, in lexical order."""

    def __init__(self, directory: str | Path):
        self._handle = None
        self._lib = library()
        self.directory = Path(directory)
        self.files = sorted(p for p in self.directory.iterdir() if p.is_file()
                            and p.suffix.lower() in FRAME_SUFFIXES) if self.directory.is_dir() else []
        jpegs = [p for p in self.files if p.suffix.lower() in (".jpg", ".jpeg")]
        if jpegs and not self._lib.fl_has_jpeg():
            raise FrameDecodeError(f"{jpegs[0]}: {STATUS[6]}")
        n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        self._handle = self._lib.fl_open_dir(str(directory).encode(), ctypes.byref(n), ctypes.byref(h),
                                             ctypes.byref(w))
        if not self._handle:
            why = f"the first frame {self.files[0]} cannot be read" if self.files else "no .png/.jpg/.jpeg frames"
            raise RuntimeError(f"Could not open frame directory: {directory} ({why})")
        self.n_frames, self.height, self.width = n.value, h.value, w.value
        self.threads = self._lib.fl_threads(self._handle)

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
            frame = self.files[int(idx[failed.value])] if failed.value >= 0 else "a frame"
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

    def __enter__(self) -> "NativeFrameLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
