"""Build and load the hand-written CUDA kernels (``tpuslam_torch/csrc/*.cu``).

Each source compiles with its own ``nvcc`` for ``sm_90a``, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ``ctypes``.  The build happens at first use,
into ``build/tpuslam_torch/`` at the repository root, under a file name
keyed on a hash of the sources, headers and flags — a checkout builds
everything it needs on its own, and a stale library is never loaded.
Nothing here runs at import time: a CPU-only machine imports every module
and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuslam_torch"
SOURCES = ("frontend.cu", "nms.cu", "brief.cu", "pose.cu", "jacobi.cu")
HEADERS = ("fast.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers, shared memory and spills, kept in .log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: argument types (every function returns cudaGetLastError())
    "tpuslam_frontend": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "tpuslam_frontend_nms": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "tpuslam_extract_patches": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "tpuslam_own_bin_dots": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tpuslam_msac_scores": (_P, _P, _P, _I, _I, _I, _P),
    "tpuslam_jacobi_nullvec": (_P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P, _L, _P),
}


class KernelLibrary:
    """The loaded shared library, how long its build took, and the compiler's report."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib.tpuslam_error_string.argtypes = (ctypes.c_int,)
        self._lib.tpuslam_error_string.restype = ctypes.c_char_p

    def call(self, name: str, *args) -> None:
        """Launch through the C entry ``name``; raise if the launch failed."""
        code = getattr(self._lib, name)(*args)
        if code != 0:
            msg = self._lib.tpuslam_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; return their joined output, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build_library() -> KernelLibrary:
    """Compile the sources if this exact build is not on disk, then load it."""
    target = BUILD_DIR / f"libtpuslam_kernels_{_digest()}.so"
    log_path = target.with_suffix(".log")
    seconds = 0.0
    if not target.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{target.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{stem}.{Path(s).stem}.o" for s in SOURCES]
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                        for s, o in zip(SOURCES, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
        seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink()
        log_path.write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    log = log_path.read_text() if log_path.is_file() else ""
    return KernelLibrary(target, seconds, log)


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process's kernel library, built and loaded on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build_library()
    return _LIBRARY
