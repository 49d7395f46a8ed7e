"""Fuzz the port's JPEG decoders against this machine's libjpeg (not a test: run it by hand).

    python tests/fuzz_torch_jpeg.py --seeds 2 3 4 --files 400 [--no-simd]

Each file is a random crop of ``tests/data/test_images/0.png`` (1-259 pixels a
side, sometimes with noise added, sometimes gray) encoded by PIL or OpenCV
with random settings (quality 1-100; 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1;
progressive; optimised tables; restart intervals 0-3), then kept intact, cut
after its first SOS, or given 1-5 random bytes after it.  Each goes through
the port's loader (``native/frameloader.cpp``), its plain twin
(``pre/jpeg.py``) and libjpeg with gray output (a small C program linked
with ``-ljpeg``, built here into a temporary directory, whose error handler
returns instead of ending the process).  It prints, per seed, the count of
each outcome: all three agree, both port decoders refuse, libjpeg fails
(the reference's loader would end its process), or the bytes differ (with
the largest count of differing pixels).  ``--no-simd`` sets
``JSIMD_FORCENONE=1``, which makes libjpeg-turbo use its C IDCT.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

ORACLE = r"""
#include <stdio.h>
#include <setjmp.h>
#include <jpeglib.h>
struct err { struct jpeg_error_mgr mgr; jmp_buf jb; };
static void fail(j_common_ptr c) { longjmp(((struct err*)c->err)->jb, 1); }
static void quiet(j_common_ptr c, int lvl) { (void)c; (void)lvl; }
int ref_gray(const char* path, unsigned char* out, long maxn, int* h, int* w) {
  FILE* fp = fopen(path, "rb"); if (!fp) return -1;
  struct jpeg_decompress_struct ci; struct err e;
  ci.err = jpeg_std_error(&e.mgr); e.mgr.error_exit = fail; e.mgr.emit_message = quiet;
  if (setjmp(e.jb)) { jpeg_destroy_decompress(&ci); fclose(fp); return -2; }
  jpeg_create_decompress(&ci); jpeg_stdio_src(&ci, fp); jpeg_read_header(&ci, TRUE);
  ci.out_color_space = JCS_GRAYSCALE; jpeg_start_decompress(&ci);
  *h = ci.output_height; *w = ci.output_width;
  if ((long)(*h) * (*w) > maxn) { jpeg_destroy_decompress(&ci); fclose(fp); return -3; }
  while (ci.output_scanline < ci.output_height) {
    JSAMPROW r = out + (long)ci.output_scanline * (*w); jpeg_read_scanlines(&ci, &r, 1); }
  jpeg_finish_decompress(&ci); jpeg_destroy_decompress(&ci); fclose(fp); return 0;
}
"""


def build_oracle(tmp: Path) -> ctypes.CDLL:
    (tmp / "oracle.c").write_text(ORACLE)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp / "oracle.so"), str(tmp / "oracle.c"), "-ljpeg"],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "oracle.so"))
    lib.ref_gray.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    return lib


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4])
    parser.add_argument("--files", type=int, default=400)
    parser.add_argument("--no-simd", action="store_true", help="libjpeg-turbo's C IDCT (JSIMD_FORCENONE=1)")
    args = parser.parse_args(argv)
    if args.no_simd:
        os.environ["JSIMD_FORCENONE"] = "1"  # read when libjpeg first decodes, below

    import cv2
    import numpy as np
    from PIL import Image

    from tpuslam_torch.pre import native_loader
    from tpuslam_torch.pre.jpeg import JpegError, decode_jpeg_gray8

    src = np.asarray(Image.open(REPO / "tests" / "data" / "test_images" / "0.png").convert("RGB"))
    sampling = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]

    def encode(rng) -> bytes:
        h, w = rng.integers(1, 260), rng.integers(1, 260)
        y, x = rng.integers(0, 480 - h), rng.integers(0, 640 - w)
        img = src[y : y + h, x : x + w]
        if rng.random() < 0.3:
            img = np.clip(img.astype(int) + rng.integers(-60, 60, img.shape), 0, 255).astype(np.uint8)
        if rng.random() < 0.5:
            kw = dict(quality=int(rng.integers(1, 101)), subsampling=int(rng.integers(0, 3)),
                      progressive=bool(rng.random() < 0.4), optimize=bool(rng.random() < 0.3))
            im = Image.fromarray(img)
            if rng.random() < 0.2:
                im = im.convert("L")
            buf = io.BytesIO()
            im.save(buf, "JPEG", **kw)
            return buf.getvalue()
        factor = sampling[rng.integers(0, 5)]
        params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(1, 101)), cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.integers(0, 4)), cv2.IMWRITE_JPEG_PROGRESSIVE,
                  int(rng.random() < 0.4)]
        im = img[..., ::-1] if rng.random() < 0.8 else cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return cv2.imencode(".jpg", np.ascontiguousarray(im), params)[1].tobytes()

    def mutate(data: bytes, rng) -> tuple[bytes, str]:
        r, sos = rng.random(), data.find(b"\xff\xda")
        if r < 0.4:
            return data, "intact"
        if r < 0.6:
            return data[: int(rng.integers(sos + 10, len(data)))], "cut"
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 6))):
            d[int(rng.integers(sos + 14, len(d) - 2))] = int(rng.integers(0, 256))
        return bytes(d), "flipped"

    with tempfile.TemporaryDirectory(prefix="fuzz_jpeg_") as tmp:
        tmp = Path(tmp)
        oracle = build_oracle(tmp)
        (tmp / "one").mkdir()
        path = tmp / "one" / "f.jpg"
        buf = np.zeros(1 << 22, np.uint8)
        for seed in args.seeds:
            rng = np.random.default_rng(seed)
            counts: dict[str, int] = {}
            worst: dict[str, int] = {}
            for _ in range(args.files):
                data, how = mutate(encode(rng), rng)
                path.write_bytes(data)
                h, w = ctypes.c_int(), ctypes.c_int()
                rc = oracle.ref_gray(str(path).encode(), buf.ctypes.data, buf.size, ctypes.byref(h), ctypes.byref(w))
                want = buf[: h.value * w.value].reshape(h.value, w.value) if rc == 0 else None
                try:
                    got = native_loader.NativeFrameLoader(path.parent).decode_batch(0, 1)[0]
                except RuntimeError:  # FrameDecodeError, or a first frame that cannot be read
                    got = None
                try:
                    twin = decode_jpeg_gray8(path)
                except (JpegError, native_loader.FrameDecodeError):
                    twin = None
                if want is None:
                    outcome = "libjpeg fails" + (", port decodes" if got is not None else "")
                elif got is None and twin is None:
                    outcome = "both port decoders refuse"
                elif got is not None and twin is not None and np.array_equal(got, want) and np.array_equal(twin, want):
                    outcome = "agree"
                else:
                    outcome = "differ"
                    n = max(int((a != want).sum()) if a is not None and a.shape == want.shape else a_size
                            for a, a_size in ((got, want.size), (twin, want.size)))
                    worst[how] = max(worst.get(how, 0), n)
                key = f"{how}: {outcome}"
                counts[key] = counts.get(key, 0) + 1
            print(f"seed {seed}{' (libjpeg SIMD off)' if args.no_simd else ''}: "
                  + ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))
                  + (f"; most pixels differing: {worst}" if worst else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
