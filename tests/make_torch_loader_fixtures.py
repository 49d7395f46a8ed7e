"""Write the frame-loader fixtures under ``tests/data/torch_loader/`` (run once; the files are committed).

    python tests/make_torch_loader_fixtures.py

* ``filters/``: fixture frames 0, 4 and 9 of ``tests/data/images``
  re-encoded with every PNG row filter (row y takes filter y mod 5);
* ``jpeg/``: the two ``tests/data/test_images`` frames as baseline JPEG
  (PIL, quality 90);
* ``formats/``: one 256x192 crop as 16-bit gray (the low byte noise), as an
  8-bit palette image of 16 entries with tRNS, and as 4-bit gray;
* ``interlaced/``: a 301x157 crop of fixture frame 3 as Adam7-interlaced
  8-bit gray, adaptive row filters;
* ``jpeg_kitti/``: the 10 frames of ``tests/data/images`` (1392x512) as
  baseline 4:2:0 JPEG, quality 65 (PIL);
* ``jpeg_variants/``: a 203x117 crop of ``test_images/0.png`` (not a whole
  number of MCUs either way) as one-component gray, 4:4:4, 4:2:2, 4:4:0
  (OpenCV), progressive 4:2:0, progressive gray, progressive with restart
  interval 2 (OpenCV), restart interval 3 (OpenCV), optimised Huffman
  tables, quality 100 and quality 10, a 4:2:0 file cut at half its bytes
  (inside its entropy data), and two the decoders refuse: CMYK
  (``98_cmyk.jpg``) and a baseline file whose SOF0 is patched to SOF9
  (``99_sof9.jpg``, arithmetic coding);
* ``expected_gray.npz``: what the reference's committed loader
  (``native/build/libtpuslam_frameloader.so``, libjpeg) decodes from every
  JPEG fixture it reads: ``<dir>/<file>`` → the gray bytes of each variant,
  ``<dir>/<file>:sha256`` → the SHA-256 of the gray bytes of every fixture
  (the two of ``jpeg/``, the ten of ``jpeg_kitti/`` and the variants).  A
  machine without libjpeg holds the port's decoder to libjpeg with it.

The PNG encoder is ``tpuslam_torch.post.png.encode_png`` (numpy and zlib; PIL writes
no interlaced or 4-bit gray PNG).
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpuslam_torch.post.png import encode_png  # noqa: E402

DATA = REPO / "tests" / "data"
OUT = DATA / "torch_loader"
JPEG_DIRS = ("jpeg", "jpeg_kitti", "jpeg_variants")
REFUSED = ("98_cmyk.jpg", "99_sof9.jpg")  # the reference's libjpeg would end the process on these


def write_jpeg_variants(out: Path) -> None:
    rgb = np.asarray(Image.open(DATA / "test_images" / "0.png").convert("RGB"))[100:217, 150:353]
    img = Image.fromarray(rgb)
    bgr = np.ascontiguousarray(rgb[..., ::-1])

    def cv2_jpeg(name: str, *params: int) -> None:
        ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
        assert ok
        (out / name).write_bytes(buf.tobytes())

    img.convert("L").save(out / "00_gray.jpg", "JPEG", quality=90)
    img.save(out / "01_444.jpg", "JPEG", quality=90, subsampling=0)
    img.save(out / "02_422.jpg", "JPEG", quality=90, subsampling=1)
    cv2_jpeg("03_440.jpg", cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)
    img.save(out / "04_progressive.jpg", "JPEG", quality=90, subsampling=2, progressive=True)
    img.convert("L").save(out / "05_gray_progressive.jpg", "JPEG", quality=90, progressive=True)
    cv2_jpeg("06_progressive_restart2.jpg", cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    cv2_jpeg("07_restart3.jpg", cv2.IMWRITE_JPEG_RST_INTERVAL, 3)
    img.save(out / "08_optimized.jpg", "JPEG", quality=90, subsampling=2, optimize=True)
    img.save(out / "09_q100.jpg", "JPEG", quality=100, subsampling=2)
    img.save(out / "10_q10.jpg", "JPEG", quality=10, subsampling=2)
    whole = out / "11_truncated.jpg"
    img.save(whole, "JPEG", quality=90, subsampling=2)
    data = whole.read_bytes()
    whole.write_bytes(data[: len(data) // 2])
    img.convert("CMYK").save(out / REFUSED[0], "JPEG", quality=90)
    base = (out / "01_444.jpg").read_bytes()
    sof = base.index(b"\xff\xc0")
    (out / REFUSED[1]).write_bytes(base[:sof] + b"\xff\xc9" + base[sof + 2 :])


def write_expected_gray() -> None:
    """Every JPEG fixture the reference's libjpeg loader reads, decoded by it (its bytes, or their digest)."""
    from tpuslam.pre.native_loader import NativeFrameLoader

    expected = {}
    for sub in JPEG_DIRS:
        loader = NativeFrameLoader(OUT / sub)
        for i, path in enumerate(sorted((OUT / sub).glob("*.jp*g"))):
            if path.name in REFUSED:
                continue
            gray = loader.decode_indices([i])[0]
            expected[f"{sub}/{path.name}:sha256"] = np.frombuffer(hashlib.sha256(gray.tobytes()).digest(), np.uint8)
            if sub == "jpeg_variants":
                expected[f"{sub}/{path.name}"] = gray
    np.savez_compressed(OUT / "expected_gray.npz", **expected)


def main() -> None:
    frames = sorted((DATA / "images").glob("*.png"))
    kitti = [np.asarray(Image.open(p)) for p in frames]
    rng = np.random.default_rng(12)
    for sub in ("filters", "jpeg", "formats", "interlaced", "jpeg_kitti", "jpeg_variants"):
        (OUT / sub).mkdir(parents=True, exist_ok=True)
    for i in (0, 4, 9):
        img = kitti[i]
        (OUT / "filters" / frames[i].name).write_bytes(encode_png(img, filters=np.arange(img.shape[0]) % 5))
    for p in sorted((DATA / "test_images").glob("*.png")):
        Image.open(p).convert("RGB").save(OUT / "jpeg" / f"{p.stem}.jpg", "JPEG", quality=90)
    crop = kitti[5][200:392, 600:856]
    low = rng.integers(0, 256, crop.shape).astype(np.uint16)
    (OUT / "formats" / "0_gray16.png").write_bytes(encode_png(crop.astype(np.uint16) * 256 + low, depth=16))
    rgb = np.asarray(Image.open(DATA / "test_images" / "0.png").convert("RGB"))[100:292, 200:456]
    quant = Image.fromarray(rgb).quantize(16)
    palette = np.asarray(quant.getpalette()[:48], np.uint8).reshape(16, 3)
    (OUT / "formats" / "1_palette_trns.png").write_bytes(
        encode_png(np.asarray(quant), colour=3, palette=palette, trns=bytes(range(0, 256, 16))))
    (OUT / "formats" / "2_gray4.png").write_bytes(encode_png(crop >> 4, depth=4))
    (OUT / "interlaced" / "0.png").write_bytes(encode_png(kitti[3][100:257, 400:701], interlace=True))
    for p, img in zip(frames, kitti):
        Image.fromarray(img).convert("RGB").save(OUT / "jpeg_kitti" / f"{p.stem}.jpg", "JPEG", quality=65,
                                                 subsampling=2)
    write_jpeg_variants(OUT / "jpeg_variants")
    write_expected_gray()


if __name__ == "__main__":
    main()
