"""Write the frame-loader fixtures under ``tests/data/torch_loader/`` (run once; the files are committed).

    python tests/make_torch_loader_fixtures.py

* ``filters/``: fixture frames 0, 4 and 9 of ``tests/data/images``
  re-encoded with every PNG row filter (row y takes filter y mod 5);
* ``jpeg/``: the two ``tests/data/test_images`` frames as baseline JPEG
  (PIL, quality 90);
* ``formats/``: one 256x192 crop as 16-bit gray (the low byte noise), as an
  8-bit palette image of 16 entries with tRNS, and as 4-bit gray;
* ``interlaced/``: a 301x157 crop of fixture frame 3 as Adam7-interlaced
  8-bit gray, adaptive row filters.

The PNG encoder is ``chip_smoke.encode_png`` (numpy and zlib; PIL writes
no interlaced or 4-bit gray PNG).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import encode_png  # noqa: E402

DATA = REPO / "tests" / "data"
OUT = DATA / "torch_loader"


def main() -> None:
    frames = sorted((DATA / "images").glob("*.png"))
    kitti = [np.asarray(Image.open(p)) for p in frames]
    rng = np.random.default_rng(12)
    for sub in ("filters", "jpeg", "formats", "interlaced"):
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


if __name__ == "__main__":
    main()
