"""tpuslam_torch's JPEG decoders against the reference's libjpeg loader, on the CPU.

The port decodes JPEG with its own code: ``native/frameloader.cpp`` (the
loader, linked against zlib only) and its plain twin
``pre/jpeg.py::decode_jpeg_gray8``.  The yardstick is the reference's
committed ``native/build/libtpuslam_frameloader.so``, which decodes through
this machine's libjpeg with gray output.  On every JPEG fixture — the two
of ``torch_loader/jpeg``, the ten KITTI frames of ``jpeg_kitti`` and the
variants of ``jpeg_variants`` (gray, 4:4:4, 4:2:2, 4:4:0, progressive with
and without restarts, restart interval 3, optimised tables, quality 100
and 10, a file cut inside its entropy data) — the three give the same
bytes, and ``expected_gray.npz`` (what a machine without libjpeg holds the
port to) equals the reference's decode.  Each variant the decoders refuse
raises ``FrameDecodeError`` naming the frame and the variant: at open when
it is the first frame, from the decode call otherwise, and from the twin.
The reference's loader is never given a refused or corrupt file: its
libjpeg error handler ends the process.
"""

import hashlib
import shutil
import subprocess

import cv2
import numpy as np
import pytest

from tpuslam.pre import native_loader as ref_loader
from tpuslam_torch.pre import native_loader
from tpuslam_torch.pre.jpeg import JpegError, decode_jpeg_gray8

VARIANTS = ["00_gray.jpg", "01_444.jpg", "02_422.jpg", "03_440.jpg", "04_progressive.jpg",
            "05_gray_progressive.jpg", "06_progressive_restart2.jpg", "07_restart3.jpg", "08_optimized.jpg",
            "09_q100.jpg", "10_q10.jpg", "11_truncated.jpg"]
REFUSED = ["98_cmyk.jpg", "99_sof9.jpg"]


def loader_dir(data_dir, sub):
    return data_dir / "torch_loader" / sub


def reference_decode(path):
    """The reference's libjpeg loader on one file, alone in its directory."""
    loader = ref_loader.NativeFrameLoader(path.parent)
    files = sorted(p for p in path.parent.iterdir() if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    return loader.decode_indices([files.index(path)])[0]


@pytest.fixture(scope="module")
def variant_frames(data_dir):
    """Each accepted variant decoded by the reference's loader, the port's loader and the twin."""
    d = loader_dir(data_dir, "jpeg_variants")
    port = native_loader.NativeFrameLoader(d)
    out = {}
    for name in VARIANTS:
        i = [p.name for p in port.files].index(name)
        out[name] = (reference_decode(d / name), port.decode_indices([i])[0], decode_jpeg_gray8(d / name))
    return out


@pytest.mark.parametrize("sub", ["jpeg", "jpeg_kitti"])
def test_loader_matches_reference_libjpeg(data_dir, sub):
    d = loader_dir(data_dir, sub)
    got, want = native_loader.NativeFrameLoader(d), ref_loader.NativeFrameLoader(d)
    assert (got.n_frames, got.height, got.width) == (want.n_frames, want.height, want.width)
    frames = got.decode_batch(0, got.n_frames)
    np.testing.assert_array_equal(frames, want.decode_batch(0, want.n_frames))
    for i, p in enumerate(got.files):  # the pool and one call a frame give the same bytes
        np.testing.assert_array_equal(got.decode_indices([i])[0], frames[i], err_msg=str(p))


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_matches_reference_libjpeg(variant_frames, name):
    want, got, twin = variant_frames[name]
    assert got.shape == (117, 203)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twin, want)


def test_truncated_file_reads_as_libjpeg_does(data_dir, tmp_path):
    """Cut at half its bytes: libjpeg warns, reads the missing bits as zeros and leaves the rest gray."""
    data = (loader_dir(data_dir, "jpeg") / "0.jpg").read_bytes()
    path = tmp_path / "0.jpg"
    path.write_bytes(data[: len(data) // 2])
    got = native_loader.NativeFrameLoader(tmp_path).decode_batch(0, 1)[0]
    np.testing.assert_array_equal(got, reference_decode(path))
    np.testing.assert_array_equal(got, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(decode_jpeg_gray8(path), got)
    assert (got[224:] == 128).all() and not (got[:224] == 128).all()


@pytest.mark.parametrize("sub", ["jpeg", "jpeg_kitti"])
def test_plain_twin_matches_loader(data_dir, sub):
    d = loader_dir(data_dir, sub)
    loader = native_loader.NativeFrameLoader(d)
    for frame, path in zip(loader.decode_batch(0, loader.n_frames), loader.files):
        np.testing.assert_array_equal(decode_jpeg_gray8(path), frame, err_msg=str(path))


@pytest.mark.parametrize("sub", ["jpeg", "jpeg_kitti", "jpeg_variants"])
def test_expected_gray_is_the_reference_decode(data_dir, sub, variant_frames):
    """The committed bytes cannot go stale: the reference's loader decodes every fixture to them."""
    expected = np.load(data_dir / "torch_loader" / "expected_gray.npz")
    names = VARIANTS if sub == "jpeg_variants" else [p.name for p in sorted(loader_dir(data_dir, sub).glob("*.jpg"))]
    assert {k for k in expected.files if k.startswith(f"{sub}/") and k.endswith(":sha256")} == \
        {f"{sub}/{n}:sha256" for n in names}
    for name in names:
        gray = variant_frames[name][0] if sub == "jpeg_variants" else reference_decode(loader_dir(data_dir, sub) / name)
        assert hashlib.sha256(gray.tobytes()).digest() == expected[f"{sub}/{name}:sha256"].tobytes(), name
        if sub == "jpeg_variants":
            np.testing.assert_array_equal(expected[f"{sub}/{name}"], gray)


def _segments(data: bytes):
    """(marker, offset of its length field) of each marker segment before the first SOS's data."""
    out, i = [], 2
    while True:
        m = data[i + 1]
        out.append((m, i + 2))
        if m == 0xDA:
            return out
        i += 2 + int.from_bytes(data[i + 2 : i + 4], "big")


def _sof(data: bytes) -> int:
    return next(off for m, off in _segments(data) if m in (0xC0, 0xC1, 0xC2))


def _patched(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new) :]


def _adobe_rgb(data: bytes) -> bytes:
    """The JFIF APP0 replaced by an Adobe APP14 whose transform 0 says RGB."""
    app0 = next(off for m, off in _segments(data) if m == 0xE0)
    end = app0 + int.from_bytes(data[app0 : app0 + 2], "big")
    return data[: app0 - 2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00" + data[end:]


def _rgb_ids(data: bytes) -> bytes:
    """No JFIF marker, and components named R, G, B in the SOF and the SOS."""
    sof, sos = _sof(data), next(off for m, off in _segments(data) if m == 0xDA)
    for k, cid in enumerate(b"RGB"):
        data = _patched(data, sof + 8 + 3 * k, bytes([cid]))
        data = _patched(data, sos + 3 + 2 * k, bytes([cid]))
    app0 = next(off for m, off in _segments(data) if m == 0xE0)
    return data[: app0 - 2] + data[app0 + int.from_bytes(data[app0 : app0 + 2], "big") :]


def _first_scan_only(data: bytes) -> bytes:
    """A progressive file cut after its first (DC) scan: luma's AC never arrives, so libjpeg would smooth."""
    first = next(off for m, off in _segments(data) if m == 0xDA)
    nxt = data.index(b"\xff\xc4", first)  # the tables of the second scan
    return data[:nxt] + b"\xff\xd9"


REFUSALS = {  # variant: (source fixture, patch, words of the error)
    "cmyk": ("98_cmyk.jpg", None, "CMYK"),
    "arithmetic": ("99_sof9.jpg", None, "arithmetic"),
    "lossless": ("01_444.jpg", lambda d: _patched(d, _sof(d) - 1, b"\xc3"), "lossless"),
    "hierarchical": ("01_444.jpg", lambda d: _patched(d, _sof(d) - 1, b"\xc5"), "hierarchical"),
    "12-bit": ("01_444.jpg", lambda d: _patched(d, _sof(d) + 2, b"\x0c"), "12-bit"),
    "dnl": ("01_444.jpg", lambda d: _patched(d, _sof(d) + 3, b"\x00\x00"), "DNL"),
    "adobe-rgb": ("01_444.jpg", _adobe_rgb, "RGB"),
    "rgb-ids": ("01_444.jpg", _rgb_ids, "RGB"),
    "luma-subsampled": ("02_422.jpg", lambda d: _patched(_patched(d, _sof(d) + 9, b"\x11"), _sof(d) + 12, b"\x21"),
                        "luma is sampled below"),
    "smoothing": ("04_progressive.jpg", _first_scan_only, "smooths"),
}


@pytest.mark.parametrize("variant", list(REFUSALS))
def test_refused_variant_raises_named_error(data_dir, tmp_path, variant):
    source, patch, words = REFUSALS[variant]
    data = (loader_dir(data_dir, "jpeg_variants") / source).read_bytes()
    data = patch(data) if patch else data
    alone, after = tmp_path / "alone", tmp_path / "after"
    alone.mkdir()
    after.mkdir()
    (alone / "0.jpg").write_bytes(data)
    shutil.copy(loader_dir(data_dir, "jpeg_variants") / "01_444.jpg", after / "0.jpg")
    (after / "1.jpg").write_bytes(data)
    with pytest.raises(native_loader.FrameDecodeError, match=words) as err:
        native_loader.NativeFrameLoader(alone).decode_batch(0, 1)  # refused at open, or (smoothing) decoding
    assert "0.jpg" in str(err.value)
    loader = native_loader.NativeFrameLoader(after)
    with pytest.raises(native_loader.FrameDecodeError, match=f"1.jpg: .*{words}"):
        loader.decode_indices([0, 1])
    np.testing.assert_array_equal(loader.decode_indices([0])[0], decode_jpeg_gray8(after / "0.jpg"))
    with pytest.raises(native_loader.FrameDecodeError, match=words):
        decode_jpeg_gray8(alone / "0.jpg")


def test_corrupt_streams_agree_and_never_end_the_process(data_dir, tmp_path):
    """Bytes flipped in the entropy data, or the file cut: the loader and the twin give the same bytes or
    both reject it (the loader as ``FrameDecodeError``, the twin as ``JpegError``)."""
    rng = np.random.default_rng(15)
    sources = [loader_dir(data_dir, "jpeg_variants") / n for n in VARIANTS[:10]]
    agreed = 0
    for k in range(24):
        data = bytearray(sources[k % len(sources)].read_bytes())
        start = next(off for m, off in _segments(bytes(data)) if m == 0xDA) + 12
        if k % 3 == 2:
            data = data[: int(rng.integers(start, len(data)))]
        else:
            for _ in range(3):
                data[int(rng.integers(start, len(data) - 2))] = int(rng.integers(0, 256))
        d = tmp_path / f"{k}"
        d.mkdir()
        (d / "0.jpg").write_bytes(bytes(data))
        try:
            got = native_loader.NativeFrameLoader(d).decode_batch(0, 1)[0]
        except (native_loader.FrameDecodeError, RuntimeError):
            got = None
        try:
            twin = decode_jpeg_gray8(d / "0.jpg")
        except (JpegError, native_loader.FrameDecodeError):
            twin = None
        assert (got is None) == (twin is None), k
        if got is not None:
            np.testing.assert_array_equal(got, twin, err_msg=str(k))
            agreed += 1
    assert agreed >= 12


def test_not_a_jpeg_is_named(tmp_path):
    (tmp_path / "0.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a jpeg")
    with pytest.raises(RuntimeError, match="0.jpg cannot be read"):
        native_loader.NativeFrameLoader(tmp_path)
    with pytest.raises(JpegError):
        decode_jpeg_gray8(tmp_path / "0.jpg")


def test_loader_links_no_libjpeg():
    lib = native_loader.build_library(native_loader._compiler())
    ldd = subprocess.run(["ldd", str(lib)], capture_output=True, text=True, check=True).stdout
    assert "libz" in ldd and "jpeg" not in ldd, ldd
    log = lib.with_suffix(".log").read_text().splitlines()[0]
    assert "jpeg" not in log.lower(), log
