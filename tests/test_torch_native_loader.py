"""tpuslam_torch's native frame loader against tpuslam's on the CPU.

The reference's ``NativeFrameLoader`` is the committed
``native/build/libtpuslam_frameloader.so`` (libpng, libjpeg); the port's is
``tpuslam_torch/native/frameloader.cpp`` (PNG over zlib, JPEG with its own
decoder, no libjpeg), built here at first use.  On every fixture directory —
the four of the reference and ``tests/data/torch_loader``'s PNG filters,
JPEG, KITTI JPEG and formats (16-bit gray, palette with tRNS, 4-bit gray) — the two
return identical bytes, and the port's plain decoder (``decode_png_gray8``)
agrees with the loader on every PNG.  The interlaced fixture decodes to its
source image, as the reference's OpenCV path does; the reference's loader
reads its Adam7 pass rows as image rows (ROADMAP F5).  Files written here by
``tpuslam_torch.post.png.encode_png`` cover every colour type and bit depth,
interlaced or not, against the conversion computed in numpy.
"""

import cv2
import numpy as np
import pytest

from tpuslam_torch.post.png import encode_png
from tpuslam.pre import native_loader as ref_loader
from tpuslam_torch.pre import native_loader
from tpuslam_torch.pre.stream import FrameStream, PngError, decode_png_gray8

DIRS = ["images", "images_test_loop", "images_test_loop2", "test_images",
        "torch_loader/filters", "torch_loader/jpeg", "torch_loader/formats", "torch_loader/jpeg_kitti"]


def gray_of(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int64)
    return ((4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2] + 8192) >> 14).astype(np.uint8)


@pytest.mark.parametrize("name", DIRS)
def test_loader_matches_reference(data_dir, name):
    path = data_dir / name
    got = native_loader.NativeFrameLoader(path)
    want = ref_loader.NativeFrameLoader(path)
    assert (got.n_frames, got.height, got.width) == (want.n_frames, want.height, want.width)
    assert got.threads >= 2
    np.testing.assert_array_equal(got.decode_batch(0, got.n_frames), want.decode_batch(0, want.n_frames))


@pytest.mark.parametrize("name", [d for d in DIRS if "jpeg" not in d] + ["torch_loader/interlaced"])
def test_plain_decoder_matches_loader(data_dir, name):
    loader = native_loader.NativeFrameLoader(data_dir / name)
    frames = loader.decode_batch(0, loader.n_frames)
    for frame, path in zip(frames, loader.files):
        np.testing.assert_array_equal(decode_png_gray8(path), frame, err_msg=str(path))


def test_interlaced_decodes_to_its_source(data_dir):
    """The port reads the image, as the reference's cv2 path does; the reference's loader reads pass rows."""
    source = cv2.imread(str(data_dir / "images" / "0000000003.png"), cv2.IMREAD_GRAYSCALE)[100:257, 400:701]
    path = data_dir / "torch_loader" / "interlaced"
    got = native_loader.NativeFrameLoader(path).decode_batch(0, 1)[0]
    np.testing.assert_array_equal(got, source)
    np.testing.assert_array_equal(cv2.imread(str(path / "0.png"), cv2.IMREAD_GRAYSCALE), source)
    assert not np.array_equal(ref_loader.NativeFrameLoader(path).decode_batch(0, 1)[0], source)


def test_jpeg_matches_reference_libjpeg(data_dir):
    """Bit for bit with the reference's libjpeg decode; within a level of OpenCV's."""
    path = data_dir / "torch_loader" / "jpeg"
    got = native_loader.NativeFrameLoader(path).decode_batch(0, 2)
    np.testing.assert_array_equal(got, ref_loader.NativeFrameLoader(path).decode_batch(0, 2))
    for frame, p in zip(got, sorted(path.glob("*.jpg"))):
        want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        assert np.abs(frame.astype(int) - want.astype(int)).max() <= 1


CASES = {  # name: (samples, colour, depth, expected gray) on a 37 x 53 crop
    "gray1": lambda c, rgb, rng: (c >> 7, 0, 1, (c >> 7) * 255),
    "gray2": lambda c, rgb, rng: (c >> 6, 0, 2, (c >> 6) * 85),
    "gray4": lambda c, rgb, rng: (c >> 4, 0, 4, (c >> 4) * 17),
    "gray8": lambda c, rgb, rng: (c, 0, 8, c),
    "gray16": lambda c, rgb, rng: (c.astype(np.uint16) * 256 + rng.integers(0, 256, c.shape).astype(np.uint16),
                                   0, 16, c),
    "gray_alpha8": lambda c, rgb, rng: (np.stack([c, c[::-1]], -1), 4, 8, c),
    "rgb8": lambda c, rgb, rng: (rgb, 2, 8, gray_of(rgb)),
    "rgba16": lambda c, rgb, rng: (np.concatenate([rgb.astype(np.uint16) * 256 + 7,
                                                   rng.integers(0, 65536, c.shape + (1,)).astype(np.uint16)], -1),
                                   6, 16, gray_of(rgb)),
}


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("case", list(CASES) + ["palette4", "palette8"])
def test_every_format(tmp_path, kitti_frames, case, interlace):
    rng = np.random.default_rng(len(case))
    crop = kitti_frames[2][:37, :53]
    rgb = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    kw = {}
    if case.startswith("palette"):
        depth = int(case[-1])
        palette = rng.integers(0, 256, (12, 3)).astype(np.uint8)
        samples = rng.integers(0, 16, crop.shape).astype(np.uint8)  # indices 12-15 lie past the palette: black
        table = np.zeros(256, np.uint8)
        table[:12] = gray_of(palette)
        colour, want = 3, table[samples]
        kw = dict(palette=palette, trns=bytes(range(12)))
    else:
        samples, colour, depth, want = CASES[case](crop, rgb, rng)
    (tmp_path / "0.png").write_bytes(encode_png(samples, colour, depth, interlace=interlace, **kw))
    np.testing.assert_array_equal(native_loader.NativeFrameLoader(tmp_path).decode_batch(0, 1)[0], want)
    np.testing.assert_array_equal(decode_png_gray8(tmp_path / "0.png"), want)
    if not interlace:  # the reference's libpng path agrees where it reads the file right
        np.testing.assert_array_equal(ref_loader.NativeFrameLoader(tmp_path).decode_batch(0, 1)[0], want)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (2, 9), (9, 2)])
def test_interlaced_passes_that_are_empty(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    (tmp_path / "0.png").write_bytes(encode_png(img, interlace=True))
    np.testing.assert_array_equal(native_loader.NativeFrameLoader(tmp_path).decode_batch(0, 1)[0], img)
    np.testing.assert_array_equal(decode_png_gray8(tmp_path / "0.png"), img)


def test_decode_indices_with_gaps_into_a_buffer(data_dir, kitti_frames):
    loader = native_loader.NativeFrameLoader(data_dir / "images")
    idx = [0, 1, 2, 5, 8, 9, 9, 3]
    out = np.full((len(idx), 512, 1392), 7, np.uint8)
    assert loader.decode_indices(idx, out) is out
    for row, i in zip(out, idx):
        np.testing.assert_array_equal(row, kitti_frames[i])
    np.testing.assert_array_equal(out[:6], ref_loader.NativeFrameLoader(data_dir / "images").decode_indices(idx[:6]))
    with pytest.raises(ValueError, match="C-contiguous"):
        loader.decode_indices([0, 1], out[:, :, :100])
    assert loader.decode_indices([]).shape == (0, 512, 1392)


def test_out_of_range(data_dir):
    loader = native_loader.NativeFrameLoader(data_dir / "images")
    with pytest.raises(IndexError, match="out of range"):
        loader.decode_batch(8, 5)
    for bad in ([10], [0, -1]):
        with pytest.raises(IndexError, match="out of range"):
            loader.decode_indices(bad)


def test_bad_directory(tmp_path):
    with pytest.raises(RuntimeError, match="Could not open"):
        native_loader.NativeFrameLoader(tmp_path)
    with pytest.raises(RuntimeError, match="Could not open"):
        native_loader.NativeFrameLoader(tmp_path / "missing")


def test_corrupt_and_mismatched_frames_are_named(tmp_path, kitti_frames):
    img = kitti_frames[0][:40, :60]
    good = encode_png(img)
    (tmp_path / "0.png").write_bytes(good)
    (tmp_path / "1.png").write_bytes(good[:-40])  # truncated: the IDAT's CRC fails
    (tmp_path / "2.png").write_bytes(encode_png(img[:, :50]))
    loader = native_loader.NativeFrameLoader(tmp_path)
    with pytest.raises(native_loader.FrameDecodeError, match="1.png: corrupt"):
        loader.decode_indices([0, 1])
    with pytest.raises(native_loader.FrameDecodeError, match="2.png: its size differs"):
        loader.decode_indices([2])
    with pytest.raises(PngError):
        decode_png_gray8(tmp_path / "1.png")


def test_jpeg_decodes_without_a_libjpeg_build_flag(data_dir):
    """The loader builds with the same flags everywhere (no libjpeg probe, no JPEG define or library) and
    decodes JPEG with its own decoder to the reference's libjpeg bytes."""
    lib = native_loader.build_library(native_loader._compiler())
    command = lib.with_suffix(".log").read_text().splitlines()[0]
    assert "jpeg" not in command.lower() and "-lz" in command
    assert not any("jpeg" in f.lower() for f in native_loader.CXX_FLAGS + native_loader.LIBS)
    path = data_dir / "torch_loader" / "jpeg_kitti"
    np.testing.assert_array_equal(native_loader.NativeFrameLoader(path).decode_batch(0, 3),
                                  ref_loader.NativeFrameLoader(path).decode_batch(0, 3))


def test_no_silent_fallback(data_dir, tmp_path, monkeypatch):
    """A build that fails raises naming the compiler's log; without a compiler the stream refuses."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native_loader.LoaderBuildError, match="compiler log: .*\\.log"):
        native_loader.build_library(native_loader._compiler())
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_compiler", lambda: None)
    assert not native_loader.available()
    with pytest.raises(native_loader.LoaderBuildError, match="no C\\+\\+ compiler"):
        FrameStream(data_dir / "images")
    assert FrameStream(data_dir / "images", use_native=False).read_frame(0)[0].shape == (512, 1392)
