"""tpuslam_torch's FrameStream against tpuslam's on the CPU, on every fixture directory.

The reference's stream decodes through its native loader (the committed
``.so``); the port's through its own loader by default and, with
``use_native=False``, through ``decode_png_gray8``.  ``read_frame``,
``__iter__`` with ``frame_skip``, ``batches`` (padding, ``valid``,
timestamps, ``start_frame``) and ``frames_to_memmap`` give the reference's
bytes, JPEG included (the reference's libjpeg, the port's own decoder).
``test_frame_stream_reads_colour_fixtures`` is the colour repair:
the port used to refuse the RGBA loop fixture and the RGB test images.
"""

import numpy as np
import pytest

from tpuslam.pre.stream import FrameStream as JFrameStream
from tpuslam.pre.stream import frames_to_memmap as j_frames_to_memmap
from tpuslam_torch.pre import stream as tstream
from tpuslam_torch.pre.native_loader import FrameDecodeError
from tpuslam_torch.pre.stream import FrameStream, frames_to_memmap

DIRS = ["images", "images_test_loop", "images_test_loop2", "test_images",
        "torch_loader/filters", "torch_loader/jpeg", "torch_loader/formats", "torch_loader/jpeg_kitti"]


def test_frame_stream_reads_colour_fixtures(data_dir):
    for name in ("images_test_loop2", "test_images"):
        got, want = FrameStream(data_dir / name), JFrameStream(data_dir / name)
        assert got.total_frames == want.total_frames > 0
        for i in range(got.total_frames):
            np.testing.assert_array_equal(got.read_frame(i)[0], want.read_frame(i)[0])


@pytest.mark.parametrize("name", DIRS)
def test_read_frame_and_iter(data_dir, name):
    got, want = FrameStream(data_dir / name), JFrameStream(data_dir / name)
    assert got.total_frames == want.total_frames
    for i in range(got.total_frames):
        (g, gt), (w, wt) = got.read_frame(i), want.read_frame(i)
        np.testing.assert_array_equal(g, w)
        assert gt == wt
    for skip in (1, 2):
        g_all = list(FrameStream(data_dir / name, frame_skip=skip))
        w_all = list(JFrameStream(data_dir / name, frame_skip=skip))
        assert len(g_all) == len(w_all)
        for (g, gt), (w, wt) in zip(g_all, w_all):
            np.testing.assert_array_equal(g, w)
            assert gt == wt


@pytest.mark.parametrize("name", ["images", "images_test_loop2", "torch_loader/jpeg"])
@pytest.mark.parametrize("batch,start", [(4, 0), (3, 1), (16, 0)])
def test_batches(data_dir, name, batch, start):
    got = list(FrameStream(data_dir / name).batches(batch, start_frame=start))
    want = list(JFrameStream(data_dir / name).batches(batch, start_frame=start))
    assert len(got) == len(want) > 0
    for (gf, gs, gv), (wf, ws, wv) in zip(got, want):
        assert gf.shape == wf.shape and gf.dtype == np.uint8
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gv, wv)
    last = got[-1]
    n = int(last[2].sum())
    if n < batch:  # padding repeats the last real frame and its stamp
        np.testing.assert_array_equal(last[0][n:], np.repeat(last[0][n - 1 : n], batch - n, 0))
        assert (last[1][n:] == last[1][n - 1]).all()


def test_batches_skip_with_timestamps(data_dir):
    got = list(FrameStream(data_dir / "images", frame_skip=1).batches(2, start_frame=1))
    want = list(JFrameStream(data_dir / "images", frame_skip=1).batches(2, start_frame=1))
    assert [int(v.sum()) for _, _, v in got] == [2, 2]
    for (gf, gs, gv), (wf, ws, wv) in zip(got, want):
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gs, ws)
        assert gs.dtype == np.float64 and gs[0] > 1e9  # seconds since the epoch from timestamps.txt


@pytest.mark.parametrize("name", ["images", "torch_loader/formats", "torch_loader/jpeg"])
def test_frames_to_memmap(data_dir, tmp_path, name, monkeypatch):
    monkeypatch.setattr(tstream, "MEMMAP_CHUNK", 2)  # several decode calls on a small directory
    got_stream, want_stream = FrameStream(data_dir / name), JFrameStream(data_dir / name)
    idx = list(range(got_stream.total_frames))[::-1]
    got = frames_to_memmap(got_stream, idx, tmp_path / "got.u8")
    want = j_frames_to_memmap(want_stream, idx, tmp_path / "want.u8")
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["images", "images_test_loop", "test_images", "torch_loader/formats"])
def test_plain_decoder_gives_the_same_bytes(data_dir, name):
    native, plain = FrameStream(data_dir / name), FrameStream(data_dir / name, use_native=False)
    assert plain._native is None
    for (a, _, _), (b, _, _) in zip(native.batches(4), plain.batches(4)):
        np.testing.assert_array_equal(a, b)


def test_native_never_decodes_in_python(data_dir, monkeypatch):
    def refuse(path):
        raise AssertionError(f"decoded {path} in Python")

    monkeypatch.setattr(tstream, "decode_png_gray8", refuse)
    st = FrameStream(data_dir / "images")
    assert next(st.batches(4))[0].shape == (4, 512, 1392)
    assert st.read_frame(3)[0].shape == (512, 1392)


@pytest.mark.parametrize("name", ["torch_loader/jpeg", "torch_loader/jpeg_variants"])
def test_plain_decoder_reads_jpeg(data_dir, name):
    """``use_native=False`` reads JPEG through ``decode_jpeg_gray8``, equal to the loader; both refuse CMYK."""
    native, plain = FrameStream(data_dir / name), FrameStream(data_dir / name, use_native=False)
    assert plain._native is None
    good = [i for i, p in enumerate(native._files) if p.stem[:2] not in ("98", "99")]
    np.testing.assert_array_equal(plain.read_frames(good), native.read_frames(good))
    if len(good) < native.total_frames:
        with pytest.raises(FrameDecodeError, match="CMYK"):
            plain.read_frames([good[-1] + 1])


def test_empty_directory_has_no_frames(tmp_path):
    st = FrameStream(tmp_path)
    assert st.total_frames == 0 and list(st.batches(4)) == []
