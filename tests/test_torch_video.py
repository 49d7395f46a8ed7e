"""tpuslam_torch's video input against the reference's ``cv2.VideoCapture`` path, on the CPU.

The port reads a Motion JPEG AVI with its own demuxer and JPEG decoder: the
loader (``native/frameloader.cpp``, ``NativeVideoLoader``) and its plain twin
(``pre/avi.py`` over ``pre/jpeg.py``).  Videos are written live by both of
OpenCV's writers (its own Motion JPEG writer and FFmpeg's, ``cv2.CAP_FFMPEG``) at
10 and 30000/1001 frames/s, and by ``chip_smoke.write_mjpeg_avi`` (one RIFF,
and OpenDML "AVIX" RIFFs after the first), on 150x90 gray KITTI crops.  Against the
reference's ``FrameStream`` on the same file: the frame count and the
timestamps (to 1e-9 s), ``frame_indices`` under ``frame_skip`` (the
reference seeks, the port reads by index), ``batches`` (padding, ``valid``,
``start_frame``) and each frame within ``BOUND`` gray levels — the
reference's frame is FFmpeg's decode converted to BGR and back to gray, the
port's the JPEG's luma (ROADMAP F5; ``tests/make_torch_video_fixtures.py
--bound`` measures it on the KITTI frames).  Bit for bit: the loader's
frames == the twin's == ``decode_jpeg_gray8_bytes`` of each payload, and the
committed writer fixtures (``tests/data/torch_video/``) == the reference's
libjpeg decode of their payloads.  Each refused video raises
``FrameDecodeError`` with its words from both demuxers, and the CLI over a
video writes the trajectory it writes over a directory of the video's JPEG
payloads, bit for bit (VO, ``--timeshard 2``).
"""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest

from chip_smoke import write_mjpeg_avi
from make_torch_video_fixtures import WRITERS, kitti_panning_frames, reference_luma, write_video
from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.pre.stream import FrameStream as RefStream
from tpuslam_torch.cli import main as cli_main
from tpuslam_torch.pre import native_loader, stream as stream_mod
from tpuslam_torch.pre.avi import open_avi
from tpuslam_torch.pre.jpeg import decode_jpeg_gray8_bytes
from tpuslam_torch.pre.native_loader import VIDEO_REFUSED, FrameDecodeError, NativeVideoLoader
from tpuslam_torch.pre.stream import FrameStream, frames_to_memmap

BOUND = 2  # gray levels between the reference's frames and the JPEG luma (ROADMAP F5)
N = 8
NTSC = 30000 / 1001
TIME_BASE = {"opencv_mjpeg.avi": (1, 10), "ffmpeg_mjpeg.avi": (100, 2997)}  # each writer's dwScale, dwRate
LIVE = ["opencv_10", "opencv_ntsc", "ffmpeg_10", "ffmpeg_ntsc", "riff", "riff_avix"]


def jpeg(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def frames():
    """Gray frames, as the monocular camera gives them: on colour, FFmpeg's YUV to BGR clips (ROADMAP F5)."""
    return kitti_panning_frames(N)


@pytest.fixture(scope="module")
def videos(tmp_path_factory, frames):
    """Each live-written video by name, and the payloads the RIFF writer was given."""
    d = tmp_path_factory.mktemp("videos")
    out = {}
    for writer, api in (("opencv", cv2.CAP_OPENCV_MJPEG), ("ffmpeg", cv2.CAP_FFMPEG)):
        out[f"{writer}_10"] = write_video(d / f"{writer}_10.avi", frames, api, 10.0)
        out[f"{writer}_ntsc"] = write_video(d / f"{writer}_ntsc.avi", frames, api, NTSC)
    payloads = [jpeg(f) for f in frames]
    out["riff"] = write_mjpeg_avi(d / "riff.avi", payloads, 150, 90, scale=1001, rate=30000)
    out["riff_avix"] = write_mjpeg_avi(d / "riff_avix.avi", payloads, 150, 90, frames_per_riff=3)
    out["payloads"] = payloads
    return out


def reference_read(path):
    """(frames, timestamps) of the reference's stream, read in order."""
    ref = RefStream(path)
    got = [ref.read_frame(i) for i in range(ref.total_frames)]
    return ref.total_frames, np.stack([g[0] for g in got]), np.array([g[1] for g in got])


def within_bound(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - ref).max() <= BOUND


@pytest.mark.parametrize("name", LIVE)
def test_stream_matches_reference(videos, name):
    port = FrameStream(videos[name])
    n, ref_frames, ref_stamps = reference_read(videos[name])
    assert not port.is_directory and port.total_frames == n == N
    got = [port.read_frame(i) for i in range(n)]
    np.testing.assert_allclose([g[1] for g in got], ref_stamps, rtol=0, atol=1e-9)
    within_bound(np.stack([g[0] for g in got]), ref_frames)
    assert [t for _, t in port] == [g[1] for g in got]


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_frame_skip_matches_reference(videos, skip):
    """The reference seeks the codec on random access; the port reads the same frames by index."""
    port, ref = FrameStream(videos["ffmpeg_ntsc"], frame_skip=skip), RefStream(videos["ffmpeg_ntsc"], frame_skip=skip)
    assert port.frame_indices() == ref.frame_indices() == list(range(0, N, 1 + skip))
    got, want = list(port), list(ref)
    assert len(got) == len(want)
    np.testing.assert_allclose([t for _, t in got], [t for _, t in want], rtol=0, atol=1e-9)
    within_bound(np.stack([f for f, _ in got]), np.stack([f for f, _ in want]))


@pytest.mark.parametrize("start_frame", [0, 2, 7])
def test_batches_match_reference(videos, start_frame):
    port, ref = FrameStream(videos["opencv_10"]), RefStream(videos["opencv_10"])
    got, want = list(port.batches(3, start_frame=start_frame)), list(ref.batches(3, start_frame=start_frame))
    assert len(got) == len(want) == -(-(N - start_frame) // 3)
    for (f, t, v), (rf, rt, rv) in zip(got, want):
        assert f.shape == (3, 90, 150) and np.array_equal(v, rv)
        np.testing.assert_allclose(t, rt, rtol=0, atol=1e-9)
        within_bound(f, rf)
        k = int(v.sum())
        assert (f[k:] == f[k - 1]).all() and (t[k:] == t[k - 1]).all()  # padding repeats the last frame


@pytest.mark.parametrize("name", LIVE)
def test_frames_equal_payload_luma(videos, name):
    """Loader == twin == decode_jpeg_gray8_bytes of each payload, bit for bit; both list the same chunks."""
    loader, twin = NativeVideoLoader(videos[name]), open_avi(videos[name])
    assert (loader.scale, loader.rate, loader.height, loader.width) == (twin.scale, twin.rate, 90, 150)
    assert np.array_equal(loader.offsets, twin.offsets) and np.array_equal(loader.sizes, twin.sizes)
    frames = loader.decode_batch(0, loader.n_frames)
    for i in range(N):
        payload = twin.payload(i)
        if name.startswith("riff"):
            assert payload == videos["payloads"][i]
        assert np.array_equal(frames[i], decode_jpeg_gray8_bytes(payload, i))
        assert np.array_equal(frames[i], twin.decode(i))
    plain = FrameStream(videos[name], use_native=False)
    assert np.array_equal(plain.read_frames(list(range(N))), frames)
    assert plain._timestamps == FrameStream(videos[name])._timestamps


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_committed_fixtures(data_dir, name):
    """The committed writer fixtures decode to their committed libjpeg bytes through the loader and the
    twin, and those bytes are the reference's libjpeg decode of the payloads."""
    path = data_dir / "torch_video" / name
    expected = np.load(data_dir / "torch_video" / "expected_luma.npz")[name]
    assert np.array_equal(reference_luma(path), expected)
    assert np.array_equal(FrameStream(path).read_frames(list(range(10))), expected)
    assert np.array_equal(FrameStream(path, use_native=False).read_frames([0, 9]), expected[[0, 9]])
    loader = NativeVideoLoader(path)
    assert loader.n_frames == int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    assert (loader.scale, loader.rate) == TIME_BASE[name]


def test_frames_to_memmap_from_video(videos, monkeypatch):
    monkeypatch.setattr(stream_mod, "MEMMAP_CHUNK", 2)
    port = FrameStream(videos["riff_avix"], frame_skip=1)
    mm = frames_to_memmap(port)
    try:
        assert mm.shape == (4, 90, 150)
        assert np.array_equal(np.asarray(mm), port.read_frames(port.frame_indices()))
    finally:
        path = mm.filename
        del mm
        os.unlink(path)


def half_height_fields(frame: np.ndarray) -> bytes:
    """One chunk of interlaced Motion JPEG: the even rows, then the odd rows, each a JPEG of half height."""
    return jpeg(frame[0::2]) + jpeg(frame[1::2])


def refused_cases(d, frames, payloads):
    """name → (path, the status whose words the demuxers raise)."""
    cases = {}
    for fourcc, ext in (("XVID", ".avi"), ("mp4v", ".mp4"), ("MJPG", ".mkv")):
        path = d / f"{fourcc}{ext}"
        w = cv2.VideoWriter(str(path), cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*fourcc), 10.0, (150, 90))
        assert w.isOpened()
        for f in frames[:3]:
            w.write(f)
        w.release()
        cases[f"{fourcc}{ext}"] = (path, 16 if ext != ".avi" else 15)
    whole = write_mjpeg_avi(d / "whole.avi", payloads, 150, 90).read_bytes()
    (d / "truncated.avi").write_bytes(whole[: len(whole) // 2])
    cases["truncated"] = (d / "truncated.avi", 19)
    fields = [half_height_fields(f) for f in frames[:3]]
    cases["interlaced"] = (write_mjpeg_avi(d / "interlaced.avi", fields, 150, 90), 17)
    cases["interlaced_vprp"] = (write_mjpeg_avi(d / "vprp.avi", payloads[:3], 150, 90, fields=2), 17)
    cases["dropped"] = (write_mjpeg_avi(d / "dropped.avi", payloads[:2] + [b""] + payloads[2:4], 150, 90), 18)
    cases["no_frames"] = (write_mjpeg_avi(d / "empty.avi", [], 150, 90), 20)
    cases["handler"] = (write_mjpeg_avi(d / "h264.avi", payloads[:2], 150, 90, handler=b"H264"), 15)
    return cases


@pytest.fixture(scope="module")
def refused(tmp_path_factory, frames, videos):
    return refused_cases(tmp_path_factory.mktemp("refused"), frames, videos["payloads"])


@pytest.mark.parametrize("case", ["XVID.avi", "mp4v.mp4", "MJPG.mkv", "truncated", "interlaced",
                                  "interlaced_vprp", "dropped", "no_frames", "handler"])
def test_refused_videos_raise_named_errors(refused, case):
    path, status = refused[case]
    words = VIDEO_REFUSED[status]
    for open_ in (NativeVideoLoader, open_avi, FrameStream, lambda p: FrameStream(p, use_native=False)):
        with pytest.raises(FrameDecodeError, match=words.replace("(", r"\(").replace(")", r"\)")) as exc:
            open_(path)
        assert str(path) in str(exc.value)


def test_corrupt_or_odd_frames_raise_named_errors(tmp_path, frames, videos):
    """Not an AVI; a refused JPEG variant as the first frame; a later frame of another size or one field."""
    png = tmp_path / "frame.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(32))
    base = videos["payloads"]
    sof = base[1].index(b"\xff\xc0")
    arithmetic = write_mjpeg_avi(tmp_path / "sof9.avi", [base[1][:sof] + b"\xff\xc9" + base[1][sof + 2:]], 150, 90)
    other = write_mjpeg_avi(tmp_path / "size.avi", base[:3] + [jpeg(frames[3][:, :100])], 150, 90)
    field = write_mjpeg_avi(tmp_path / "field.avi", base[:3] + [half_height_fields(frames[3])], 150, 90)
    for open_ in (NativeVideoLoader, open_avi):
        with pytest.raises(FrameDecodeError, match="not an AVI file"):
            open_(png)
        with pytest.raises(FrameDecodeError, match=r"sof9.avi frame 0: arithmetic-coded"):
            open_(arithmetic)
    for use_native in (True, False):
        for path, words in ((other, native_loader.STATUS[4]), (field, VIDEO_REFUSED[17])):
            s = FrameStream(path, use_native=use_native)
            assert s.read_frames([2]).shape == (1, 90, 150)
            with pytest.raises(FrameDecodeError, match=rf"frame 3: {words[:20]}"):
                s.read_frames([3])


@pytest.fixture(scope="module")
def kitti_video(tmp_path_factory, data_dir):
    """Six KITTI JPEGs (1392x512) as a directory of links and as a Motion JPEG AVI of the same payloads."""
    d = tmp_path_factory.mktemp("kitti")
    src = sorted((data_dir / "torch_loader" / "jpeg_kitti").glob("*.jpg"))[:6]
    (d / "frames").mkdir()
    for p in src:
        (d / "frames" / p.name).symlink_to(p)
    write_mjpeg_avi(d / "kitti.avi", [p.read_bytes() for p in src], 1392, 512)
    return d


@pytest.mark.parametrize("mode", [[], ["--timeshard", "2"]], ids=["vo", "timeshard"])
def test_cli_over_video_equals_directory(kitti_video, data_dir, mode):
    configs = str(data_dir.parent.parent / "configs")
    out = {}
    for name, source in (("video", kitti_video / "kitti.avi"), ("directory", kitti_video / "frames")):
        out[name] = kitti_video / f"{name}_{len(mode)}.txt"
        rc = cli_main(["-c", configs, "-v", str(source), "-o", str(out[name]), "--device", "cpu",
                       "--batch-size", "3", *mode])
        assert rc == 0
    rows = np.loadtxt(out["video"])
    assert rows.shape == (6, 12) and np.isfinite(rows).all()
    assert out["video"].read_bytes() == out["directory"].read_bytes()
