"""Write the video fixtures under ``tests/data/torch_video/`` (run once; the files are committed).

    python tests/make_torch_video_fixtures.py          # write the fixtures
    python tests/make_torch_video_fixtures.py --bound  # print the bound of the reference's frames

* ``opencv_mjpeg.avi``: 10 frames of 150x90, a window panning across
  ``tests/data/test_images/0.png`` (colour), written by OpenCV's own Motion
  JPEG writer (``cv2.CAP_OPENCV_MJPEG``, fourcc MJPG) at 10 frames/s;
* ``ffmpeg_mjpeg.avi``: the same frames written through FFmpeg
  (``cv2.CAP_FFMPEG``, fourcc MJPG) at 30000/1001 frames/s;
* ``expected_luma.npz``: ``<file>`` → (10, 90, 150) uint8, what the
  reference's committed loader (``native/build/libtpuslam_frameloader.so``,
  libjpeg's gray output) decodes from each frame's JPEG payload, the payload
  written to a file of its own.  A machine without OpenCV and libjpeg holds
  the port's video path to libjpeg with it.

``--bound`` writes the 10 KITTI frames of ``tests/data/images`` (1392x512),
the gray 150x90 crops the video tests write (``kitti_panning_frames``) and
the colour frames of the fixtures with both writers at 10 frames/s into a
temporary directory and prints, for each, how far the reference's frames
(``cv2.VideoCapture``: FFmpeg's decode, BGR, then ``COLOR_BGR2GRAY``) lie
from the JPEG luma the port decodes: the range of the difference and the
shares of pixels that differ, and that differ by more than 2.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DATA = REPO / "tests" / "data"
OUT = DATA / "torch_video"
WRITERS = {"opencv_mjpeg.avi": (cv2.CAP_OPENCV_MJPEG, 10.0), "ffmpeg_mjpeg.avi": (cv2.CAP_FFMPEG, 30000 / 1001)}
SIZE = (150, 90)  # width, height: not a whole number of 16x16 MCUs either way


def panning_frames(n: int = 10) -> list[np.ndarray]:
    """BGR frames: a SIZE window moving 7 pixels right and 3 down a frame across a colour test image."""
    bgr = np.asarray(Image.open(DATA / "test_images" / "0.png").convert("RGB"))[..., ::-1]
    w, h = SIZE
    return [np.ascontiguousarray(bgr[100 + 3 * i : 100 + 3 * i + h, 150 + 7 * i : 150 + 7 * i + w])
            for i in range(n)]


def kitti_panning_frames(n: int = 10) -> list[np.ndarray]:
    """Gray frames as BGR (the monocular camera's frames): a SIZE window panning across KITTI frame 3."""
    gray = np.asarray(Image.open(DATA / "images" / "0000000003.png").convert("L"))
    w, h = SIZE
    return [np.repeat(gray[100 + 3 * i : 100 + 3 * i + h, 300 + 7 * i : 300 + 7 * i + w, None], 3, axis=2)
            for i in range(n)]


def write_video(path: Path, frames: list[np.ndarray], api: int, fps: float) -> Path:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), api, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    assert writer.isOpened(), path
    for f in frames:
        writer.write(f if f.ndim == 3 else cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    writer.release()
    return path


def reference_luma(path: Path) -> np.ndarray:
    """Each frame's JPEG payload decoded by the reference's libjpeg loader → (n, H, W) uint8."""
    from tpuslam.pre.native_loader import NativeFrameLoader
    from tpuslam_torch.pre.avi import open_avi

    video = open_avi(path)
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(video.n_frames):
            (Path(tmp) / f"{i:06d}.jpg").write_bytes(video.payload(i))
        return NativeFrameLoader(tmp).decode_batch(0, video.n_frames)


def reference_frames(path: Path) -> np.ndarray:
    """The reference's frames of a video: ``cv2.VideoCapture``, then ``COLOR_BGR2GRAY``."""
    vc = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = vc.read()
        if not ok:
            return np.stack(out)
        out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))


def print_bound() -> None:
    kitti = [cv2.imread(str(p), cv2.IMREAD_GRAYSCALE) for p in sorted((DATA / "images").glob("*.png"))]
    contents = (("the 1392x512 KITTI frames", kitti, 10.0), ("150x90 KITTI crops", kitti_panning_frames(), 10.0),
                ("150x90 colour crops", panning_frames(), 10.0))
    with tempfile.TemporaryDirectory() as tmp:
        for what, frames, fps in contents:
            for name, (api, _) in WRITERS.items():
                path = write_video(Path(tmp) / name, frames, api, fps)
                diff = reference_frames(path).astype(np.int16) - reference_luma(path)
                print(f"{name}, {what}: reference - luma in [{diff.min()}, {diff.max()}], "
                      f"{100 * (diff != 0).mean():.2f}% of pixels differ ({100 * (diff > 0).mean():.2f}% above, "
                      f"{100 * (diff < 0).mean():.2f}% below), {100 * (np.abs(diff) > 2).mean():.3f}% by more than 2")


def main() -> None:
    if "--bound" in sys.argv[1:]:
        print_bound()
        return
    OUT.mkdir(parents=True, exist_ok=True)
    frames = panning_frames()
    expected = {}
    for name, (api, fps) in WRITERS.items():
        expected[name] = reference_luma(write_video(OUT / name, frames, api, fps))
    np.savez_compressed(OUT / "expected_luma.npz", **expected)


if __name__ == "__main__":
    main()
