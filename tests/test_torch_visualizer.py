"""tpuslam_torch's visualizer against the reference's ``tpuslam/post/visualizer.py``, on the CPU.

``draw_keypoints``, ``draw_matches`` and ``draw_depth_matches`` return the
reference's arrays (drawn by OpenCV) pixel for pixel on synthetic inputs:
circles clipped at all four borders and past them, duplicate points, empty
sets, matches whose lines leave the canvas, a second image of another
height, non-finite and negative depths.  The port's ``circle`` and ``line``
equal ``cv2.circle`` / ``cv2.line`` on random shapes, and its tick rule
equals ``matplotlib.ticker.MaxNLocator`` on random ranges.  The PNGs it
writes read back through ``cv2.imread`` as the arrays and through the
port's loader.  ``plot_trajectory``: every pose's (x, z) lands on a blue
pixel, one metre spans the same pixels on both axes, the ground truth is
drawn when given.  ``--plot`` writes a file in the CLI's three modes and in
``evaluate``, and the drawing runs where neither OpenCV nor matplotlib can
be imported.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import matplotlib.ticker as mticker
import numpy as np
import pytest
import torch

from test_torch_ba import one_torch_thread  # noqa: F401 (autouse: the port on one thread)
from tpuslam.post import visualizer as ref
from tpuslam_torch.cli import main as cli_main
from tpuslam_torch.evaluate import main as evaluate_main
from tpuslam_torch.frontend.fast import KeypointSet
from tpuslam_torch.frontend.matcher import MatchSet
from tpuslam_torch.post import visualizer as port
from tpuslam_torch.pre.native_loader import NativeFrameLoader

REPO = Path(__file__).resolve().parent.parent
H, W = 60, 80


def keypoints(xy, valid=None):
    """The same keypoints as the port's KeypointSet (torch) and as numpy fields for the reference."""
    xy = np.asarray(xy, np.float32)
    valid = np.ones(len(xy), bool) if valid is None else np.asarray(valid, bool)
    n = len(xy)
    tk = KeypointSet(torch.from_numpy(xy), torch.zeros(n), torch.zeros(n), torch.from_numpy(valid))
    return tk, SimpleNamespace(xy=xy, valid=valid)


def border_points(rng, w=W, h=H):
    """Points on and past each border, inside, duplicated and at fractional coordinates below zero."""
    edges = [(0, 30), (w - 1, 20), (40, 0), (50, h - 1), (-2.7, 10), (w + 1.5, 30), (30, -0.6), (20, h + 2.2),
             (1, 1), (w - 2, h - 2), (-3.9, -3.9), (w + 3, h + 3), (33.3, 33.3), (33.3, 33.3)]
    return np.vstack([edges, rng.uniform([-5, -5], [w + 5, h + 5], (40, 2))])


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (H, W), dtype=np.uint8), rng.integers(0, 256, (H - 14, W - 20), dtype=np.uint8)


def test_circle_and_line_equal_opencv():
    rng = np.random.default_rng(0)
    for trial in range(600):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        color = tuple(int(c) for c in rng.integers(1, 256, 3))
        if trial % 3 == 0:
            p1, p2 = (tuple(int(v) for v in rng.integers(-60, 100, 2)) for _ in range(2))
            cv2.line(a, p1, p2, color, 1)
            port.line(b, p1, p2, color)
        else:
            c, r = tuple(int(v) for v in rng.integers(-15, 55, 2)), int(rng.integers(0, 15))
            cv2.circle(a, c, r, color, -1 if trial % 3 == 2 else 1)
            port.circle(b, c, r, color, fill=trial % 3 == 2)
        assert np.array_equal(a, b), trial


@pytest.mark.parametrize("valid", ["all", "some", "none"])
def test_draw_keypoints_equals_reference(images, valid, tmp_path):
    rng = np.random.default_rng(1)
    xy = border_points(rng)
    mask = {"all": np.ones(len(xy), bool), "some": rng.random(len(xy)) < 0.6, "none": np.zeros(len(xy), bool)}[valid]
    tk, rk = keypoints(xy, mask)
    want = ref.draw_keypoints(images[0], rk)
    got = port.draw_keypoints(images[0], tk, tmp_path / "k.png")
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(port.draw_keypoints(images[0], rk), want)  # numpy fields too
    assert np.array_equal(cv2.imread(str(tmp_path / "k.png"), cv2.IMREAD_COLOR), want)


@pytest.mark.parametrize("second", ["same", "smaller"])
def test_draw_matches_equals_reference(images, second, tmp_path):
    rng = np.random.default_rng(2)
    img2 = images[0] if second == "same" else images[1]
    xy1 = border_points(rng)
    xy2 = border_points(rng, img2.shape[1], img2.shape[0])[::-1].copy()
    n = 30
    q, t = rng.integers(0, len(xy1), n), rng.integers(0, len(xy2), n)
    v = rng.random(n) < 0.8
    v[:2] = False
    tk1, rk1 = keypoints(xy1)
    tk2, rk2 = keypoints(xy2)
    tm = MatchSet(torch.from_numpy(q), torch.from_numpy(t), torch.zeros(n), torch.from_numpy(v))
    want = ref.draw_matches(images[0], rk1, img2, rk2, SimpleNamespace(query_idx=q, train_idx=t, valid=v))
    got = port.draw_matches(images[0], tk1, img2, tk2, tm, tmp_path / "m.png")
    assert got.shape == (H, W + img2.shape[1], 3) and np.array_equal(got, want)
    assert np.array_equal(cv2.imread(str(tmp_path / "m.png"), cv2.IMREAD_COLOR), want)
    empty = MatchSet(*(x[:0] for x in tm))
    assert np.array_equal(port.draw_matches(images[0], tk1, img2, tk2, empty),
                          ref.draw_matches(images[0], rk1, img2, rk2, SimpleNamespace(query_idx=q[:0],
                                                                                        train_idx=t[:0], valid=v[:0])))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_draw_depth_matches_equals_reference(images, dtype, tmp_path):
    rng = np.random.default_rng(4)
    pts = border_points(rng)
    depths = rng.uniform(2, 50, len(pts)).astype(dtype)
    depths[[3, 7]] = np.nan
    depths[5] = -1.0
    valid = rng.random(len(pts)) < 0.9
    for kw in ({}, {"valid": valid}):
        want = ref.draw_depth_matches(images[0], pts, depths, **kw)
        got = port.draw_depth_matches(images[0], torch.from_numpy(pts), torch.from_numpy(depths), path=tmp_path / "d.png",
                                      **{k: torch.from_numpy(x) for k, x in kw.items()})
        assert np.array_equal(got, want)
        assert np.array_equal(cv2.imread(str(tmp_path / "d.png"), cv2.IMREAD_COLOR), want)
    none = np.zeros(len(pts), bool)
    assert np.array_equal(port.draw_depth_matches(images[0], pts, depths, none),
                          ref.draw_depth_matches(images[0], pts, depths, none))
    with pytest.raises(ValueError, match="PNG"):
        port.draw_depth_matches(images[0], pts, depths, path=tmp_path / "d.jpg")


def test_tick_values_equal_maxnlocator():
    rng = np.random.default_rng(5)
    loc = mticker.MaxNLocator(nbins=port.NBINS, steps=list(port.STEPS))
    for trial in range(2000):
        c = rng.normal() * 10.0 ** rng.integers(-3, 6)
        span = abs(rng.normal()) * 10.0 ** rng.integers(-6, 5)
        lo, hi = c - span, c + span * rng.uniform(0, 2)
        if trial % 100 == 0:
            hi = lo
        want = loc.tick_values(lo, hi)
        got = port.tick_values(lo, hi)
        assert got.shape == want.shape and np.array_equal(got, want), (lo, hi)


def trajectory(n=40, seed=6):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, 0, 3] = np.cumsum(rng.normal(0.3, 0.2, n))
    poses[:, 2, 3] = np.cumsum(rng.normal(1.0, 0.3, n))
    return poses


def blue_and_black(img):
    blue = np.all(img == port.BLUE, axis=-1)
    black = np.all(img == port.BLACK, axis=-1)
    return blue, black


@pytest.mark.parametrize("with_gt", [False, True])
def test_plot_trajectory(tmp_path, with_gt):
    poses = trajectory()
    gt = trajectory(seed=7) if with_gt else None
    img, layout = port.render_trajectory(poses, gt)
    blue, black = blue_and_black(img)
    cols, rows = layout.to_pixel(poses[:, 0, 3], poses[:, 2, 3])
    assert blue[rows, cols].all()  # every pose on the drawn path
    for lim in (layout.xlim, layout.zlim):  # the ticks are MaxNLocator's on the shown range
        want = mticker.MaxNLocator(nbins=port.NBINS, steps=list(port.STEPS)).tick_values(*lim)
        assert np.array_equal(port.tick_values(*lim), want)
    # equal aspect: one metre spans the same pixels along x and along z
    x0, z0 = layout.xlim[0] + 1.0, layout.zlim[0] + 1.0
    dx = np.diff(layout.to_pixel(np.array([x0, x0 + 1.0]), np.array([z0, z0]))[0])[0]
    dz = -np.diff(layout.to_pixel(np.array([x0, x0]), np.array([z0, z0 + 1.0]))[1])[0]
    assert abs(dx - dz) <= 1 and abs(dx - layout.pixels_per_metre) <= 1
    assert layout.xlim[1] - layout.xlim[0] == pytest.approx(layout.zlim[1] - layout.zlim[0])
    inner = (slice(port.TOP + 1, port.TOP + layout.box - 1), slice(port.LEFT + 1, port.LEFT + layout.box - 1))
    assert (black[inner].sum() > 100) == with_gt  # the dashed ground truth, drawn only when given
    if with_gt:
        gc, gr = layout.to_pixel(gt[:, 0, 3], gt[:, 2, 3])
        assert ((gc >= port.LEFT) & (gc < port.LEFT + layout.box) & (gr >= port.TOP) & (gr < port.TOP + layout.box)).all()
    out = tmp_path / "traj.png"
    port.plot_trajectory(torch.from_numpy(poses), out, gt_poses=gt)
    assert np.array_equal(cv2.imread(str(out), cv2.IMREAD_COLOR), img)
    decoded = NativeFrameLoader(tmp_path).decode_batch(0, 1)[0]  # the port's loader: RGB → its gray
    rgb = img[..., ::-1].astype(np.int64)
    assert decoded.shape == (port.SIZE, port.SIZE)
    assert np.array_equal(decoded, (4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2] + 8192) >> 14)


def test_plot_single_pose_and_still_trajectory(tmp_path):
    """A run of one pose, or of poses that never move, still plots (the range widened to a metre)."""
    for poses in (np.eye(4)[None], np.tile(np.eye(4), (5, 1, 1))):
        img, layout = port.render_trajectory(poses)
        c, r = layout.to_pixel(poses[:, 0, 3], poses[:, 2, 3])
        assert blue_and_black(img)[0][r, c].all() and layout.xlim[1] - layout.xlim[0] == 1.0


def test_plot_flag_in_every_cli_mode(tmp_path, data_dir):
    """``--plot`` writes a PNG in the main, time-sharded and localization modes and in evaluate."""
    base = ["-c", str(REPO / "configs"), "-v", str(data_dir / "images"), "--device", "cpu", "--batch-size", "2",
            "--max-frames", "2"]
    runs = {"main": ["--tracking", "pnp", "--slam", "--save-state", str(tmp_path / "s.npz")],
            "timeshard": ["--timeshard", "2"], "localize": ["--localize", str(tmp_path / "s.npz")]}
    for mode, extra in runs.items():
        assert cli_main([*base, "-o", str(tmp_path / f"{mode}.txt"), "--plot", str(tmp_path / f"{mode}.png"),
                         *extra]) == 0
    assert evaluate_main([str(tmp_path / "main.txt"), str(tmp_path / "localize.txt"), "--plot",
                          str(tmp_path / "eval.png")]) == 0
    for name in ("main", "timeshard", "localize", "eval"):
        img = cv2.imread(str(tmp_path / f"{name}.png"), cv2.IMREAD_COLOR)
        assert img.shape == (port.SIZE, port.SIZE, 3) and blue_and_black(img)[0].any()
    with pytest.raises(SystemExit):  # a plot the port cannot write is refused before the run
        cli_main([*base, "-o", str(tmp_path / "x.txt"), "--plot", str(tmp_path / "x.jpg")])


def test_drawing_needs_neither_opencv_nor_matplotlib(tmp_path):
    """The visualizer, the PNG writer and every tpuslam_torch module import and draw with cv2 and
    matplotlib unimportable."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('cv2', 'matplotlib', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, tpuslam_torch\n"
        "for m in pkgutil.walk_packages(tpuslam_torch.__path__, 'tpuslam_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from types import SimpleNamespace\n"
        "from tpuslam_torch.post import visualizer as v\n"
        "img = np.zeros((20, 30), np.uint8)\n"
        "k = SimpleNamespace(xy=np.array([[3.0, 4.0], [10.5, 12.0]], np.float32), valid=np.array([True, True]))\n"
        "m = SimpleNamespace(query_idx=np.array([0]), train_idx=np.array([1]), valid=np.array([True]))\n"
        f"v.draw_keypoints(img, k, {str(tmp_path / 'k.png')!r})\n"
        "v.draw_matches(img, k, img, k, m)\n"
        "poses = np.tile(np.eye(4), (3, 1, 1)); poses[:, 2, 3] = [0, 1, 2]\n"
        f"v.plot_trajectory(poses, {str(tmp_path / 'p.png')!r}, gt_poses=poses)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok" and (tmp_path / "p.png").is_file() and (tmp_path / "k.png").is_file()
