"""Debug visualisation: keypoints, matches, depth-coloured matches, trajectory — without OpenCV or matplotlib.

Port of ``tpuslam/post/visualizer.py``.  ``draw_keypoints``,
``draw_matches`` and ``draw_depth_matches`` return the reference's uint8
BGR arrays pixel for pixel: they draw with OpenCV's integer routines
re-implemented in numpy — ``cv::circle`` at thickness 1 or filled with
``LINE_8`` and no shift, which is ``drawing.cpp``'s midpoint ``Circle``, and
``cv::line`` at thickness 1 with ``LINE_8``, which is ``clipLine`` and then
the 8-connected ``LineIterator`` walked left to right — with the
coordinates truncated by ``int()``, ``draw_matches``' colours drawn from
``np.random.default_rng(0).integers(64, 255, 3)`` in the same order and
``draw_depth_matches``' percentile scaling.  They take the port's
``KeypointSet`` / ``MatchSet`` on any device, or numpy arrays, and write a
PNG through ``post/png.py`` when given a ``.png`` path.

``plot_trajectory`` draws the top-down (x, z) path in blue, and the ground
truth dashed in black, at equal aspect on a grid, with ticks chosen by
matplotlib's ``MaxNLocator`` rule (steps 1, 2, 2.5, 5, 10) and labels in a
5x7 bitmap font kept here; its pixels are its own, not matplotlib's.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from tpuslam_torch.post.png import write_png

# --- OpenCV's integer drawing ----------------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _to_bgr(gray) -> np.ndarray:
    g = np.asarray(gray, np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def circle(img: np.ndarray, center: tuple[int, int], radius: int, color, fill: bool = False) -> None:
    """``cv::circle(img, center, radius, color, fill ? -1 : 1, LINE_8)``: the midpoint circle, clipped."""
    h, w = img.shape[:2]
    cx, cy = center
    color = np.asarray(color, np.uint8)
    dx, dy, err, plus, minus = radius, 0, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, x0, x1 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if not 0 <= y < h:
                continue
            if fill:
                lo, hi = max(x0, 0), min(x1, w - 1)
                if lo <= hi:
                    img[y, lo : hi + 1] = color
            else:
                for x in (x0, x1):
                    if 0 <= x < w:
                        img[y, x] = color
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1  # -1 when err > 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def clip_line(size: tuple[int, int], p1: tuple[int, int], p2: tuple[int, int]):
    """``cv::clipLine(Size(w, h), p1, p2)`` → (inside, p1, p2), with its integer arithmetic."""
    w, h = size
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))  # x1 as clipped above, as OpenCV has it
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(size: tuple[int, int], p1: tuple[int, int], p2: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of ``cv::line(..., 1, LINE_8)`` from p1 to p2 on an image of ``size`` (w, h).

    ``LineIterator(img, p1, p2, 8, leftToRight=true)``: the ends clipped to
    the image, the walk started at the left end; each step moves one pixel
    along the major axis (x on ties) and one along the minor where the error
    term was negative, which after k steps makes ceil((2·minor·k − major) /
    (2·major)) minor moves.
    """
    w, h = size
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = clip_line(size, p1, p2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if p2[0] < p1[0]:
        p1, p2 = p2, p1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else np.zeros(1, np.int64)
    if dy > dx:
        return p1[0] + m, p1[1] + sy * k
    return p1[0] + k, p1[1] + sy * m


def line(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int], color) -> None:
    """``cv::line(img, p1, p2, color, 1, LINE_8)``."""
    xs, ys = line_pixels((img.shape[1], img.shape[0]), p1, p2)
    img[ys, xs] = np.asarray(color, np.uint8)


def _write(img: np.ndarray, path) -> None:
    if path is not None:
        write_png(path, img)


def draw_keypoints(image: np.ndarray, kps, path: str | Path | None = None) -> np.ndarray:
    """Render keypoints as green circles (cv::drawKeypoints analog)."""
    img = _to_bgr(image)
    xy, valid = _host(kps.xy), _host(kps.valid).astype(bool)
    for x, y in xy[valid]:
        circle(img, (int(x), int(y)), 3, (0, 255, 0))
    _write(img, path)
    return img


def draw_matches(image1: np.ndarray, kps1, image2: np.ndarray, kps2, matches,
                 path: str | Path | None = None) -> np.ndarray:
    """Side-by-side match rendering (cv::drawMatches analog)."""
    img1, img2 = _to_bgr(image1), _to_bgr(image2)
    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1], 3), np.uint8)
    canvas[: img1.shape[0], :w1] = img1
    canvas[: img2.shape[0], w1:] = img2
    xy1, xy2 = _host(kps1.xy), _host(kps2.xy)
    rng = np.random.default_rng(0)
    for q, t, v in zip(_host(matches.query_idx), _host(matches.train_idx), _host(matches.valid)):
        if not v:
            continue
        p1 = tuple(int(c) for c in xy1[q])
        p2 = (int(xy2[t][0]) + w1, int(xy2[t][1]))
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        circle(canvas, p1, 3, color)
        circle(canvas, p2, 3, color)
        line(canvas, p1, p2, color)
    _write(canvas, path)
    return canvas


def draw_depth_matches(image: np.ndarray, pts: np.ndarray, depths: np.ndarray, valid: np.ndarray | None = None,
                       path: str | Path | None = None) -> np.ndarray:
    """Depth-coloured keypoint rendering (near=red → far=blue), filled circles of radius 4."""
    img = _to_bgr(image)
    pts, depths = _host(pts), _host(depths)
    if valid is None:
        valid = np.ones(len(pts), bool)
    valid = _host(valid) & np.isfinite(depths) & (depths > 0)
    if valid.any():
        d = depths[valid]
        lo, hi = np.percentile(d, 5), np.percentile(d, 95)
        for (x, y), z in zip(pts[valid], d):
            a = float(np.clip((z - lo) / max(hi - lo, 1e-9), 0, 1))
            color = (int(255 * a), 0, int(255 * (1 - a)))  # BGR: near red → far blue
            circle(img, (int(x), int(y)), 4, color, fill=True)
    _write(img, path)
    return img


# --- the trajectory plot ---------------------------------------------------------------------------------------

# 5x7 glyphs: seven rows, each a byte whose low five bits are the columns, most significant on the left.
_FONT = {
    "0": "0e11131519110e", "1": "040c040404040e", "2": "0e11010204081f", "3": "1f02040201110e",
    "4": "02060a121f0202", "5": "1f101e0101110e", "6": "0608101e11110e", "7": "1f010204080808",
    "8": "0e11110e11110e", "9": "0e11110f01020c", "-": "0000001f000000", ".": "00000000000c0c",
    " ": "00000000000000", "[": "0e08080808080e", "]": "0e02020202020e", "x": "0000110a040a11",
    "z": "00001f0204081f", "m": "00001a15151111", "e": "00000e111f100e", "s": "00000e100e011e",
    "t": "08081c08080906", "i": "04000c0404040e", "a": "00000e010f110f", "g": "00000f110f010e",
    "r": "00001619101010", "o": "00000e1111110e", "u": "0000111111130d", "n": "00001619111111",
    "d": "01010d1311110f", "h": "10101619111111",
}
GLYPH_SCALE = 2  # each font pixel is 2x2 image pixels
SIZE = 720  # the plot is SIZE x SIZE pixels
LEFT, RIGHT, TOP, BOTTOM = 96, 24, 56, 72  # margins around the square data box
NBINS = 8  # MaxNLocator's nbins
STEPS = (1.0, 2.0, 2.5, 5.0, 10.0)
BLUE, BLACK, GRID, WHITE = (255, 0, 0), (0, 0, 0), (222, 222, 222), (255, 255, 255)  # BGR
DASH = (8, 5)  # ground truth: pixels on, pixels off along the path


def text_mask(text: str) -> np.ndarray:
    """The bitmap of ``text`` (bool, 7·scale rows), one blank column between glyphs."""
    cols = []
    for ch in text:
        rows = bytes.fromhex(_FONT[ch])
        glyph = np.array([[(r >> (4 - c)) & 1 for c in range(5)] for r in rows], bool)
        cols += [glyph, np.zeros((7, 1), bool)]
    mask = np.hstack(cols[:-1]) if cols else np.zeros((7, 0), bool)
    return np.kron(mask, np.ones((GLYPH_SCALE, GLYPH_SCALE), bool))


def _blit(img: np.ndarray, mask: np.ndarray, x: int, y: int, color) -> None:
    """Paint ``mask``'s set pixels with its top-left corner at (x, y), clipped to the image."""
    h, w = img.shape[:2]
    ys, xs = np.nonzero(mask)
    ys, xs = ys + y, xs + x
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img[ys[keep], xs[keep]] = np.asarray(color, np.uint8)


def _nonsingular(vmin: float, vmax: float) -> tuple[float, float]:
    """matplotlib's ``transforms.nonsingular`` with ``tick_values``' expander and tiny."""
    expander, tiny = 1e-13, 1e-14
    if not (np.isfinite(vmin) and np.isfinite(vmax)):
        return -expander, expander
    if vmax < vmin:
        vmin, vmax = vmax, vmin
    vmin, vmax = float(vmin), float(vmax)
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        return vmin - expander * abs(vmin), vmax + expander * abs(vmax)
    return vmin, vmax


def tick_values(vmin: float, vmax: float, nbins: int = NBINS) -> np.ndarray:
    """The ticks of matplotlib's ``MaxNLocator(nbins, steps=[1, 2, 2.5, 5, 10]).tick_values(vmin, vmax)``.

    The smallest step of the extended staircase that is at least (vmax −
    vmin) / nbins, scaled by the power of ten below it, or a smaller one
    while fewer than two ticks would fall in the range; the ticks run from
    the multiple of the step at or below vmin to the one at or above vmax,
    with matplotlib's tolerance for a range far from zero.
    """
    vmin, vmax = _nonsingular(vmin, vmax)
    dv = abs(vmax - vmin)
    meanv = (vmax + vmin) / 2
    offset = 0.0 if abs(meanv) / dv < 100 else math.copysign(10 ** (math.log10(abs(meanv)) // 1), meanv)
    scale = 10 ** (math.log10(dv / nbins) // 1)
    _vmin, _vmax = vmin - offset, vmax - offset
    base = np.asarray(STEPS)
    steps = np.concatenate([0.1 * base[:-1], base, [10 * base[1]]]) * scale
    large = np.nonzero(steps >= (_vmax - _vmin) / nbins)[0]
    istep = large[0] if len(large) else len(steps) - 1
    for step in steps[: istep + 1][::-1]:
        best_vmin = (_vmin // step) * step
        # matplotlib's _Edge_integer: more slop when the offset is large against the step
        tol = min(0.4999, max(1e-10, 10 ** (np.log10(abs(offset) / step) - 12))) if offset else 1e-10
        d, m = divmod(_vmin - best_vmin, step)
        low = d + 1 if abs(m / step - 1) < tol else d
        d, m = divmod(_vmax - best_vmin, step)
        high = d if abs(m / step) < tol else d + 1
        ticks = np.arange(low, high + 1) * step + best_vmin
        if ((ticks <= _vmax) & (ticks >= _vmin)).sum() >= 2:
            break
    return ticks + offset


def _label(v: float, step: float) -> str:
    """A tick's label: as many decimals as the step needs, and no negative zero."""
    decimals = next(d for d in range(12) if abs(round(step, d) - step) <= 1e-9 * step)
    text = f"{v:.{decimals}f}"
    return text[1:] if text.startswith("-") and float(text) == 0 else text


class TrajectoryLayout:
    """Where a plot of (x, z) points puts each metre: one scale for both axes (equal aspect), the data box
    SIZE − margins square, the limits padded by 5% and the shorter range widened to fill the box."""

    def __init__(self, xz: np.ndarray):
        lo, hi = xz.min(axis=0), xz.max(axis=0)
        span = float(max(hi[0] - lo[0], hi[1] - lo[1]))
        span = span * 1.1 if span > 0 else 1.0
        mid = (lo + hi) / 2
        self.box = SIZE - LEFT - RIGHT  # == SIZE - TOP - BOTTOM
        self.xlim = (float(mid[0] - span / 2), float(mid[0] + span / 2))
        self.zlim = (float(mid[1] - span / 2), float(mid[1] + span / 2))
        self.pixels_per_metre = (self.box - 1) / span

    def to_pixel(self, x, z) -> tuple[np.ndarray, np.ndarray]:
        """(columns, rows) of points: x to the right, z up."""
        s = self.pixels_per_metre
        col = LEFT + np.floor((np.asarray(x, np.float64) - self.xlim[0]) * s + 0.5).astype(np.int64)
        row = TOP + np.floor((self.zlim[1] - np.asarray(z, np.float64)) * s + 0.5).astype(np.int64)
        return col, row


def _polyline(img: np.ndarray, cols: np.ndarray, rows: np.ndarray, color, dash=None, width: int = 2) -> None:
    """Segments through the points, ``width`` pixels thick (offsets right and down); dashed when ``dash``."""
    size = (img.shape[1], img.shape[0])
    xs, ys = [], []
    for i in range(len(cols)):
        p1 = (int(cols[i]), int(rows[i]))
        p2 = (int(cols[i + 1]), int(rows[i + 1])) if i + 1 < len(cols) else p1
        x, y = line_pixels(size, p1, p2)
        if p2[0] < p1[0]:  # walked from p2: keep the path's direction for the dashes
            x, y = x[::-1], y[::-1]
        xs.append(x)
        ys.append(y)
    x, y = np.concatenate(xs), np.concatenate(ys)
    if dash is not None:
        on = (np.arange(len(x)) % sum(dash)) < dash[0]
        x, y = x[on], y[on]
    color = np.asarray(color, np.uint8)
    for ox in range(width):
        for oy in range(width):
            keep = (x + ox < size[0]) & (y + oy < size[1])
            img[y[keep] + oy, x[keep] + ox] = color


def render_trajectory(poses: np.ndarray, gt_poses: np.ndarray | None = None) -> tuple[np.ndarray, TrajectoryLayout]:
    """The plot of ``plot_trajectory`` as a (SIZE, SIZE, 3) BGR array, and its layout."""
    poses = np.asarray(poses, np.float64)
    est = poses[:, [0, 2], 3]
    gt = None if gt_poses is None else np.asarray(gt_poses, np.float64)[:, [0, 2], 3]
    layout = TrajectoryLayout(est if gt is None else np.vstack([est, gt]))
    img = np.full((SIZE, SIZE, 3), WHITE, np.uint8)
    box0, box1 = (LEFT, TOP), (LEFT + layout.box - 1, TOP + layout.box - 1)
    for axis, (lim, name) in enumerate(((layout.xlim, "x [m]"), (layout.zlim, "z [m]"))):
        ticks = tick_values(*lim)
        step = float(ticks[1] - ticks[0]) if len(ticks) > 1 else 1.0
        for v in ticks[(ticks >= lim[0]) & (ticks <= lim[1])]:
            label = text_mask(_label(float(v), step))
            if axis == 0:
                c = int(layout.to_pixel(v, lim[0])[0])
                line(img, (c, box0[1]), (c, box1[1]), GRID)
                line(img, (c, box1[1]), (c, box1[1] + 5), BLACK)
                _blit(img, label, c - label.shape[1] // 2, box1[1] + 10, BLACK)
            else:
                r = int(layout.to_pixel(layout.xlim[0], v)[1])
                line(img, (box0[0], r), (box1[0], r), GRID)
                line(img, (box0[0] - 5, r), (box0[0], r), BLACK)
                _blit(img, label, box0[0] - 10 - label.shape[1], r - label.shape[0] // 2, BLACK)
        title = text_mask(name)
        if axis == 0:
            _blit(img, title, (box0[0] + box1[0]) // 2 - title.shape[1] // 2, box1[1] + 36, BLACK)
        else:
            title = np.rot90(title)
            _blit(img, title, 12, (box0[1] + box1[1]) // 2 - title.shape[0] // 2, BLACK)
    for a, b in (((box0[0], box0[1]), (box1[0], box0[1])), ((box0[0], box1[1]), (box1[0], box1[1])),
                 ((box0[0], box0[1]), (box0[0], box1[1])), ((box1[0], box0[1]), (box1[0], box1[1]))):
        line(img, a, b, BLACK)
    if gt is not None:
        _polyline(img, *layout.to_pixel(gt[:, 0], gt[:, 1]), BLACK, dash=DASH)
    _polyline(img, *layout.to_pixel(est[:, 0], est[:, 1]), BLUE)
    # the legend, above the box: a swatch of each line and its name
    x = LEFT
    for name, color, dash in (("estimate", BLUE, None), ("ground truth", BLACK, DASH)):
        if name == "ground truth" and gt is None:
            continue
        y = TOP // 2
        _polyline(img, np.array([x, x + 30]), np.array([y, y]), color, dash=dash)
        label = text_mask(name)
        _blit(img, label, x + 40, y - label.shape[0] // 2 + 1, BLACK)
        x += 60 + label.shape[1]
    return img, layout


def plot_trajectory(poses: np.ndarray, path: str | Path, gt_poses: np.ndarray | None = None) -> None:
    """Top-down (x, z) trajectory plot as a PNG: the estimate in blue, the ground truth dashed in black."""
    img, _ = render_trajectory(_host(poses), None if gt_poses is None else _host(gt_poses))
    write_png(path, img)
