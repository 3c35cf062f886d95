"""The two drawing calls of ``sleap-render``, as OpenCV draws them, bit for
bit, on uint8 frames on the host: ``cv2.line(img, p1, p2, color,
thickness)`` and ``cv2.circle(img, center, radius, color, -1)``, both
LINE_8 with shift 0 (``modules/imgproc/src/drawing.cpp``).

- :func:`line`, thickness 1: OpenCV's ``Line``, a ``LineIterator`` of
  8-connectivity walked left to right, on the segment clipped to the frame
  by ``clipLine``.
- :func:`line`, thickness above 1: the segment clipped by ``clipLine`` to
  the frame grown by the thickness on each side, then ``ThickLine``. The
  end points go to
  16.16 fixed point (``XY_SHIFT`` 16); the offset across the line is
  ``dp = cvRound(d * r)`` with ``r = (thickness << 15 + odd * XY_ONE / 2) /
  |d|``; the four-point polygon is drawn by ``FillConvexPoly`` (its edges
  by ``Line2``, the scanlines between the edges stepped in fixed point);
  each end gets a round cap, ``Circle`` of radius ``(thickness << 15 +
  XY_ONE / 2) >> XY_SHIFT``.
- :func:`circle`: ``Circle`` with ``fill``: horizontal spans of the
  midpoint circle, clipped to the frame.

``cvRound`` rounds half to even, as Python's :func:`round` does. Shapes
partly or wholly outside the frame are clipped as OpenCV clips them. The
frame is drawn on in place and returned. No TPU kernel draws: the JAX
package draws with cv2 on the host (``sleap_tpu/io/visuals.py``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
MAX_THICKNESS = 32767


def _check(img: np.ndarray) -> None:
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("draw takes a uint8 (H, W) or (H, W, C) numpy frame.")


def _color(img: np.ndarray, color: Sequence[float]) -> np.ndarray:
    """``scalarToRawData``: the first C entries of the colour, saturated to
    uint8 (cvRound, then clamped)."""
    channels = 1 if img.ndim == 2 else img.shape[2]
    vals = list(color) + [0] * max(0, channels - len(color))
    out = np.array([min(max(round(v), 0), 255) for v in vals[:channels]], np.uint8)
    return out[0] if img.ndim == 2 else out


def _hline(img: np.ndarray, y: int, x1: int, x2: int, c: np.ndarray) -> None:
    """``ICV_HLINE``: pixels x1..x2 of row y."""
    img[y, x1:x2 + 1] = c


def _trunc_div(a: float, b: float) -> int:
    """``(int64)(double)a / b``: C's truncation toward zero."""
    return int(a / b)


def clip_line(width: int, height: int, p1: Tuple[int, int], p2: Tuple[int, int]):
    """OpenCV's ``clipLine`` on a (width, height) frame: the clipped end
    points, or None where the segment misses the frame."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _trunc_div(float(a - y1) * (x2 - x1), float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _trunc_div(float(a - y2) * (x2 - x1), float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _trunc_div(float(a - x1) * (y2 - y1), float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _trunc_div(float(a - x2) * (y2 - y1), float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], c: np.ndarray) -> None:
    """OpenCV's ``Line``: a ``LineIterator`` (8-connected, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:  # walked left to right
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = c
        step = err < 0
        err += minus_delta + (plus_delta if step else 0)
        if vert:  # the minor step is along x, the major along y
            y += sy
            if step:
                x += sx
        else:
            x += sx
            if step:
                y += sy


def _line2(img: np.ndarray, p1, p2, c: np.ndarray) -> None:
    """OpenCV's ``Line2``: a segment between 16.16 fixed-point end points,
    one pixel a step along its major axis."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _c_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _c_div(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = c

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            ecount -= 1


def _c_div(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_convex_poly(img: np.ndarray, v, c: np.ndarray, shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` for LINE_8: the outline by ``Line2``,
    then each scanline between the left and right edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    delta1 = delta2 = XY_ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    for k, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, k
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        _line2(img, p0, p, c)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _c_div((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1  # the C loop's post-decrement when it runs out
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> XY_SHIFT
            xx2 = (edge[right]["x"] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), c)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle(img: np.ndarray, center: Tuple[int, int], radius: int, c: np.ndarray) -> None:
    """OpenCV's ``Circle`` with ``fill``: the midpoint circle's spans."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            _hline(img, y11, x11, x12, c)
            _hline(img, y12, x11, x12, c)
            _hline(img, y21, x21, x22, c)
            _hline(img, y22, x21, x22, c)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                _hline(img, y11, x11, x12, c)
            if 0 <= y12 < h:
                _hline(img, y12, x11, x12, c)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    _hline(img, y21, x21, x22, c)
                if 0 <= y22 < h:
                    _hline(img, y22, x21, x22, c)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, p1, p2, color, thickness)`` (LINE_8, shift 0), in
    place; integer end points."""
    _check(img)
    if not 0 < thickness <= MAX_THICKNESS:
        raise ValueError(f"line thickness must be 1..{MAX_THICKNESS}, not {thickness}.")
    c = _color(img, color)
    p1 = (int(p1[0]), int(p1[1]))
    p2 = (int(p2[0]), int(p2[1]))
    if thickness <= 1:
        _line8(img, p1, p2, c)
        return img
    # The segment is first clipped to the frame grown by the thickness on
    # every side, in whole pixels.
    h, w = img.shape[:2]
    t = thickness
    clipped = clip_line(w + 2 * t, h + 2 * t, (p1[0] + t, p1[1] + t), (p2[0] + t, p2[1] + t))
    if clipped is None:
        return img
    p1, p2 = ((x - t, y - t) for x, y in clipped)
    q0 = (p1[0] << XY_SHIFT, p1[1] << XY_SHIFT)
    q1 = (p2[0] << XY_SHIFT, p2[1] << XY_SHIFT)
    dx = (q0[0] - q1[0]) / XY_ONE
    dy = (q1[1] - q0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        pts = [(q0[0] + dpx, q0[1] + dpy), (q0[0] - dpx, q0[1] - dpy),
               (q1[0] - dpx, q1[1] - dpy), (q1[0] + dpx, q1[1] + dpy)]
        _fill_convex_poly(img, pts, c, XY_SHIFT)
    radius = (thick + (XY_ONE >> 1)) >> XY_SHIFT
    for q in (q0, q1):
        _circle(img, ((q[0] + (XY_ONE >> 1)) >> XY_SHIFT, (q[1] + (XY_ONE >> 1)) >> XY_SHIFT), radius, c)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = -1) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (filled, LINE_8, shift
    0), in place."""
    _check(img)
    if thickness >= 0:
        raise NotImplementedError("circle draws filled circles (thickness -1), as sleap-render does.")
    if radius < 0:
        raise ValueError(f"circle radius must be >= 0, not {radius}.")
    _circle(img, (int(center[0]), int(center[1])), int(radius), _color(img, color))
    return img
