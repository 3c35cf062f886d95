"""``sleap_tpu_torch.io.draw`` against cv2, bitwise: ``line`` (LINE_8,
thickness 1-3) and filled ``circle`` (radius 0-6) on seeded random BGR
frames, 600 cases of each, with end points and centres spread up to 20 px
past the frame (clipped, or wholly off it), on the border, and with
``p1 == p2``; and the two calls at ``render_frame``'s scale on a 1024^2
frame."""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from sleap_tpu_torch.io import draw

CHUNKS = 10
CASES = 60  # a chunk, for each of line and circle


def _point(rng, h, w):
    return int(rng.integers(-20, w + 20)), int(rng.integers(-20, h + 20))


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_lines_equal_cv2(chunk):
    rng = np.random.default_rng(100 + chunk)
    for k in range(CASES):
        h, w = (int(v) for v in rng.integers(4, 64, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        p1 = _point(rng, h, w)
        p2 = p1 if k % 10 == 0 else _point(rng, h, w)
        if k % 10 == 1:  # along the border
            p1, p2 = (0, int(rng.integers(0, h))), (w - 1, int(rng.integers(0, h)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        thickness = 1 + k % 3
        want = cv2.line(img.copy(), p1, p2, color, thickness)
        got = draw.line(img.copy(), p1, p2, color, thickness)
        assert np.array_equal(got, want), (h, w, p1, p2, thickness)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_filled_circles_equal_cv2(chunk):
    rng = np.random.default_rng(200 + chunk)
    for k in range(CASES):
        h, w = (int(v) for v in rng.integers(4, 64, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        center = _point(rng, h, w)
        if k % 10 == 0:  # on a corner
            center = (w - 1, 0)
        radius = k % 7
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = cv2.circle(img.copy(), center, radius, color, -1)
        got = draw.circle(img.copy(), center, radius, color, -1)
        assert np.array_equal(got, want), (h, w, center, radius)


def test_render_sized_shapes_equal_cv2():
    """Long segments across a 1024^2 frame and its outside, and circles of
    sleap-render's marker size."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    want, got = img.copy(), img.copy()
    for _ in range(40):
        p1 = tuple(int(v) for v in rng.integers(-300, 1324, 2))
        p2 = tuple(int(v) for v in rng.integers(-300, 1324, 2))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.line(want, p1, p2, color, 2)
        draw.line(got, p1, p2, color, 2)
        c = tuple(int(v) for v in rng.integers(-8, 1032, 2))
        cv2.circle(want, c, 4, color, -1)
        draw.circle(got, c, 4, color, -1)
    np.testing.assert_array_equal(got, want)


def test_gray_frames_and_refusals():
    img = np.random.default_rng(1).integers(0, 256, (30, 40), dtype=np.uint8)
    np.testing.assert_array_equal(draw.line(img.copy(), (2, 3), (35, 25), (200,), 2),
                                  cv2.line(img.copy(), (2, 3), (35, 25), 200, 2))
    with pytest.raises(ValueError, match="thickness"):
        draw.line(img.copy(), (0, 0), (1, 1), (1,), 0)
    with pytest.raises(NotImplementedError, match="filled"):
        draw.circle(img.copy(), (5, 5), 2, (1,), 1)
