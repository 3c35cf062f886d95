"""The port's uint8 bilinear resize against ``cv2.resize`` (``INTER_LINEAR``),
and the size matching built on it against the JAX package's, which calls cv2.

Tolerance: none. ``resize_linear_uint8`` must equal ``cv2.resize`` bit for
bit over a hypothesis sweep of up- and down-scales, exact halvings and
doublings, 1 and 3 channels, 2-D frames and widths below 8.
``size_match_image`` and ``resize_and_pad_example`` must give JAX's image and
scale exactly, with ``cv2`` blocked on the port's side.
"""

from __future__ import annotations

import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu.data import providers as jproviders
from sleap_tpu.training import trainer as jtrainer
from sleap_tpu_torch.data import providers as tproviders
from sleap_tpu_torch.data.resizing import resize_linear_uint8
from sleap_tpu_torch.training import trainer as ttrainer


def _frame(seed: int, h: int, w: int, channels: int) -> np.ndarray:
    """Random uint8 pixels, with saturated runs so that clamping shows."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 0 else (h, w, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if seed % 3 == 0:
        img = (img // 128 * 255).astype(np.uint8)
    return img


def _cv2(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    out = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    return out.reshape(new_h, new_w, *img.shape[2:])


@st.composite
def _resizes(draw):
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    mode = draw(st.sampled_from(["any", "double", "halve", "narrow", "ratio"]))
    if mode == "any":
        new_h, new_w = draw(st.integers(1, 64)), draw(st.integers(1, 64))
    elif mode == "double":
        new_h, new_w = 2 * h, 2 * w
    elif mode == "halve":
        new_h, new_w = max(h // 2, 1), max(w // 2, 1)
        h, w = 2 * new_h, 2 * new_w
    elif mode == "narrow":  # widths below 8, in and out
        w, new_w = draw(st.integers(1, 7)), draw(st.integers(1, 7))
        new_h = draw(st.integers(1, 64))
    else:  # a size-matching ratio
        scale = draw(st.floats(0.25, 4.0))
        new_h, new_w = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    channels = draw(st.sampled_from([0, 1, 3]))
    return draw(st.integers(0, 2**31 - 1)), h, w, new_h, new_w, channels


@settings(max_examples=400, deadline=None)
@given(_resizes())
def test_resize_linear_uint8_is_bitwise_cv2(case):
    seed, h, w, new_h, new_w, channels = case
    img = _frame(seed, h, w, channels)
    got = resize_linear_uint8(img, (new_h, new_w))
    assert got.dtype == np.uint8 and got.shape == (new_h, new_w, *img.shape[2:])
    np.testing.assert_array_equal(got, _cv2(img, new_h, new_w))


@pytest.mark.parametrize("src,dst,channels", [
    ((768, 768), (1024, 1024), 1),  # the mixed-size project chip_smoke.py trains on
    ((768, 768), (1024, 1024), 3),
    ((480, 640), (1024, 1365), 1),
    ((1024, 1024), (512, 512), 1),  # cv2's 2x2 area route
    ((1024, 1024), (341, 341), 3),
])
def test_resize_linear_uint8_frame_sizes(src, dst, channels):
    img = _frame(channels, *src, channels)
    np.testing.assert_array_equal(resize_linear_uint8(img, dst), _cv2(img, *dst))


def test_resize_linear_uint8_refuses_other_dtypes():
    with pytest.raises(TypeError, match="uint8"):
        resize_linear_uint8(np.zeros((4, 4), np.float32), (8, 8))


@pytest.mark.parametrize("src,target,channels", [
    ((768, 768), (1024, 1024), 1),
    ((300, 200), (512, 512), 3),   # scaled by the height, padded right
    ((97, 131), (131, 97), 1),     # downscaled to fit
    ((64, 64), (64, 96), 1),       # scale 1: pad only
    ((50, 50), (50, 50), 3),       # already the target
    ((5, 7), (11, 11), 1),
    ((2, 5), (7, 7), 1),           # 2 * 1.4 = 2.8 -> 3
])
def test_size_matching_equals_jax_without_cv2(src, target, channels, monkeypatch):
    img = _frame(sum(src), *src, channels)
    want_img, want_scale = jtrainer.size_match_image(img, target)
    want_pad, want_pad_scale = jproviders.resize_and_pad_example(img, target)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got_img, got_scale = ttrainer.size_match_image(img, target)
    got_pad, got_pad_scale = tproviders.resize_and_pad_example(img, target)
    np.testing.assert_array_equal(got_img, want_img)
    np.testing.assert_array_equal(got_pad, want_pad)
    assert got_scale == want_scale and got_pad_scale == want_pad_scale
    assert got_img.dtype == want_img.dtype and got_pad.dtype == want_pad.dtype


def test_size_matching_rounds_half_to_even(monkeypatch):
    """``int(round(h * scale))`` rounds half to even: 5 * 1.5 = 7.5 -> 8
    rows and 3 * 1.5 = 4.5 -> 4 rows, the rest padding."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for h, target_h, rows in ((5, 8, 8), (3, 5, 4)):
        img = np.full((h, 4, 1), 200, np.uint8)
        got, scale = ttrainer.size_match_image(img, (target_h, 6))
        assert scale == 1.5
        assert (got[:rows] == 200).all() and (got[rows:] == 0).all()
