"""The port's Lucas-Kanade flow (``sleap_tpu_torch.ops.optical_flow``) and
the tracker's cv2-style resize against their references, on the CPU.

Inputs are made with numpy from seeds: Gaussian-smoothed noise (an FFT
filter of white noise), and the same field shifted by sub-pixel amounts
(a phase ramp), at odd sizes. Points sit inside, near the edges, on paths
that leave the image, in a flat region (not well posed) and at NaN.

Tolerances: status equal; shifted points within 1e-3 px; errors within
1e-4 relative, and 1e-4 absolute for errors near zero (a flat patch's
error is a sum of float32 roundings of 0-255 values, ~1e-5 each);
pyramid levels within 1e-5 relative (one float32 rounding of a 5-tap sum,
whose order XLA picks); resize within 1e-4 on 0-255 images (cv2 blends in
its own order and may fuse multiplies and adds).
"""

import cv2
import jax
import numpy as np
import pytest
import torch

from sleap_tpu.ops import optical_flow as jof
from sleap_tpu_torch.ops import optical_flow as tof
from sleap_tpu_torch.tracking import tracker as tt

torch.set_num_threads(1)

PT_TOL = 1e-3
ERR_RTOL = ERR_ATOL = 1e-4
PYR_RTOL = 1e-5
RESIZE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def smooth_field(h, w, seed, sigma=2.0, shift=(0.0, 0.0)):
    """(h, w) float32 Gaussian-smoothed noise in 0-255, shifted by
    ``shift`` = (dx, dy) px (periodic), via numpy's FFT."""
    rng = np.random.default_rng(seed)
    spec = np.fft.fft2(rng.standard_normal((h, w)))
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    spec *= np.exp(-2 * (np.pi * sigma) ** 2 * (fx**2 + fy**2))
    spec *= np.exp(-2j * np.pi * (fx * shift[0] + fy * shift[1]))
    field = np.real(np.fft.ifft2(spec))
    field = (field - field.min()) / (field.max() - field.min())
    return (255 * field).astype(np.float32)


def pair(h, w, seed, shift, flat=None):
    """(ref, new) images; ``flat`` = (y0, y1, x0, x1) is set to one value in
    both."""
    ref = smooth_field(h, w, seed)
    new = smooth_field(h, w, seed, shift=shift)
    if flat is not None:
        y0, y1, x0, x1 = flat
        ref[y0:y1, x0:x1] = new[y0:y1, x0:x1] = 100.0
    return ref, new


H, W = 75, 97
FLAT = (40, 75, 0, 40)  # the lower-left corner, 35 x 40 px
FLAT_POINT = [14.0, 60.0]  # its 21 x 21 window (and gradient taps) lie inside it


def points(seed, n=24):
    """Interior points, points near every edge, points the flow carries
    out of the image, one in the flat region, and NaN points."""
    rng = np.random.default_rng(seed)
    inner = rng.uniform([10, 10], [W - 11, H - 11], (n, 2))
    edges = [[0.3, 20.0], [W - 1.4, 30.0], [50.0, 0.6], [60.0, H - 1.2], [1.5, H - 2.5],
             [20.0, 0.3]]
    leaving = [[W - 1.1, 10.0]]  # the shift (1.3, -0.7) takes it out
    nan = [[np.nan, 10.0], [np.nan, np.nan]]
    return np.concatenate([inner, edges, leaving, [FLAT_POINT], nan]).astype(np.float32)


def jax_flow(ref, new, pts, **kw):
    return [np.asarray(a) for a in jof.lk_flow(ref, new, pts, **kw)]


def torch_flow(ref, new, pts, **kw):
    out = tof.lk_flow(torch.from_numpy(ref), torch.from_numpy(new), torch.from_numpy(pts), **kw)
    return [a.numpy() for a in out]


def assert_flow_equal(got, want):
    (gs, gst, ge), (ws, wst, we) = got, want
    np.testing.assert_array_equal(gst, wst)
    np.testing.assert_array_equal(np.isnan(gs), np.isnan(ws))
    np.testing.assert_allclose(np.nan_to_num(gs), np.nan_to_num(ws), atol=PT_TOL, rtol=0)
    np.testing.assert_allclose(ge, we, rtol=ERR_RTOL, atol=ERR_ATOL)


def test_pyramid_matches_jax():
    img = smooth_field(H, W, seed=0)
    want = img
    got = torch.from_numpy(img)
    for _ in range(3):
        want, got = np.asarray(jof._pyr_down(want)), tof.pyr_down(got)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=PYR_RTOL, atol=0)
    # The padded levels the flow reads: the image inside a 2-px zero frame.
    pyr = tof.build_pyramid(torch.from_numpy(img)[None], 3)
    assert [tuple(p.shape) for p in pyr] == [(1, 79, 101), (1, 42, 53), (1, 23, 29), (1, 14, 17)]
    assert torch.equal(pyr[0][0, 2:-2, 2:-2], torch.from_numpy(img))
    assert pyr[1][0, :2].abs().sum() == 0 and pyr[1][0, :, -2:].abs().sum() == 0


@pytest.mark.parametrize("window,levels,iters", [(21, 3, 30), (21, 1, 10), (7, 3, 10), (7, 1, 30)])
def test_lk_flow_matches_jax(window, levels, iters):
    ref, new = pair(H, W, seed=1, shift=(1.3, -0.7), flat=FLAT)
    pts = points(seed=2)
    kw = dict(window_size=window, max_levels=levels, max_iters=iters)
    got, want = torch_flow(ref, new, pts, **kw), jax_flow(ref, new, pts, **kw)
    assert_flow_equal(got, want)
    status = got[1]
    assert status[:24].sum() >= 20  # the interior points are found
    assert not status[-2:].any() and np.isnan(got[0][-2:]).all()  # NaN in, NaN out
    if window == 21:
        assert not status[30]  # carried out of the image
        assert not status[-3]  # the flat region is not well posed


def test_lk_flow_tracks_the_shift():
    ref, new = pair(H, W, seed=3, shift=(2.4, 1.6))
    pts = points(seed=4)[:24]
    shifted, status, _ = torch_flow(ref, new, pts)
    assert status.all()
    err = np.abs(shifted - pts - np.array([2.4, 1.6]))
    assert np.median(err) < 0.02 and err.max() < 0.3


def test_batched_pairs_match_per_pair_calls_and_jax():
    """One call over 3 pairs (one (B, H, W) batch, points padded with NaN)
    against each pair's own call."""
    shifts = [(1.3, -0.7), (-2.2, 0.4), (0.5, 2.9)]
    pairs = [pair(H, W, seed=10 + k, shift=s) for k, s in enumerate(shifts)]
    pts = [points(seed=20 + k, n=n) for k, n in enumerate((24, 10, 17))]
    n_max = max(len(p) for p in pts)
    batch = np.full((3, n_max, 2), np.nan, np.float32)
    for k, p in enumerate(pts):
        batch[k, :len(p)] = p
    ref = torch.from_numpy(np.stack([r for r, _ in pairs]))
    new = torch.from_numpy(np.stack([n for _, n in pairs]))
    bs, bst, be = [a.numpy() for a in tof.lk_flow(ref, new, torch.from_numpy(batch))]
    assert bs.shape == (3, n_max, 2) and bst.shape == be.shape == (3, n_max)
    for k, ((r, n), p) in enumerate(zip(pairs, pts)):
        got = (bs[k, :len(p)], bst[k, :len(p)], be[k, :len(p)])
        assert_flow_equal(got, torch_flow(r, n, p))
        assert_flow_equal(got, jax_flow(r, n, p))
        assert not bst[k, len(p):].any()  # the padding is NaN: status 0


def test_frames_of_two_sizes_match_jax():
    """A new frame of another size than the ref (frames of mixed-size
    videos): each image keeps its own border."""
    ref, new = pair(H, W, seed=8, shift=(0.8, 0.6))
    new = new[:64, :90].copy()
    pts = points(seed=9)
    assert_flow_equal(torch_flow(ref, new, pts), jax_flow(ref, new, pts))


# --------------------------------------------------------------------------- #
# The tracker's frame conversion
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("scale", [0.25, 0.5, 0.3])
@pytest.mark.parametrize("hw", [(64, 96), (97, 75)])
def test_resize_matches_cv2(scale, hw):
    img = smooth_field(*hw, seed=6)
    want = cv2.resize(img, None, None, scale, scale)
    got = tt.resize_linear(torch.from_numpy(img), scale).numpy()
    assert got.shape == want.shape == tt.resize_size(*hw, scale)
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


def test_resize_size_rounds_like_cv2():
    assert tt.resize_size(97, 75, 0.3) == (29, 22)  # 22.5 rounds to even
    for h, w, s in ((97, 75, 0.3), (75, 97, 0.5), (33, 101, 0.25), (1024, 1024, 0.3)):
        assert tt.resize_size(h, w, s) == cv2.resize(np.zeros((h, w), np.float32), None, None,
                                                     s, s).shape


def test_gray_conversion_uses_bgr_luma():
    rng = np.random.default_rng(7)
    bgr = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    want = (bgr @ np.array([0.114, 0.587, 0.299])).astype("f4")
    np.testing.assert_array_equal(tt.to_gray(bgr), want)
    one = rng.integers(0, 256, (9, 11, 1), dtype=np.uint8)
    np.testing.assert_array_equal(tt.to_gray(one), one[..., 0].astype("f4"))
