"""Kernel 1 (global peaks) on the CPU: the port's plain version, reached
through ``find_global_peaks``, against the Pallas kernel in interpret mode
and JAX's rough peaks, on the layouts and dtypes the port's paths hand it:
bf16 maps channels-last (the bf16 head conv's output), maps holding NaNs
(the integral route against the Pallas kernel, the other routes against
JAX's rough peaks), and float16 maps (cast to float32 before the kernel).

Tolerances: values and integer peaks exact. On bf16 maps the refined xy are
exact too: both sides sum the same float32 window values in the same order.
On a map holding a NaN, xy within 1e-5 px (the window's sums divide in
another order than the TPU kernel's masked reductions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.ops import peak_finding as jpf
from sleap_tpu.ops.pallas_peaks import find_global_peaks_integral_pallas
from sleap_tpu_torch.ops import peak_finding as tpf
from sleap_tpu_torch.ops.cuda_peaks import global_peaks_cuda, global_peaks_plain

torch.set_num_threads(1)

NAN_XY_TOL = 1e-5


def _planted(seed, S, H, W, C, n=2):
    rng = np.random.RandomState(seed)
    yv, xv = np.mgrid[0:H, 0:W]
    cms = np.zeros((S, H, W, C), np.float32)
    for s in range(S):
        for c in range(C):
            for _ in range(n):
                cy, cx = rng.uniform(0, H - 1), rng.uniform(0, W - 1)
                amp = rng.uniform(0.3, 1.0)
                cms[s, :, :, c] += amp * np.exp(-((yv - cy) ** 2 + (xv - cx) ** 2) / (2 * 1.5**2))
    return cms + rng.uniform(0, 0.05, cms.shape).astype(np.float32)


def _bf16_pair(cms):
    """The same bf16 values as a JAX array and a channels-last torch tensor."""
    j = jnp.asarray(cms).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).view(np.int16)
    return j, torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _close_nan(a, b, atol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


# The bf16 paths' shapes: single-instance (4 x 48^2 x 13), top-down stage 3
# (crops of 40^2 x 13), and odd sizes whose rows are no multiple of 16 bytes.
BF16_SHAPES = {
    "single_instance_48": (4, 48, 48, 13),
    "topdown_crops_40": (3, 40, 40, 13),
    "odd_37x41": (2, 37, 41, 5),
}


@pytest.mark.parametrize("shape", list(BF16_SHAPES))
def test_bf16_channels_last_integral_matches_pallas(shape):
    cms = _planted(1, *BF16_SHAPES[shape])
    cms[0, ..., 1] *= 0.1  # below threshold: NaN xy
    j, t = _bf16_pair(cms)
    assert t.dtype == torch.bfloat16 and t.is_contiguous()
    want_xy, want_v = find_global_peaks_integral_pallas(j, threshold=0.2, interpret=True)
    got_xy, got_v = tpf.find_global_peaks(t, threshold=0.2, refinement="integral")
    assert got_xy.dtype == got_v.dtype == torch.float32
    assert np.isnan(got_xy[0, 1].numpy()).all()
    _close_nan(got_xy, want_xy, 0.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("shape", list(BF16_SHAPES))
def test_bf16_channels_last_rough_matches_jax(shape):
    cms = _planted(2, *BF16_SHAPES[shape])
    j, t = _bf16_pair(cms)
    want_xy, want_v = jpf.find_global_peaks_rough(j, threshold=0.2)
    got_xy, got_v = tpf.find_global_peaks_rough(t, threshold=0.2)
    _close_nan(got_xy, want_xy, 0.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v).astype(np.float32))


def test_bf16_ties_take_the_first_index():
    """Ten equal maxima: the first in row-major order, as jnp.argmax."""
    cms = np.zeros((1, 40, 40, 2), np.float32)
    for k in range(10):
        cms[0, 2 + 3 * k, 1 + 3 * k, 0] = 0.5
        cms[0, 30 - 3 * k, 37 - 3 * k, 1] = 0.75
    j, t = _bf16_pair(cms)
    want_xy, want_v = find_global_peaks_integral_pallas(j, threshold=0.2, interpret=True)
    got_xy, got_v = tpf.find_global_peaks(t, threshold=0.2, refinement="integral")
    np.testing.assert_array_equal(got_xy.numpy(), [[[1, 2], [10, 3]]])
    _close_nan(got_xy, want_xy, 0.0)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_map_matches_pallas(dtype):
    """A NaN anywhere: value NaN, argmax H*W, the window masked around
    (0, H); one NaN lies in that window, so its xy is NaN too."""
    S, H, W, C = 2, 24, 20, 4
    cms = _planted(3, S, H, W, C)
    cms[0, 5, 7, 1] = np.nan
    cms[1, H - 1, 1, 2] = np.nan  # inside the window around (0, H)
    cms[1, 0, 0, 3] = np.nan
    if dtype == "bfloat16":
        j, t = _bf16_pair(cms)
    else:
        j, t = jnp.asarray(cms), torch.from_numpy(cms)
    want_xy, want_v = find_global_peaks_integral_pallas(j, threshold=0.2, interpret=True)
    got_xy, got_v = tpf.find_global_peaks(t, threshold=0.2, refinement="integral")
    want_v = np.asarray(want_v).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(got_v.numpy()), np.isnan(want_v))
    assert np.isnan(want_v).sum() == 3
    _close_nan(got_xy, want_xy, NAN_XY_TOL)
    assert np.isfinite(got_xy[0, 1].numpy()).all()  # NaN < threshold is false
    assert H - 2 < got_xy[0, 1, 1] < H  # centred on row H, pulled up by the map's last rows
    assert np.isnan(got_xy[1, 2].numpy()).all()


def test_nan_map_rough_peak_is_row_h():
    """The rough (grid) route takes the first NaN, as jnp.argmax does, and
    keeps its xy: on the 8 x 6 map with one NaN at (y=3, x=4) that is
    (4, 3) with value NaN. Row H stays the integral route's rule."""
    cms = _planted(4, 1, 8, 6, 2) * 0.1
    cms[0, 3, 4, 0] = np.nan
    t = torch.from_numpy(cms)
    want_xy, want_v = jpf.find_global_peaks_rough(jnp.asarray(cms), threshold=0.2)
    xy, vals = tpf.find_global_peaks_rough(t, threshold=0.2)
    np.testing.assert_array_equal(xy[0, 0].numpy(), [4, 3])
    assert np.isnan(vals[0, 0].item()) and np.isfinite(vals[0, 1].item())
    _close_nan(xy, want_xy, 0.0)
    _close_nan(vals, want_v, 0.0)
    xy_int, _ = tpf.find_global_peaks(t, threshold=0.2, refinement="integral")
    assert 6 < xy_int[0, 0, 1] < 8


# NaN placements: alone, several (the first wins), and before and after the
# map's finite maximum in row-major order.
NAN_CASES = {
    "one": [(5, 7)],
    "several": [(9, 3), (2, 11), (2, 12), (15, 0)],
    "before_max": [(0, 1)],
    "after_max": [(17, 14)],
}


def _nan_maps(case):
    cms = _planted(7, 2, 18, 15, 3)
    cms[0, 8, 6, 1] = 5.0  # the finite maximum of map (0, 1), at index 8 * 15 + 6
    for y, x in NAN_CASES[case]:
        cms[0, y, x, 1] = np.nan
    cms[1, 4, 4, 2] = np.nan
    return cms


@pytest.mark.parametrize("case", list(NAN_CASES))
@pytest.mark.parametrize("route", ["rough", "none", "local", "offsets"])
def test_nan_maps_match_jax(route, case):
    """Every global-peak route but the integral one gives JAX's answer on
    maps holding NaNs, and none raises."""
    cms = _nan_maps(case)
    off = np.random.RandomState(8).uniform(-0.5, 0.5, cms.shape[:3] + (6,)).astype(np.float32)
    j, t = jnp.asarray(cms), torch.from_numpy(cms)
    if route == "rough":
        want = jpf.find_global_peaks_rough(j, threshold=0.2)
        got = tpf.find_global_peaks_rough(t, threshold=0.2)
    elif route == "offsets":
        want = jpf.find_global_peaks_with_offsets(j, jnp.asarray(off), threshold=0.2)
        got = tpf.find_global_peaks_with_offsets(t, torch.from_numpy(off), threshold=0.2)
    else:
        refinement = None if route == "none" else route
        want = jpf.find_global_peaks(j, threshold=0.2, refinement=refinement)
        got = tpf.find_global_peaks(t, threshold=0.2, refinement=refinement)
    for g, w in zip(got, want):
        _close_nan(g, w, 0.0)
    assert np.isnan(got[1][0, 1].item()) and np.isnan(got[1][1, 2].item())
    if route != "local":  # local: a NaN beside the peak makes its step NaN
        assert np.isfinite(got[0][0, 1].numpy()).all()
    y, x = NAN_CASES[case][0] if case != "several" else (2, 11)
    if route in ("rough", "none"):
        np.testing.assert_array_equal(got[0][0, 1].numpy(), [x, y])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_map_plain_rough_takes_first_nan(dtype):
    """The plain version (phase 3's reference for the kernel) on both dtypes
    and on the NHWC view of NCHW maps: the first NaN, value NaN."""
    cms = _nan_maps("several")
    t = _bf16_pair(cms)[1] if dtype == "bfloat16" else torch.from_numpy(cms)
    for view in (t, t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)):
        xy, vals = global_peaks_plain(view, 0.2, -1)
        np.testing.assert_array_equal(xy[0, 1].numpy(), [11, 2])
        np.testing.assert_array_equal(xy[1, 2].numpy(), [4, 4])
        assert np.isnan(vals[0, 1].item()) and np.isnan(vals[1, 2].item())


@pytest.mark.parametrize("refinement", ["integral", None])
def test_float16_maps_are_cast(refinement):
    cms = _planted(5, 2, 40, 40, 3).astype(np.float16)
    f32 = cms.astype(np.float32)  # exact
    got_xy, got_v = tpf.find_global_peaks(torch.from_numpy(cms), threshold=0.2, refinement=refinement)
    assert got_xy.dtype == got_v.dtype == torch.float32
    if refinement == "integral":
        want_xy, want_v = find_global_peaks_integral_pallas(jnp.asarray(f32), threshold=0.2, interpret=True)
    else:
        want_xy, want_v = jpf.find_global_peaks_rough(jnp.asarray(f32), threshold=0.2)
    _close_nan(got_xy, want_xy, 1e-6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_plain_version_reads_any_strides():
    """The NHWC view of NCHW maps, a channel slice and a strided slice give
    the contiguous maps' peaks."""
    nchw = torch.from_numpy(_planted(6, 2, 30, 28, 5)).permute(0, 3, 1, 2).contiguous()
    views = {
        "nchw_view": nchw.permute(0, 2, 3, 1),
        "channel_slice": nchw[:, 1:4].permute(0, 2, 3, 1),
        "strided": nchw.permute(0, 2, 3, 1)[:, 1::2, ::3, ::2],
    }
    for name, view in views.items():
        for half in (2, -1):
            got = global_peaks_plain(view, 0.2, half)
            want = global_peaks_plain(view.contiguous(), 0.2, half)
            for g, w in zip(got, want):
                _close_nan(g, w, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_global_peaks_cuda_refuses_cpu_tensors(dtype):
    maps = torch.zeros((1, 8, 8, 2), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        global_peaks_cuda(maps, 0.2, 2)
    assert global_peaks_cuda.launches == 0
