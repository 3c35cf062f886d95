"""The port's peak finding and crops (the plain versions the CUDA kernels are
held against) vs the JAX XLA path and the Pallas kernels in interpret mode.

Tolerances: xy within 1e-4 px (window sums in another order), values within
1e-6, masks equal; crops within 1e-3 before the cast back to uint8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.ops import peak_finding as jpf
from sleap_tpu.ops.pallas_crops import crop_bboxes_unit_pallas
from sleap_tpu.ops.pallas_peaks import (
    find_global_peaks_integral_pallas,
    find_local_peaks_fused_pallas,
)
from sleap_tpu_torch.ops import peak_finding as tpf
from sleap_tpu_torch.ops.cuda_crops import crop_unit_cuda
from sleap_tpu_torch.ops.cuda_peaks import global_peaks_cuda, local_peaks_cuda

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield

XY_TOL = 1e-4
VAL_TOL = 1e-6


def _planted_maps(seed=0, S=2, H=32, W=128, C=3, n=5):
    rng = np.random.RandomState(seed)
    cms = np.zeros((S, H, W, C), np.float32)
    yv, xv = np.mgrid[0:H, 0:W]
    for s in range(S):
        for c in range(C):
            for _ in range(n):
                cy, cx = rng.uniform(0, H - 1), rng.uniform(0, W - 1)
                amp = rng.uniform(0.3, 1.0)
                cms[s, :, :, c] += amp * np.exp(-((yv - cy) ** 2 + (xv - cx) ** 2) / (2 * 1.5**2))
    cms += rng.uniform(0, 0.05, cms.shape).astype(np.float32)
    return cms


def _close_nan(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b), atol=atol, rtol=0)


# --------------------------------------------------------------------------- #
# Global peaks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("refinement", ["integral", None, "local"])
def test_global_peaks_match_xla(refinement):
    cms = _planted_maps(seed=1)
    cms[0, :, :, 1] *= 0.1  # one map below threshold -> NaN
    want_xy, want_v = jpf.find_global_peaks(jnp.asarray(cms), threshold=0.2, refinement=refinement)
    got_xy, got_v = tpf.find_global_peaks(torch.from_numpy(cms), threshold=0.2, refinement=refinement)
    assert np.isnan(np.asarray(want_xy)[0, 1]).all()
    _close_nan(got_xy, want_xy, XY_TOL)
    np.testing.assert_allclose(got_v, want_v, atol=VAL_TOL)


def test_global_peaks_integral_match_pallas_interpret():
    cms = _planted_maps(seed=2, S=3, H=40, W=40, C=5)
    want_xy, want_v = find_global_peaks_integral_pallas(jnp.asarray(cms), threshold=0.2, interpret=True)
    got_xy, got_v = tpf.find_global_peaks(torch.from_numpy(cms), threshold=0.2, refinement="integral")
    _close_nan(got_xy, want_xy, XY_TOL)
    np.testing.assert_allclose(got_v, want_v, atol=VAL_TOL)


def test_global_peaks_ties_and_border():
    """Equal maxima go to the first row-major index; a peak on the border
    uses the zero-padded window."""
    cms = np.zeros((1, 16, 16, 2), np.float32)
    cms[0, 9, 3, 0] = cms[0, 2, 12, 0] = cms[0, 2, 14, 0] = 1.0
    cms[0, 0, 15, 1] = 1.0
    cms[0, 1, 15, 1] = 0.5
    cms[0, 0, 14, 1] = 0.25
    want_xy, want_v = jpf.find_global_peaks(jnp.asarray(cms), threshold=0.2, refinement="integral")
    got_xy, got_v = tpf.find_global_peaks(torch.from_numpy(cms), threshold=0.2, refinement="integral")
    # argmax (12, 2); the equal pixel (14, 2) in its window pulls x to 13.
    np.testing.assert_allclose(got_xy[0, 0], [13, 2], atol=XY_TOL)
    _close_nan(got_xy, want_xy, XY_TOL)
    np.testing.assert_allclose(got_v, want_v, atol=VAL_TOL)


def test_global_peaks_with_offsets_match_xla():
    cms = _planted_maps(seed=3, C=2)
    offsets = np.random.default_rng(3).uniform(-0.5, 0.5, cms.shape[:3] + (4,)).astype(np.float32)
    want = jpf.find_global_peaks_with_offsets(jnp.asarray(cms), jnp.asarray(offsets), threshold=0.2)
    got = tpf.find_global_peaks_with_offsets(torch.from_numpy(cms), torch.from_numpy(offsets), threshold=0.2)
    _close_nan(got[0], want[0], XY_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=VAL_TOL)


# --------------------------------------------------------------------------- #
# Local peaks
# --------------------------------------------------------------------------- #


def _assert_local_equal(got, want_peaks, want_vals, want_mask):
    peaks, vals, mask = (t.numpy() for t in got)
    np.testing.assert_array_equal(mask, np.asarray(want_mask))
    _close_nan(peaks, want_peaks, XY_TOL)
    np.testing.assert_allclose(vals, np.asarray(want_vals), atol=VAL_TOL)


@pytest.mark.parametrize("refinement", ["integral", None, "local"])
def test_local_peaks_match_xla(refinement):
    cms = _planted_maps(seed=4)
    want = jpf.find_local_peaks(
        jnp.asarray(cms), max_peaks=8, threshold=0.2, refinement=refinement, use_pallas=False
    )
    got = tpf.find_local_peaks(torch.from_numpy(cms), max_peaks=8, threshold=0.2, refinement=refinement)
    _assert_local_equal(got, *want)


@pytest.mark.parametrize("refine", [True, False])
def test_local_peaks_match_pallas_interpret(refine):
    cms = _planted_maps(seed=5)
    S, H, W, C = cms.shape
    flat = jnp.transpose(jnp.asarray(cms), (0, 3, 1, 2)).reshape(S * C, H, W)
    pk, v = find_local_peaks_fused_pallas(flat, max_peaks=4, threshold=0.2, refine=refine, interpret=True)
    v = np.asarray(v).reshape(S, C, 4)
    valid = np.isfinite(v)
    want_peaks = np.where(valid[..., None], np.asarray(pk).reshape(S, C, 4, 2), np.nan)
    got = tpf.find_local_peaks(
        torch.from_numpy(cms), max_peaks=4, threshold=0.2,
        refinement="integral" if refine else None,
    )
    _assert_local_equal(got, want_peaks, np.where(valid, v, 0.0), valid)


def test_local_peaks_ties_and_fewer_than_k():
    """Equal isolated peaks order by row-major index; plateaus are not
    peaks (strict NMS); slots beyond the peak count are empty."""
    cms = np.zeros((1, 16, 128, 1), np.float32)
    for y, x in [(9, 3), (2, 100), (2, 7), (14, 127), (0, 0)]:
        cms[0, y, x, 0] = 0.7
    cms[0, 5, 50:52, 0] = 0.9  # two equal neighbours: neither is a peak
    want = jpf.find_local_peaks(jnp.asarray(cms), max_peaks=8, threshold=0.2, use_pallas=False)
    got = tpf.find_local_peaks(torch.from_numpy(cms), max_peaks=8, threshold=0.2)
    _assert_local_equal(got, *want)
    np.testing.assert_array_equal(
        got[0][0, 0, :5].numpy(), [[0, 0], [7, 2], [100, 2], [3, 9], [127, 14]]
    )
    assert not got[2][0, 0, 5:].any()

    flat = jnp.asarray(cms[..., 0])
    pk, v = find_local_peaks_fused_pallas(flat, max_peaks=8, threshold=0.2, refine=False, interpret=True)
    np.testing.assert_array_equal(np.isfinite(np.asarray(v)), got[2][:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(pk)[0, :5], got[0][0, 0, :5].numpy())


def test_local_peaks_with_offsets_match_xla():
    cms = _planted_maps(seed=6, C=1)
    offsets = np.random.default_rng(6).uniform(-0.5, 0.5, cms.shape[:3] + (2,)).astype(np.float32)
    want = jpf.find_local_peaks_with_offsets(jnp.asarray(cms), jnp.asarray(offsets), max_peaks=6, threshold=0.2)
    got = tpf.find_local_peaks_with_offsets(
        torch.from_numpy(cms), torch.from_numpy(offsets), max_peaks=6, threshold=0.2
    )
    _assert_local_equal(got, *want)


def test_integral_regression_matches_jax():
    patches = np.random.default_rng(7).uniform(0, 1, (6, 5, 5, 2)).astype(np.float32)
    gv = np.arange(5, dtype=np.float32) - 2
    want = jpf.integral_regression(jnp.asarray(patches), jnp.asarray(gv), jnp.asarray(gv))
    got = tpf.integral_regression(torch.from_numpy(patches), torch.from_numpy(gv), torch.from_numpy(gv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# --------------------------------------------------------------------------- #
# Crops
# --------------------------------------------------------------------------- #

# Interior fractional boxes plus boxes hanging off every edge and corner.
TOP_LEFT = np.array(
    [[10.3, 20.7], [-20.5, -10.2], [200.9, 30.0], [30.0, 50.25], [-5.0, 40.5],
     [0.0, 0.0], [180.25, -6.75], [240.5, 60.5], [-300.0, 5.0]],
    np.float32,
)
BOX_INDS = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0], np.int64)


@pytest.mark.parametrize("channels,dtype", [(1, np.uint8), (3, np.uint8), (3, np.float32)])
def test_crops_match_xla(channels, dtype):
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (2, 64, 256, channels)).astype(dtype)
    want = jpf.crop_bboxes_unit(
        jnp.asarray(imgs), jnp.asarray(TOP_LEFT), jnp.asarray(BOX_INDS, jnp.int32), (8, 128)
    )
    got = tpf.crop_bboxes_unit(
        torch.from_numpy(imgs), torch.from_numpy(TOP_LEFT), torch.from_numpy(BOX_INDS), (8, 128)
    )
    assert got.dtype == torch.float32 and got.shape == (9, 8, 128, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_crops_match_pallas_interpret():
    imgs = np.random.default_rng(9).integers(0, 256, (2, 64, 256, 1), np.uint8)
    want = crop_bboxes_unit_pallas(
        jnp.asarray(imgs), jnp.asarray(TOP_LEFT), jnp.asarray(BOX_INDS, jnp.int32), (8, 128),
        interpret=True,
    )
    got = tpf.crop_bboxes_unit(
        torch.from_numpy(imgs), torch.from_numpy(TOP_LEFT), torch.from_numpy(BOX_INDS), (8, 128)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)


def test_cuda_wrappers_refuse_non_cuda_tensors():
    """A tensor that is neither on the CPU nor on a CUDA device raises; it
    never reaches a plain version."""
    maps = torch.empty((1, 8, 8, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpf.find_global_peaks(maps, refinement="integral")
    with pytest.raises(ValueError, match="CUDA"):
        tpf.find_local_peaks(maps, max_peaks=2)
    with pytest.raises(ValueError, match="CUDA"):
        tpf.crop_bboxes_unit(
            torch.empty((1, 8, 8, 1), dtype=torch.uint8, device="meta"),
            torch.zeros((1, 2)), torch.zeros(1, dtype=torch.int64), (4, 4),
        )
    for wrapper in (global_peaks_cuda, local_peaks_cuda, crop_unit_cuda):
        assert wrapper.launches == 0
