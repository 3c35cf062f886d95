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


# The cases the CUDA local-peaks kernel's design splits on: several channels,
# H and W off its 8-row bands and 256-column tiles, threshold <= 0 (every
# noise maximum is a peak and the -inf border decides at the edges), K above
# the peak count. JAX runs its Pallas kernel in interpret mode where its gate
# takes the maps (H % 8 == 0, W % 128 == 0), else its XLA path.
LOCAL_CASES = {
    "13ch_band_sized_pallas": ((2, 16, 128, 13), 8, 0.2, "integral"),
    "3ch_threshold0_pallas": ((2, 16, 128, 3), 8, 0.0, "integral"),
    "k_above_count_pallas": ((1, 24, 128, 2), 12, 0.2, None),
    "70x45_xla": ((3, 70, 45, 2), 8, 0.2, "integral"),
    "70x45_threshold_neg1_xla": ((2, 70, 45, 3), 64, -1.0, None),
    "9x300_k_above_count_xla": ((1, 9, 300, 1), 64, 0.2, "integral"),
}


@pytest.mark.parametrize("case", list(LOCAL_CASES))
def test_local_peaks_design_cases_match_jax(case):
    (S, H, W, C), K, threshold, refinement = LOCAL_CASES[case]
    cms = _planted_maps(seed=11, S=S, H=H, W=W, C=C, n=4)
    got = tpf.find_local_peaks(
        torch.from_numpy(cms), max_peaks=K, threshold=threshold, refinement=refinement
    )
    if H % 8 == 0 and W % 128 == 0:
        flat = jnp.transpose(jnp.asarray(cms), (0, 3, 1, 2)).reshape(S * C, H, W)
        pk, v = find_local_peaks_fused_pallas(
            flat, max_peaks=K, threshold=threshold, refine=refinement == "integral", interpret=True
        )
        v = np.asarray(v).reshape(S, C, K)
        valid = np.isfinite(v)
        want = (np.where(valid[..., None], np.asarray(pk).reshape(S, C, K, 2), np.nan),
                np.where(valid, v, 0.0), valid)
    else:
        want = jpf.find_local_peaks(
            jnp.asarray(cms), max_peaks=K, threshold=threshold, refinement=refinement,
            use_pallas=False,
        )
    _assert_local_equal(got, *want)
    assert got[2].any()
    if "k_above_count" in case:
        assert not got[2].all()


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


# Boxes off every edge and corner of a 180 x 140 frame.
EDGE_TOP_LEFT = np.array(
    [[3.25, 4.5], [-4.5, 20.2], [130.9, 30.0], [40.0, -6.75], [50.5, 170.5],
     [-8.0, -9.5], [135.3, 176.1], [-200.0, 5.0], [60.0, 300.0]],
    np.float32,
)


@pytest.mark.parametrize(
    "crop_size,channels",
    [((7, 5), 1), ((7, 5), 3), ((161, 33), 3), ((33, 17), 1), ((1, 1), 3), ((9, 190), 3)],
)
def test_crops_odd_sizes_and_edges_match_xla(crop_size, channels):
    """Crop sizes that are not multiples of the CUDA kernel's 16-row bands,
    4-element stores or 512-element segments (190 x 3 spans two), C = 1
    and 3, boxes off every edge. The frame widens for crops wider than it,
    which the XLA version does not take."""
    width = max(140, crop_size[1] + 2)
    imgs = np.random.default_rng(10).integers(0, 256, (2, 180, width, channels)).astype(np.uint8)
    want = jpf.crop_bboxes_unit(
        jnp.asarray(imgs), jnp.asarray(EDGE_TOP_LEFT), jnp.asarray(BOX_INDS, jnp.int32), crop_size
    )
    got = tpf.crop_bboxes_unit(
        torch.from_numpy(imgs), torch.from_numpy(EDGE_TOP_LEFT), torch.from_numpy(BOX_INDS),
        crop_size,
    )
    assert got.shape == (9, *crop_size, channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=0)
    assert not got[7].any()  # wholly outside the frame


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
