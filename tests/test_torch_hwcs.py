"""Kernel 4's plain version (bf16 local peaks by packed keys) and the
bf16 route of ``find_local_peaks``, against the JAX package's
``find_local_peaks_fused_pallas_hwcs`` in interpret mode on the same bf16
maps.

Tolerances: values, masks and integer peak locations exact; refined xy
within 1e-5 px (the TPU kernel divides by multiplying with 1 / z and sums its
window separably).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.ops.pallas_peaks import find_local_peaks_fused_pallas_hwcs
from sleap_tpu_torch.ops import cuda_peaks
from sleap_tpu_torch.ops import peak_finding as tpf

torch.set_num_threads(1)

XY_TOL = 1e-5


def _planted(seed=0, S=2, H=32, W=64, C=3, n=5):
    rng = np.random.RandomState(seed)
    cms = np.zeros((S, H, W, C), np.float32)
    yv, xv = np.mgrid[0:H, 0:W]
    for s in range(S):
        for c in range(C):
            for _ in range(n):
                cy, cx = rng.uniform(0, H - 1), rng.uniform(0, W - 1)
                amp = rng.uniform(0.3, 1.0)
                cms[s, :, :, c] += amp * np.exp(-((yv - cy) ** 2 + (xv - cx) ** 2) / (2 * 1.5**2))
    return cms + rng.uniform(0, 0.05, cms.shape).astype(np.float32)


def _bf16_pair(cms):
    """The same bf16 maps for both packages: (jax (S, H, W, C), torch)."""
    j = jnp.asarray(cms).astype(jnp.bfloat16)
    bits = np.array(np.asarray(j).view(np.uint16)).view(np.int16)
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _jax_hwcs(jmaps, K, refine):
    pk, v = find_local_peaks_fused_pallas_hwcs(
        jnp.transpose(jmaps, (1, 2, 3, 0)), max_peaks=K, threshold=0.2, refine=refine,
        interpret=True,
    )
    v = np.asarray(v)
    pk = np.where(np.isfinite(v)[..., None], np.asarray(pk), np.nan)
    return pk, v


def _assert_hwcs_equal(cms, K=8, refine=True, min_peaks=1):
    jmaps, tmaps = _bf16_pair(cms)
    want_pk, want_v = _jax_hwcs(jmaps, K, refine)
    got_pk, got_v = cuda_peaks.local_peaks_hwcs_plain(tmaps, K, 0.2, 2 if refine else -1)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(np.isnan(got_pk.numpy()), np.isnan(want_pk))
    np.testing.assert_allclose(np.nan_to_num(got_pk.numpy()), np.nan_to_num(want_pk),
                               atol=XY_TOL, rtol=0)
    if not refine:  # integer locations are exact
        np.testing.assert_array_equal(got_pk.numpy(), want_pk)
    assert np.isfinite(want_v).sum() >= min_peaks
    return tmaps


@pytest.mark.parametrize("refine", [True, False])
def test_hwcs_plain_matches_pallas_planted(refine):
    _assert_hwcs_equal(_planted(), refine=refine, min_peaks=20)


@pytest.mark.parametrize("refine", [True, False])
def test_hwcs_plain_matches_pallas_more_peaks_than_k(refine):
    # 12 planted peaks per map and noise: more NMS survivors than K = 4.
    _assert_hwcs_equal(_planted(seed=1, S=1, H=32, W=32, C=2, n=12), K=4, refine=refine,
                       min_peaks=8)


def test_hwcs_plain_matches_pallas_border_peaks():
    m = np.zeros((1, 16, 32, 1), np.float32)
    m[0, 0, 0, 0] = 0.9
    m[0, 0, 17, 0] = 0.8
    m[0, 15, 31, 0] = 0.7
    m[0, 7, 0, 0] = 0.6
    m[0, 9, 31, 0] = 0.5
    m[0, 10, 30, 0] = 0.25  # in the window of (9, 31), and its neighbour
    for refine in (True, False):
        _assert_hwcs_equal(m, refine=refine, min_peaks=5)


def test_hwcs_plain_matches_pallas_value_ties():
    """Equal values go to the smaller row-major index first."""
    m = np.zeros((2, 16, 32, 1), np.float32)
    m[0, 4, 20, 0] = m[0, 4, 5, 0] = m[0, 12, 9, 0] = 0.5
    m[1, 3, 3, 0] = 0.25
    m[1, 5, 9, 0] = m[1, 5, 10, 0] = 0.75  # equal neighbours: neither is a peak
    tmaps = _assert_hwcs_equal(m, K=3, refine=False, min_peaks=4)
    pk, v = cuda_peaks.local_peaks_hwcs_plain(tmaps, 3, 0.2, -1)
    np.testing.assert_array_equal(pk[0, 0].numpy(), [[5, 4], [20, 4], [9, 12]])
    assert torch.isfinite(v[1, 0, 0]) and not torch.isfinite(v[1, 0, 1:]).any()


def test_hwcs_plain_matches_pallas_fewer_than_k():
    m = np.zeros((1, 16, 32, 2), np.float32)
    m[0, 6, 10, 0] = 1.0
    _assert_hwcs_equal(m, K=4, refine=True, min_peaks=1)


def test_hwcs_plain_matches_pallas_minimum_height():
    rng = np.random.RandomState(7)
    m = rng.uniform(0, 0.05, (2, 4, 32, 2)).astype(np.float32)
    m[0, 1, 5, 0] = 0.9
    m[0, 2, 20, 1] = 0.7
    m[1, 0, 9, 0] = 0.6
    m[1, 3, 30, 1] = 0.8
    _assert_hwcs_equal(m, refine=True, min_peaks=4)


@pytest.mark.parametrize("S", [3, 5])
def test_hwcs_plain_matches_pallas_sample_counts(S):
    _assert_hwcs_equal(_planted(seed=S, S=S, H=16, W=32, C=2, n=3), K=4, min_peaks=S)


def test_hwcs_plain_equals_kernel2_plain_on_float_maps():
    """Kernel 4's contract is kernel 2's on ``maps.float()``, on any strides."""
    _, tmaps = _bf16_pair(_planted(seed=3, C=4))
    nchw_view = tmaps.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for half in (2, -1):
        want = cuda_peaks.local_peaks_plain(tmaps.float(), 8, 0.2, half)
        for maps in (tmaps, nchw_view):
            got = cuda_peaks.local_peaks_hwcs_plain(maps, 8, 0.2, half)
            torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_find_local_peaks_bf16_matches_pallas():
    cms = _planted(seed=4)
    jmaps, tmaps = _bf16_pair(cms)
    want_pk, want_v = _jax_hwcs(jmaps, 8, True)
    peaks, vals, mask = tpf.find_local_peaks(tmaps, max_peaks=8, threshold=0.2,
                                              refinement="integral")
    np.testing.assert_array_equal(mask.numpy(), np.isfinite(want_v))
    np.testing.assert_array_equal(vals.numpy(), np.where(np.isfinite(want_v), want_v, 0.0))
    np.testing.assert_allclose(np.nan_to_num(peaks.numpy()), np.nan_to_num(want_pk),
                               atol=XY_TOL, rtol=0)


def _route(monkeypatch, maps, **kwargs):
    """Which peak kernel ``find_local_peaks`` calls, and the dtype it hands it."""
    calls = []
    for name in ("local_peaks", "local_peaks_hwcs"):
        real = getattr(tpf, name)

        def spy(cms, *args, _name=name, _real=real):
            calls.append((_name, cms.dtype))
            return _real(cms, *args)

        monkeypatch.setattr(tpf, name, spy)
    tpf.find_local_peaks(maps, max_peaks=4, threshold=kwargs.pop("threshold", 0.2), **kwargs)
    assert len(calls) == 1
    return calls[0]


def test_find_local_peaks_routes_bf16_to_kernel4(monkeypatch):
    _, small = _bf16_pair(_planted(seed=5, S=1, H=16, W=16, C=2))
    _, large = _bf16_pair(np.zeros((1, 257, 256, 1), np.float32))  # H * W > 2^16
    bf16, f32 = ("local_peaks_hwcs", torch.bfloat16), ("local_peaks", torch.float32)
    assert _route(monkeypatch, small) == bf16
    assert _route(monkeypatch, small, refinement="integral") == bf16
    assert _route(monkeypatch, small.float(), refinement="integral") == f32
    # Everything kernel 4 does not take goes to kernel 2 as float32.
    assert _route(monkeypatch, small, refinement="integral", integral_patch_size=7) == f32
    assert _route(monkeypatch, small, refinement="local") == f32
    assert _route(monkeypatch, small, threshold=0.0) == f32
    assert _route(monkeypatch, large) == f32


def test_hwcs_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    _, maps = _bf16_pair(_planted(seed=6, S=1, H=16, W=16, C=1))
    wrapper = cuda_peaks.local_peaks_hwcs_cuda
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(maps, 4, 0.2, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        wrapper(maps.float(), 4, 0.2, 2)
    with pytest.raises(ValueError, match="5 x 5"):
        wrapper(maps, 4, 0.2, 3)
    with pytest.raises(ValueError, match="threshold"):
        wrapper(maps, 4, 0.0, 2)
    with pytest.raises(ValueError, match="max_peaks"):
        wrapper(maps, 65, 0.2, 2)
    with pytest.raises(ValueError, match="2\\*\\*16"):
        wrapper(torch.zeros((1, 512, 256, 1), dtype=torch.bfloat16), 4, 0.2, 2)
    assert wrapper.launches == 0


def test_hwcs_tiling_fits_shared_memory():
    # Bands of 16 rows by up to 256 columns; channels come in groups of 16,
    # so no channel count is refused and the ring stays under 33 KB.
    assert cuda_peaks.hwcs_blocks(256, 256) == 16  # the bottom-up main path
    assert cuda_peaks.hwcs_blocks(4, 32) == 1
    assert cuda_peaks.hwcs_blocks(1, 65536) == 256  # a row wider than a block
    assert cuda_peaks.hwcs_blocks(250, 257) == 16 * 2


def test_hwcs_fast_rows_only_for_aligned_channels_last_rows():
    """Kernel 4 copies rows with 16-byte async copies only where a row is
    W * C contiguous, 16-byte aligned bf16 values that one block spans."""
    fast = cuda_peaks.hwcs_fast_rows

    main = torch.zeros((16, 256, 256, 13), dtype=torch.bfloat16)
    assert fast(main)  # the head conv's channels-last output
    assert not fast(main.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))  # NCHW view
    assert not fast(torch.zeros((16, 100, 100, 3), dtype=torch.bfloat16))  # W*C*2 % 16 != 0
    assert not fast(torch.zeros((1, 16, 512, 8), dtype=torch.bfloat16))  # wider than a block
    assert not fast(torch.zeros((1, 16, 64, 17), dtype=torch.bfloat16))  # two channel groups
    assert not fast(torch.zeros((2, 16, 64, 9), dtype=torch.bfloat16)[:, :, :, 1:])  # offset rows
