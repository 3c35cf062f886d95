"""The port's preprocessing (normalization, resizing, padding) against the
JAX package's on the same seeded images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.data import normalization as jn
from sleap_tpu.data import resizing as jr
from sleap_tpu.inference import predictors as jp
from sleap_tpu_torch.data import normalization as tn
from sleap_tpu_torch.data import resizing as tr
from sleap_tpu_torch.inference import predictors as tp

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
RGB_U8 = RNG.integers(0, 256, (2, 37, 53, 3), np.uint8)
RGB_F32 = RNG.uniform(0, 1, (2, 37, 53, 3)).astype(np.float32)


def _same(got, want, atol=0.0):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=atol, rtol=0)


@pytest.mark.parametrize("image", [RGB_U8, RGB_F32, RGB_U8[..., :1]], ids=["u8", "f32", "gray"])
def test_grayscale_rgb_float(image):
    # uint8 luma is rounded: the weighted sum may differ by an ulp, so allow
    # a step of 1 only where the sum sits on a .5 boundary (never here).
    _same(tn.ensure_grayscale(torch.from_numpy(image)), jn.ensure_grayscale(jnp.asarray(image)), 1e-6)
    _same(tn.ensure_rgb(torch.from_numpy(image)), jn.ensure_rgb(jnp.asarray(image)))
    _same(tn.ensure_float(torch.from_numpy(image)), jn.ensure_float(jnp.asarray(image)), 1e-7)


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch"])
def test_imagenet_modes(mode):
    _same(tn.apply_imagenet_mode(torch.from_numpy(RGB_F32), mode),
          jn.apply_imagenet_mode(jnp.asarray(RGB_F32), mode), 1e-5)


@pytest.mark.parametrize("mode", ["tf", "caffe", "torch"])
def test_scale_to_imagenet_functions(mode):
    name = f"scale_to_imagenet_{mode}_mode"
    _same(getattr(tn, name)(torch.from_numpy(RGB_F32)), getattr(jn, name)(jnp.asarray(RGB_F32)), 1e-5)


@pytest.mark.parametrize("scale", [0.5, 0.3, [0.25, 0.75], 2.0])
@pytest.mark.parametrize("image", [RGB_U8, RGB_F32], ids=["u8", "f32"])
def test_resize_image(image, scale):
    """Truncated sizes, no antialias, float results within 2e-4 (1e-6 of the
    255 pixel range: the two frameworks weight the taps in another order);
    integer images are truncated back, so they may differ by one level only
    where the float result lies within 2e-4 of an integer."""
    got = tr.resize_image(torch.from_numpy(image), scale)
    want = jr.resize_image(jnp.asarray(image), scale)
    got_f = tr.resize_image(torch.from_numpy(image).float(), scale)
    want_f = np.asarray(jr.resize_image(jnp.asarray(image, jnp.float32), scale))
    _same(got_f, want_f, 2e-4)
    assert got.dtype == torch.from_numpy(image).dtype and got.shape == want.shape
    differ = got.numpy() != np.asarray(want)
    if image.dtype == np.uint8:
        near = want_f[differ]
        assert np.all(np.abs(near - np.round(near)) < 2e-4)
    else:
        _same(got, want, 1e-5)


def test_pad_to_stride_and_preprocess():
    _same(tr.pad_to_stride(torch.from_numpy(RGB_U8), 16), jr.pad_to_stride(jnp.asarray(RGB_U8), 16))
    got = tp._preprocess(torch.from_numpy(RGB_U8), True, 0.5, 8)
    want = jp._preprocess(jnp.asarray(RGB_U8), True, 0.5, 8)
    _same(got, want, 1e-5)
