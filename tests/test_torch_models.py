"""The PyTorch port's models against the JAX package's: descriptors, forward
parity on seeded weights, the ConvTranspose mapping and the weight bridge."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu.config import (
    BackboneConfig,
    CentroidsHeadConfig,
    HeadsConfig,
    ModelConfig,
    TrainingJobConfig,
    UNetConfig,
)
from sleap_tpu.models import unet as jax_unet
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu_torch.models import encoder_decoder as torch_ed
from sleap_tpu_torch.models import unet as torch_unet
from sleap_tpu_torch.models.model import Model, PoseNet, HeadSpec
from sleap_tpu_torch.models.params import state_dict_from_flax, state_dict_from_keras

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield

RUNS = Path(__file__).resolve().parent.parent / ".convergence_runs"
BENCH_UNET = dict(
    max_stride=16, output_stride=4, filters=64, filters_rate=2.0,
    up_interpolate=True, space_to_depth=4,
)


def _unet_config(name):
    if name == "bench":
        return UNetConfig(**BENCH_UNET)
    return TrainingJobConfig.load_json(str(RUNS / name)).model.backbone.unet


@pytest.mark.parametrize(
    "name",
    [
        "minimal_instance.UNet.centroid",
        "minimal_instance.UNet.centered_instance",
        "minimal_robot.UNet.single_instance",
        "bench",
    ],
)
def test_unet_descriptors_match_jax(name):
    cfg = _unet_config(name)
    a = jax_unet.UNet.from_config(cfg)
    b = torch_unet.UNet.from_config(cfg)
    assert b.make_stem_blocks() == a.make_stem_blocks()
    assert b.make_encoder_blocks() == a.make_encoder_blocks()
    assert b.make_decoder_blocks() == a.make_decoder_blocks()
    assert (b.maximum_stride, b.output_stride) == (a.maximum_stride, a.output_stride)


def test_descriptor_factories_match_jax():
    from sleap_tpu.models import encoder_decoder as jax_ed

    for name in ("SimpleConvBlock", "PoolingBlock", "StemBlock", "DownsamplingBlock",
                 "SpaceToDepthBlock", "SimpleUpsamplingBlock", "HourglassUpsamplingBlock"):
        assert getattr(torch_ed, name)() == getattr(jax_ed, name)(), name
    for blk in jax_unet.UNet(space_to_depth=4, stem_blocks=1).make_stem_blocks():
        assert torch_ed.block_pool(blk) == jax_ed.block_pool(blk)
        assert torch_ed.block_pooling_stride(blk) == jax_ed.block_pooling_stride(blk)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_and_torch(unet_kwargs, in_channels, offsets=True, seed=0):
    """A JAX PoseNet with seeded params and the port's module loaded from them."""
    heads = HeadsConfig(
        centroid=CentroidsHeadConfig(output_stride=unet_kwargs["output_stride"],
                                     offset_refinement=offsets)
    )
    cfg = ModelConfig(backbone=BackboneConfig(unet=UNetConfig(**unet_kwargs)), heads=heads)
    jmodel = JaxModel.from_config(cfg)
    hw = 4 * jmodel.maximum_stride
    module, variables = jmodel.init(jax.random.PRNGKey(seed), (hw, hw, in_channels))
    tmodel = Model.from_config(cfg)
    tmod = tmodel.make_module(in_channels)
    tmod.load_state_dict(state_dict_from_flax(tmod, _np_tree(variables["params"])))
    return module, variables, tmod.eval()


@pytest.mark.parametrize(
    "up_interpolate,s2d,channels,dtype",
    [
        (True, 4, 3, np.uint8),
        (False, 4, 1, np.float32),
        (True, 1, 1, np.uint8),
        (False, 1, 3, np.float32),
    ],
)
def test_forward_parity(up_interpolate, s2d, channels, dtype):
    kw = dict(max_stride=16, output_stride=4, filters=8, filters_rate=2.0,
              up_interpolate=up_interpolate, space_to_depth=s2d)
    module, variables, tmod = _jax_and_torch(kw, channels)
    rng = np.random.default_rng(1)
    if dtype == np.uint8:
        x = rng.integers(0, 256, (2, 64, 48, channels), np.uint8)
    else:
        x = rng.uniform(0, 1, (2, 64, 48, channels)).astype(np.float32)
    want = module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel,stride", [(3, 2), (4, 2), (2, 2)])
def test_conv_transpose_mapping(kernel, stride):
    """flax ConvTranspose(SAME) == conv_transpose2d with the flipped kernel,
    cropped at k - 1 - pad_before."""
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    layer = nn.ConvTranspose(4, (kernel, kernel), strides=(stride, stride), padding="SAME")
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(layer.apply(variables, jnp.asarray(x)))
    k = np.asarray(variables["params"]["kernel"])
    tl = torch_ed.ConvTransposeSame(3, 4, kernel, stride)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))))
        tl.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        got = tl(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _small_params():
    kw = dict(max_stride=8, output_stride=4, filters=4, filters_rate=1.5, up_interpolate=False)
    _, variables, tmod = _jax_and_torch(kw, 1)
    return _np_tree(variables["params"]), tmod


def test_bridge_keras_layout_matches_flax():
    params, tmod = _small_params()
    keras = {}
    for name, ws in list(params["backbone"].items()) + [
        (k, v) for k, v in params.items() if k != "backbone"
    ]:
        ws = dict(ws)
        if "trans_conv" in name:  # flax HWIO, flipped <- Keras (kh, kw, out, in)
            ws["kernel"] = ws["kernel"][::-1, ::-1].transpose(0, 1, 3, 2)
        keras[name] = ws
    a = state_dict_from_flax(tmod, params)
    b = state_dict_from_keras(tmod, keras)
    assert set(a) == set(b)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_bridge_raises_on_wrong_shape_leftover_and_missing():
    params, tmod = _small_params()
    bad = copy.deepcopy(params)
    bad["backbone"]["stack0_enc0_conv0"]["kernel"] = np.zeros((3, 3, 2, 4), np.float32)
    with pytest.raises(ValueError, match="Shape mismatch"):
        state_dict_from_flax(tmod, bad)

    extra = dict(params)
    extra["Unused"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="not used"):
        state_dict_from_flax(tmod, extra)

    missing = dict(params)
    missing["backbone"] = {k: v for k, v in params["backbone"].items() if k != "stack0_enc0_conv1"}
    with pytest.raises(KeyError, match="stack0_enc0_conv1"):
        state_dict_from_flax(tmod, missing)


def test_head_at_decoder_intermediate_stride():
    """A head whose stride is not the backbone's attaches to the decoder
    feature recorded at that stride, as apply_heads does."""
    u = torch_unet.UNet(filters=4, down_blocks=3, up_blocks=2)
    net = PoseNet(u, [HeadSpec("A", 2, "linear", 2), HeadSpec("B", 3, "linear", 4)], 1)
    out = net(torch.zeros(1, 32, 32, 1))
    assert out["A"].shape == (1, 16, 16, 2)
    assert out["B"].shape == (1, 8, 8, 3)
