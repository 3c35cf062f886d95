"""The port's backbones against the JAX package's: every family's forward on
seeded flax variables with non-trivial batch-norm statistics, the weight
bridge both ways, every pretrained-encoder name's parameter shapes, the
encoder errors, the local ``.npz`` weights and the torchvision converter,
and the flax-SAME layers each backbone is built from.

Variables come from numpy seeds: kernels N(0, 1/fan_in), biases N(0, 0.1²),
batch-norm scales U(0.5, 1.5), running means N(0, 0.1²) and running
variances U(0.5, 2), so the check sees batch norm at work (at 0 and 1 it
would be the identity). JAX runs at ``jax_default_matmul_precision=
"highest"``, jitted from ``jax.eval_shape``'s tree (no flax init), so no
case takes long. Tolerance: every head output within 1e-4 of the
reference's largest absolute value (f32 convs sum in another order in each
framework, through up to ~150 layers).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_tpu import config as jc
from sleap_tpu.models import convert_pretrained as jax_convert
from sleap_tpu.models import pretrained_encoder as jax_pe
from sleap_tpu.models.model import Model as JaxModel
from sleap_tpu_torch import config as tc
from sleap_tpu_torch.models import convert_pretrained as torch_convert
from sleap_tpu_torch.models import encoder_decoder as ted
from sleap_tpu_torch.models import pretrained_encoder as torch_pe
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import (
    flax_variables_from_state_dict,
    state_dict_from_flax,
)

torch.set_num_threads(2)
REL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    """Full-f32 matmuls and convs on the JAX side, for this file only."""
    with jax.default_matmul_precision("highest"):
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_variables(shapes, seed=0):
    """Numpy flax variables of ``shapes`` (an ``eval_shape`` tree)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=s.shape) / math.sqrt(math.prod(s.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _model_config(backbone, heads):
    return jc.ModelConfig(backbone=jc.BackboneConfig(**backbone), heads=jc.HeadsConfig(**heads))


def _single(stride):
    return {"single_instance": jc.SingleInstanceConfmapsHeadConfig(
        part_names=["a", "b", "c"], output_stride=stride)}


def _bottomup(stride, paf_stride):
    return {"multi_instance": jc.MultiInstanceConfig(
        confmaps=jc.MultiInstanceConfmapsHeadConfig(part_names=["a", "b", "c"],
                                                    output_stride=stride),
        pafs=jc.PartAffinityFieldsHeadConfig(edges=[("a", "b"), ("b", "c")],
                                             output_stride=paf_stride))}


def _pe(encoder, **kw):
    kw = {"pretrained": False, "decoder_filters": 8, "output_stride": 4, **kw}
    return {"pretrained_encoder": jc.PretrainedEncoderConfig(encoder=encoder, **kw)}


def _resnet(**kw):
    return {"resnet": jc.ResNetConfig(weights="random", **kw)}


# name -> (backbone, heads, input size, channels)
CASES = {
    "leap": ({"leap": jc.LEAPConfig(max_stride=8, output_stride=2, filters=8)}, _single(2), 64, 1),
    "leap_interp": ({"leap": jc.LEAPConfig(max_stride=8, output_stride=1, filters=8,
                                            up_interpolate=True)}, _single(1), 48, 1),
    "hourglass_2stack": ({"hourglass": jc.HourglassConfig(
        stem_stride=4, max_stride=32, output_stride=4, stem_filters=8, filters=8,
        filter_increase=4, stacks=2)}, _single(4), 64, 1),
    "hourglass_rgb_os8": ({"hourglass": jc.HourglassConfig(
        stem_stride=2, max_stride=16, output_stride=8, stem_filters=4, filters=8,
        filter_increase=8, stacks=1)}, _single(8), 48, 3),
    # default upsampling: transposed 4x4 ups with BN, no skips; max stride 16
    # dilates the last stage; PAFs on an intermediate decoder feature.
    "resnet50_transposed": (_resnet(max_stride=16, output_stride=4), _bottomup(4, 8), 64, 1),
    "resnet50_bilinear_concat": (_resnet(max_stride=32, output_stride=4, upsampling=jc.UpsamplingConfig(
        method="interpolation", skip_connections="concatenate", filters=16)), _single(4), 64, 1),
    "resnet50_transposed_add": (_resnet(max_stride=32, output_stride=2, upsampling=jc.UpsamplingConfig(
        method="transposed_conv", skip_connections="add", filters=64, batch_norm=False)),
        _single(2), 64, 3),
    "resnet101_bilinear_add": (_resnet(version="ResNet101", max_stride=8, output_stride=4,
                                       upsampling=jc.UpsamplingConfig(
        method="interpolation", skip_connections="add", filters=16, refine_convs=1)),
        _single(4), 40, 1),
    "hrnet": ({"hrnet": jc.HRNetConfig(C=4, stem_filters=8, deconv_filters=8)}, _single(2), 32, 1),
    "hrnet_bottleneck_bilinear": ({"hrnet": jc.HRNetConfig(
        C=4, stem_filters=8, bottleneck=True, bilinear_upsampling=True)}, _single(2), 32, 1),
    "vgg16": (_pe("vgg16"), _single(4), 64, 1),
    "vgg16_no_decoder_bn": (_pe("vgg16", decoder_batchnorm=False, output_stride=2), _single(2), 64, 3),
    "resnet18": (_pe("resnet18"), _single(4), 64, 1),
    "resnext50": (_pe("resnext50"), _single(4), 64, 1),
    "seresnet18": (_pe("seresnet18"), _single(4), 64, 3),
    "mobilenet": (_pe("mobilenet"), _single(4), 64, 1),
    "mobilenetv2": (_pe("mobilenetv2"), _single(4), 64, 1),
    "efficientnetb0": (_pe("efficientnetb0"), _single(4), 64, 1),
    "efficientnetb0_odd": (_pe("efficientnetb0", output_stride=8, decoder_filters_rate=0.5),
                           _single(8), 96, 1),
    "densenet121": (_pe("densenet121"), _single(4), 64, 1),
}


def _jax_forward(case, seed=0):
    backbone, heads, hw, c = CASES[case]
    cfg = _model_config(backbone, heads)
    module = JaxModel.from_config(cfg).make_flax_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, c)), train=False))
    variables = seeded_variables(shapes, seed)
    x = np.random.default_rng(seed + 1).uniform(0, 1, (2, hw, hw, c)).astype(np.float32)
    out = jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x))
    return cfg, variables, x, _np_tree(out)


def _port_module(cfg, variables, c, device="cpu"):
    net = Model.from_config(cfg).make_module(c)
    net.load_state_dict(state_dict_from_flax(net, variables))
    return net.to(device).eval()


@pytest.mark.parametrize("case", list(CASES))
def test_backbone_forward_matches_jax(case):
    cfg, variables, x, want = _jax_forward(case)
    net = _port_module(cfg, variables, CASES[case][3])
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert set(got) == set(want)
    for key, ref in want.items():
        out = got[key].numpy()
        assert out.shape == ref.shape, key
        scale = float(np.abs(ref).max())
        assert scale > 0, key
        assert float(np.abs(out - ref).max()) <= REL_TOL * scale, key


def test_stacked_heads_keep_their_stack_names():
    """Every stack of a stacked net gets the heads, ``_stack{i}`` on all but
    the last, and ``find_head`` picks the last stack's."""
    from sleap_tpu_torch.models.model import find_head

    cfg, variables, x, _ = _jax_forward("hourglass_2stack")
    with torch.no_grad():
        got = _port_module(cfg, variables, 1)(torch.from_numpy(x))
    assert list(got) == ["SingleInstanceConfmapsHead_stack0", "SingleInstanceConfmapsHead"]
    assert find_head(got, "SingleInstanceConfmapsHead") == "SingleInstanceConfmapsHead"
    assert not torch.equal(got["SingleInstanceConfmapsHead_stack0"], got["SingleInstanceConfmapsHead"])


@pytest.mark.parametrize("case", list(CASES))
def test_flax_variables_round_trip(case):
    """``flax_variables_from_state_dict(state_dict_from_flax(v)) == v``,
    batch statistics included, bitwise."""
    backbone, heads, hw, c = CASES[case]
    cfg = _model_config(backbone, heads)
    module = JaxModel.from_config(cfg).make_flax_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, c)), train=False))
    v = seeded_variables(shapes, seed=3)
    net = Model.from_config(cfg).make_module(c)
    net.load_state_dict(state_dict_from_flax(net, v))
    back = flax_variables_from_state_dict(net)
    got = _flat(back)
    want = _flat({"params": v["params"], "batch_stats": v.get("batch_stats", {})})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------------- #
# Every pretrained-encoder name: the parameter tree's shapes
# --------------------------------------------------------------------------- #


def _port_shapes(net):
    """The flax variables' shapes a torch module would give, without data
    (the module may live on the meta device)."""
    from torch import nn

    out = {}
    bname = net.backbone.flax_name
    for key, value in net.state_dict().items():
        mod_path, _, pname = key.rpartition(".")
        lname = mod_path.rsplit(".", 1)[-1]
        layer = net.get_submodule(mod_path)
        shape = tuple(value.shape)
        if isinstance(layer, ted.FlaxBatchNorm2d):
            col, leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                         "running_mean": ("batch_stats", "mean"),
                         "running_var": ("batch_stats", "var")}[pname]
        else:
            col, leaf = "params", {"weight": "kernel", "bias": "bias"}[pname]
            if pname == "weight":
                if isinstance(layer, nn.Linear):
                    shape = shape[::-1]
                elif isinstance(layer, ted.ConvTransposeSame):
                    shape = (shape[2], shape[3], shape[0], shape[1])
                else:
                    shape = (shape[2], shape[3], shape[1], shape[0])
        prefix = (bname,) if mod_path.startswith("backbone.") else ()
        out[(col, *prefix, lname, leaf)] = shape
    return out


@pytest.mark.parametrize("encoder", jax_pe.AVAILABLE_ENCODERS)
def test_every_encoder_builds_the_jax_parameter_shapes(encoder):
    assert torch_pe.AVAILABLE_ENCODERS == jax_pe.AVAILABLE_ENCODERS
    cfg = _model_config(_pe(encoder), _single(4))
    module = JaxModel.from_config(cfg).make_flax_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))
    want = {tuple(k.key for k in p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):
        net = Model.from_config(cfg).make_module(1)
    assert _port_shapes(net) == want
    assert net.backbone.output_stride == 4 and net.backbone.out_channels == 8


def test_encoder_tables_match_jax():
    for name in ("_EFFNET_STAGES", "_EFFNET_SCALING", "_MBV2_STAGES", "_MBV1_STAGES",
                 "_RESNET_SPECS", "_VGG_REPS", "_DENSENET_BLOCKS", "UNSUPPORTED_ENCODER_HINTS"):
        assert getattr(torch_pe, name) == getattr(jax_pe, name), name
    for f in (3, 16, 32, 112, 320, 1280):
        for w in (1.0, 1.1, 1.2, 1.4, 1.6, 1.8, 2.0):
            assert torch_pe._round_filters(f, w) == jax_pe._round_filters(f, w)
    for r in (1, 2, 3, 4):
        for d in (1.0, 1.1, 2.2, 3.1):
            assert torch_pe._round_repeats(r, d) == jax_pe._round_repeats(r, d)


@pytest.mark.parametrize("encoder", ["inceptionv3", "inceptionresnetv2", "senet154", "alexnet"])
def test_unsupported_encoder_errors_match_jax(encoder):
    def message(cls, config_cls):
        with pytest.raises(ValueError) as info:
            cls.from_config(config_cls(encoder=encoder, output_stride=4))
        return str(info.value)

    got = message(torch_pe.UnetPretrainedEncoder, tc.PretrainedEncoderConfig)
    assert got == message(jax_pe.UnetPretrainedEncoder, jc.PretrainedEncoderConfig)
    hint = torch_pe.UNSUPPORTED_ENCODER_HINTS.get(encoder)
    assert (hint in got) if hint else ("available" in got)


def test_resnet_pretrained_weights_raise_as_in_jax():
    from sleap_tpu.models.resnet import ResNet as JaxResNet
    from sleap_tpu_torch.models.resnet import ResNet

    for weights in ("frozen", "tunable"):
        with pytest.raises(NotImplementedError) as want:
            JaxResNet.from_config(jc.ResNetConfig(weights=weights))
        with pytest.raises(NotImplementedError) as got:
            ResNet.from_config(tc.ResNetConfig(weights=weights))
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# Local pretrained weights and the torchvision converter
# --------------------------------------------------------------------------- #


def _flat(tree):
    return {"/".join(str(k.key) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_local_npz_weights_load_alike(tmp_path, monkeypatch, caplog):
    cfg, variables, x, _ = _jax_forward("resnet18")
    rng = np.random.default_rng(7)
    arrays = {}
    for col in ("params", "batch_stats"):
        for name, a in _flat(variables[col]).items():
            if "/stem_" in name or "/stage1_" in name:
                arrays[name] = rng.normal(size=a.shape).astype(np.float32) * 0.1 + (
                    1.0 if name.endswith(("/scale", "/var")) else 0.0)
    arrays["backbone_module/stage2_block1_conv1/kernel"] = np.zeros((1, 2, 3), np.float32)
    arrays["backbone_module/not_a_layer/kernel"] = np.ones(3, np.float32)
    np.savez(tmp_path / "resnet18.npz", **arrays)
    monkeypatch.setenv("SLEAP_TPU_PRETRAINED_DIR", str(tmp_path))

    want = jax_pe.UnetPretrainedEncoder(encoder="resnet18", decoder_filters=(8,) * 3,
                                        pretrained=True).init_weights_hook(
        jax.tree_util.tree_map(jnp.asarray, variables))
    got = torch_pe.UnetPretrainedEncoder(encoder="resnet18", decoder_filters=(8,) * 3,
                                         pretrained=True).init_weights_hook(variables)
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=k)
    n_loaded = sum(not np.array_equal(flat_got[k], a) for k, a in _flat(variables).items())
    assert n_loaded == len(arrays) - 2  # the misshapen and the unknown entries are skipped

    module = JaxModel.from_config(cfg).make_flax_module()
    ref = _np_tree(jax.jit(lambda v, x: module.apply(v, x, train=False))(want, jnp.asarray(x)))
    with torch.no_grad():
        out = _port_module(cfg, got, 1)(torch.from_numpy(x))
    for key, a in ref.items():
        assert float(np.abs(out[key].numpy() - a).max()) <= REL_TOL * float(np.abs(a).max())

    monkeypatch.setenv("SLEAP_TPU_PRETRAINED_DIR", str(tmp_path / "empty"))
    with caplog.at_level("WARNING"):
        same = torch_pe.UnetPretrainedEncoder(encoder="resnet18",
                                              pretrained=True).init_weights_hook(variables)
    assert same is variables and "no local weights" in caplog.text


@pytest.mark.parametrize("encoder", ["resnet18", "resnext50_32x4d", "vgg16", "mobilenet_v2",
                                     "densenet121", "efficientnet_b0"])
def test_convert_pretrained_writes_the_jax_arrays(encoder, tmp_path):
    name = jax_convert._ALIASES.get(encoder, encoder)
    cfg = _model_config(_pe(name), _single(4))
    module = JaxModel.from_config(cfg).make_flax_module()
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)), train=False))
    flax_shapes = {"/".join(str(k.key) for k in p[1:]): tuple(a.shape)
                   for p, a in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    rng = np.random.default_rng(0)
    state = {}
    for flax_name, torch_key, transform in jax_convert._MAPPERS[name]():
        s = flax_shapes[f"backbone_module/{flax_name}"]
        if transform is not None:  # HWIO -> torchvision's OIHW
            s = (s[3], s[2], s[0], s[1])
        state[torch_key] = torch.from_numpy(rng.normal(size=s).astype(np.float32))
    got = torch_convert.convert_torchvision_state_dict(state, encoder)
    want = jax_convert.convert_torchvision_state_dict(state, encoder)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    path = tmp_path / "ckpt.pth"
    torch.save(state, path)
    out = torch_convert.convert_checkpoint(str(path), encoder, str(tmp_path / "out"))
    assert out.endswith(f"{name}.npz")
    with np.load(out) as z:
        assert sorted(z.files) == sorted(want)
    state.pop(next(iter(state)))
    with pytest.raises(KeyError):
        torch_convert.convert_torchvision_state_dict(state, encoder)


# --------------------------------------------------------------------------- #
# The flax-SAME layers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("size", [15, 16])
@pytest.mark.parametrize("kernel,stride,dilation,groups", [
    (3, 1, 1, 1), (3, 2, 1, 1), (7, 2, 1, 1), (1, 2, 1, 1), (3, 1, 2, 1), (5, 2, 1, 4), (3, 1, 1, 2),
])
def test_conv_same_matches_flax(size, kernel, stride, dilation, groups):
    """Odd and even sizes, strided (asymmetric pads), dilated and grouped:
    groups > 1 with several outputs a group pins flax's group-major order."""
    import flax.linen as nn

    cin, cout = 4, 8
    conv = nn.Conv(cout, (kernel, kernel), strides=(stride, stride), padding="SAME",
                   kernel_dilation=(dilation, dilation), feature_group_count=groups)
    x = np.random.default_rng(0).normal(size=(2, size, size, cin)).astype(np.float32)
    v = seeded_variables(jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), x)))
    want = np.asarray(conv.apply(v, x))
    layer = ted.Conv2dSame(cin, cout, kernel, stride=stride, dilation=dilation, groups=groups)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(v["params"]["kernel"].transpose(3, 2, 0, 1).copy()))
        layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [5, 8])
@pytest.mark.parametrize("kernel", [3, 4])
def test_conv_transpose_same_matches_flax(size, kernel):
    import flax.linen as nn

    conv = nn.ConvTranspose(6, (kernel, kernel), strides=(2, 2), padding="SAME")
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(np.float32)
    v = seeded_variables(jax.eval_shape(lambda: conv.init(jax.random.PRNGKey(0), x)))
    want = np.asarray(conv.apply(v, x))
    layer = ted.ConvTransposeSame(3, 6, kernel, 2)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(v["params"]["kernel"][::-1, ::-1].transpose(2, 3, 0, 1).copy()))
        layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2 * size, 2 * size, 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("pool,stride", [(2, 2), (3, 2), (2, 1)])
def test_pools_match_flax(size, pool, stride):
    import flax.linen as nn

    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for theirs, ours in ((nn.max_pool, ted.max_pool_same), (nn.avg_pool, ted.avg_pool_same)):
        want = np.asarray(theirs(x, (pool, pool), strides=(stride, stride), padding="SAME"))
        got = ours(xt, stride, pool).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_batch_norm_matches_flax():
    """``FlaxBatchNorm2d`` against ``flax.linen.BatchNorm`` at both packages'
    settings: in eval mode on the running statistics; in train mode the
    output, the updated ``batch_stats`` and the gradients of an upstream
    gradient with respect to the input, scale and bias; float32 within
    1e-5, and a bf16 input, whose output is bf16 while the statistics stay
    float32, within one bf16 ulp."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 5, 6)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    for eps, momentum in ((1e-3, 0.99), (1e-5, 0.9)):
        for train, dtype in ((False, np.float32), (True, np.float32), (False, "bfloat16"),
                             (True, "bfloat16")):
            bf16 = dtype == "bfloat16"
            xin = jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x)
            bn = nn.BatchNorm(use_running_average=not train, epsilon=eps, momentum=momentum,
                              dtype=jnp.bfloat16 if bf16 else None)
            v = seeded_variables(jax.eval_shape(lambda: bn.init(jax.random.PRNGKey(0), x)))

            def apply(x, scale, bias):
                y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                                   "batch_stats": v["batch_stats"]}, x, mutable=["batch_stats"])
                return (y.astype(jnp.float32) * g).sum(), (y, upd["batch_stats"])

            (_, (want, stats)), grads = jax.value_and_grad(apply, argnums=(0, 1, 2), has_aux=True)(
                xin, v["params"]["scale"], v["params"]["bias"])
            layer = ted.FlaxBatchNorm2d(6, eps, momentum)
            if bf16:
                layer.to(torch.bfloat16)  # the parameters and statistics stay float32
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(v["params"]["scale"]))
                layer.bias.copy_(torch.from_numpy(v["params"]["bias"]))
                layer.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
                layer.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
            assert all(t.dtype == torch.float32 for t in (*layer.parameters(), *layer.buffers()))
            xt = torch.from_numpy(x).permute(0, 3, 1, 2)
            xt = (xt.bfloat16() if bf16 else xt).requires_grad_()
            out = layer.train(train)(xt)
            (out.float() * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
            got = out.permute(0, 2, 3, 1)
            assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
            want = np.asarray(want.astype(jnp.float32))
            tol = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7) if bf16 else 1e-5
            np.testing.assert_allclose(got.float().detach().numpy(), want, atol=tol, rtol=0)
            np.testing.assert_allclose(layer.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=0)
            np.testing.assert_allclose(layer.running_var.numpy(), stats["var"], atol=1e-6, rtol=0)
            if train and not bf16:
                for ours, theirs in ((xt.grad.permute(0, 2, 3, 1), grads[0]),
                                     (layer.weight.grad, grads[1]), (layer.bias.grad, grads[2])):
                    theirs = np.asarray(theirs)
                    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                               atol=1e-5 * np.abs(theirs).max())


def test_stacked_nets_need_symmetric_encoder_and_decoder():
    from sleap_tpu_torch.models.hourglass import Hourglass

    hg = Hourglass(down_blocks=3, up_blocks=2, stem_filters=4, filters=4, filter_increase=4,
                   stacks=2)
    with pytest.raises(ValueError, match="symmetric encoder and decoder"):
        ted.EncoderDecoderNet(hg.make_stem_blocks(), hg.make_encoder_blocks(),
                              hg.make_decoder_blocks(), in_channels=1, stacks=2)


@pytest.mark.parametrize("name", ["leap", "hourglass", "resnet", "hrnet"])
def test_backbone_descriptors_match_jax(name):
    """The block-stack descriptors equal the JAX package's tuples, and every
    description its strides."""
    from sleap_tpu.models import hourglass as jhg, hrnet as jhr, leap as jleap, resnet as jrn
    from sleap_tpu_torch.models import hourglass as thg, hrnet as thr, leap as tleap, resnet as trn

    if name == "leap":
        cfgs = [jc.LEAPConfig(), jc.LEAPConfig(max_stride=16, output_stride=4, up_interpolate=True)]
        pairs = [(jleap.LeapCNN.from_config(c), tleap.LeapCNN.from_config(c)) for c in cfgs]
    elif name == "hourglass":
        cfgs = [jc.HourglassConfig(), jc.HourglassConfig(stem_stride=2, max_stride=32, stacks=1)]
        pairs = [(jhg.Hourglass.from_config(c), thg.Hourglass.from_config(c)) for c in cfgs]
    elif name == "resnet":
        cfgs = [jc.ResNetConfig(weights="random"),
                jc.ResNetConfig(weights="random", version="ResNet152", max_stride=16,
                                upsampling=jc.UpsamplingConfig(filters=32, filters_rate=2))]
        pairs = [(jrn.ResNet.from_config(c), trn.ResNet.from_config(c)) for c in cfgs]
        for a, b in pairs:
            assert b.up_blocks_spec() == a.up_blocks_spec()
    else:
        cfgs = [jc.HRNetConfig(), jc.HRNetConfig(initial_downsampling_steps=3, n_deconv_modules=2)]
        pairs = [(jhr.HigherHRNet.from_config(c), thr.HigherHRNet.from_config(c)) for c in cfgs]
    for a, b in pairs:
        assert (b.maximum_stride, b.output_stride) == (a.maximum_stride, a.output_stride)
        if hasattr(a, "make_encoder_blocks"):
            assert b.make_stem_blocks() == a.make_stem_blocks()
            assert b.make_encoder_blocks() == a.make_encoder_blocks()
            assert b.make_decoder_blocks() == a.make_decoder_blocks()


def test_keras_batch_norm_weights_load_as_flax():
    """Keras names batch norm's weights ``gamma``/``beta``/``moving_mean``/
    ``moving_variance`` beside its conv kernels (HWIO, as flax): the same
    weights in Keras form give the flax form's ``state_dict``."""
    from sleap_tpu_torch.models.params import state_dict_from_keras

    cfg, variables, _, _ = _jax_forward("hourglass_rgb_os8")
    keras = {}
    for col, tree in (("params", variables["params"]), ("batch_stats", variables["batch_stats"])):
        layers = {**tree.get("backbone", {}), **{k: v for k, v in tree.items() if k != "backbone"}}
        for lname, leaves in layers.items():
            for leaf, a in leaves.items():
                name = {"scale": "gamma", "bias": "beta" if "_bn" in lname else "bias",
                        "mean": "moving_mean", "var": "moving_variance"}.get(leaf, leaf)
                keras.setdefault(lname, {})[name] = a
    net = Model.from_config(cfg).make_module(3)
    want = state_dict_from_flax(net, variables)
    got = state_dict_from_keras(net, keras)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
