"""UNet decoder over standard classification encoders (PyTorch port of
:mod:`sleap_tpu.models.pretrained_encoder`).

The encoder families the JAX package builds (VGG; ResNet, ResNeXt and their
squeeze-excite forms; MobileNet v1 and v2; EfficientNet b0-b7; DenseNet
121/169/201), each to stride 32 with a skip taken before every spatial
reduction, and the ``segmentation_models`` Unet "upsampling" decoder:
nearest 2x up -> concat skip -> (conv3x3 + BN + ReLU) x2 a block (layers
``decoder_stage{i}{a,b}``). Grayscale input is tiled to three channels.
Layer names, batch norm (``epsilon=1e-3``) and the encoder tables are the
JAX module's, kept here as copies.

``pretrained=True`` reads local weights only:
``$SLEAP_TPU_PRETRAINED_DIR/<encoder>.npz``, arrays keyed by ``/``-joined
flax paths (written by :mod:`sleap_tpu_torch.models.convert_pretrained` or
the JAX package's converter), merged into the flax variables tree that
:mod:`sleap_tpu_torch.models.params` carries into the module. With no such
file it warns and keeps the random init, as the JAX package does.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from sleap_tpu_torch.models.common import IntermediateFeature
from sleap_tpu_torch.models.encoder_decoder import (
    FlaxLayers,
    avg_pool_same,
    max_pool_same,
    upsample,
)

logger = logging.getLogger(__name__)

# (expand_ratio, filters_out, repeats, stride, kernel) per EfficientNet stage.
_EFFNET_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)
# (width_mult, depth_mult) per EfficientNet variant (Tan & Le 2019, Table 1).
_EFFNET_SCALING = {
    "efficientnetb0": (1.0, 1.0),
    "efficientnetb1": (1.0, 1.1),
    "efficientnetb2": (1.1, 1.2),
    "efficientnetb3": (1.2, 1.4),
    "efficientnetb4": (1.4, 1.8),
    "efficientnetb5": (1.6, 2.2),
    "efficientnetb6": (1.8, 2.6),
    "efficientnetb7": (2.0, 3.1),
}

# (expansion, channels, repeats, stride) per MobileNetV2 stage.
_MBV2_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# MobileNet v1 depthwise-separable stack: (pointwise filters, stride).
_MBV1_STAGES = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)

# ResNet-family specs: (block_counts, bottleneck, groups, base_width, se).
# The inner width of a bottleneck is int(f * base_width / 64) * groups
# (torchvision's ResNeXt rule); se adds squeeze-excite (ratio 16).
_RESNET_SPECS = {
    "resnet18": ((2, 2, 2, 2), False, 1, 64, False),
    "resnet34": ((3, 4, 6, 3), False, 1, 64, False),
    "resnet50": ((3, 4, 6, 3), True, 1, 64, False),
    "resnet101": ((3, 4, 23, 3), True, 1, 64, False),
    "resnet152": ((3, 8, 36, 3), True, 1, 64, False),
    "resnext50": ((3, 4, 6, 3), True, 32, 4, False),
    "resnext101": ((3, 4, 23, 3), True, 32, 8, False),
    "seresnet18": ((2, 2, 2, 2), False, 1, 64, True),
    "seresnet34": ((3, 4, 6, 3), False, 1, 64, True),
    "seresnet50": ((3, 4, 6, 3), True, 1, 64, True),
    "seresnet101": ((3, 4, 23, 3), True, 1, 64, True),
    "seresnet152": ((3, 8, 36, 3), True, 1, 64, True),
    "seresnext50": ((3, 4, 6, 3), True, 32, 4, True),
    "seresnext101": ((3, 4, 23, 3), True, 32, 4, True),
}

# VGG conv repeats per 5 stages.
_VGG_REPS = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}

# DenseNet dense-block layer counts.
_DENSENET_BLOCKS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}

AVAILABLE_ENCODERS = sorted(
    set(_RESNET_SPECS)
    | set(_VGG_REPS)
    | set(_DENSENET_BLOCKS)
    | set(_EFFNET_SCALING)
    | {"mobilenet", "mobilenetv2"}
)

# Names of the reference zoo with no rebuild: an error with a hint.
UNSUPPORTED_ENCODER_HINTS = {
    "inceptionv3": "resnet50",
    "inceptionresnetv2": "resnet50",
    "senet154": "seresnet152",
}


def _round_filters(filters: float, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(np.ceil(repeats * depth_mult))


def _se_gate(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(s)


def _spatial_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


class UnetPretrainedEncoderModule(FlaxLayers):
    """Encoder (max stride 32) + Unet upsampling decoder. ``forward`` returns
    ``([output], [features after each decoder block])``, the
    :class:`~sleap_tpu_torch.models.encoder_decoder.EncoderDecoderNet`
    contract. Built and run by one walk of :meth:`_graph`
    (:class:`~sleap_tpu_torch.models.encoder_decoder.FlaxLayers`)."""

    flax_name = "backbone_module"

    def __init__(self, encoder: str = "efficientnetb0",
                 decoder_filters: tuple = (256, 256, 128, 128),
                 decoder_batchnorm: bool = True, in_channels: int = 1):
        super().__init__()
        if encoder not in AVAILABLE_ENCODERS:
            raise ValueError(f"Unknown encoder {encoder!r}")
        self.encoder = encoder
        self.decoder_filters = tuple(decoder_filters)
        self.decoder_batchnorm = decoder_batchnorm
        self._build = True
        out, feats = self._graph(3 if in_channels == 1 else int(in_channels))
        self._build = False
        self.out_channels = out
        self.output_stride = 2 ** (5 - len(self.decoder_filters))
        self.feature_channels = {}
        for f in feats:
            self.feature_channels.setdefault(f.stride, f.tensor)

    def _conv_bn_act(self, x, name, f, k, s, act, groups=1, bn_name=None):
        x = self._conv_op(x, name, f, k, s, bias=False, groups=groups)
        return self._map(act, self._bn_op(x, bn_name or f"{name}_bn"))

    # -- encoders: each returns (x at stride 32, {stride: skip}) ---------- #
    def _vgg(self, x):
        skips, stride = {}, 1
        for si, (f, reps) in enumerate(zip((64, 128, 256, 512, 512), _VGG_REPS[self.encoder])):
            for ri in range(reps):
                x = self._map(F.relu, self._conv_op(x, f"block{si + 1}_conv{ri + 1}", f, 3))
            skips[stride] = x
            x = self._map(max_pool_same, x, 2)
            stride *= 2
        return x, skips

    def _se(self, x, name, reduced, act):
        """Squeeze-excite: mean -> 1x1 reduce -> act -> 1x1 expand -> gate."""
        s = self._map(_spatial_mean, x)
        s = self._map(act, self._conv_op(s, f"{name}_se_reduce", reduced, 1))
        s = self._conv_op(s, f"{name}_se_expand", self._width(x), 1)
        return self._map(_se_gate, x, s)

    def _resnet(self, x):
        blocks, bottleneck, groups, base_width, se = _RESNET_SPECS[self.encoder]
        x = self._conv_bn_act(x, "stem_conv", 64, 7, 2, F.relu, bn_name="stem_bn")
        skips = {2: x}
        x = self._map(max_pool_same, x, 2, 3)

        def block(x, f, s, name):
            if bottleneck:
                width = int(f * base_width / 64) * groups
                out = self._conv_bn_act(x, f"{name}_conv1", width, 1, s, F.relu, bn_name=f"{name}_bn1")
                out = self._conv_bn_act(out, f"{name}_conv2", width, 3, 1, F.relu, groups,
                                        bn_name=f"{name}_bn2")
                f_out = f * 4
                out = self._bn_op(self._conv_op(out, f"{name}_conv3", f_out, 1, bias=False),
                                  f"{name}_bn3")
            else:
                f_out = f
                out = self._conv_bn_act(x, f"{name}_conv1", f, 3, s, F.relu, bn_name=f"{name}_bn1")
                out = self._bn_op(self._conv_op(out, f"{name}_conv2", f, 3, bias=False),
                                  f"{name}_bn2")
            if se:
                out = self._se(out, name, max(1, self._width(out) // 16), F.relu)
            shortcut = x
            if s != 1 or self._width(x) != f_out:
                shortcut = self._bn_op(self._conv_op(x, f"{name}_proj", f_out, 1, s, bias=False),
                                       f"{name}_proj_bn")
            return self._map(lambda a, b: F.relu(a + b), out, shortcut)

        stride = 4
        for si, (f, nb) in enumerate(zip((64, 128, 256, 512), blocks)):
            s1 = 1 if si == 0 else 2
            if s1 == 2:
                skips[stride] = x
                stride *= 2
            for bi in range(nb):
                x = block(x, f, s1 if bi == 0 else 1, f"stage{si + 1}_block{bi + 1}")
        return x, skips

    def _mobilenetv1(self, x):
        x = self._conv_bn_act(x, "stem_conv", 32, 3, 2, F.relu6, bn_name="stem_bn")
        skips, stride = {}, 2
        for i, (f, s) in enumerate(_MBV1_STAGES):
            if s == 2:
                skips[stride] = x
                stride *= 2
            c = self._width(x)
            x = self._conv_bn_act(x, f"dw{i + 1}_dw", c, 3, s, F.relu6, groups=c)
            x = self._conv_bn_act(x, f"dw{i + 1}_pw", f, 1, 1, F.relu6)
        return x, skips

    def _inverted_residual(self, x, t, c, s, k, name, act, se):
        f_in = self._width(x)
        out = x
        if t != 1:
            out = self._conv_bn_act(out, f"{name}_expand", f_in * t, 1, 1, act)
        w = self._width(out)
        out = self._conv_bn_act(out, f"{name}_dw", w, k, s, act, groups=w)
        if se:
            out = self._se(out, name, max(1, int(f_in * 0.25)), F.silu)
        out = self._bn_op(self._conv_op(out, f"{name}_project", c, 1, bias=False),
                          f"{name}_project_bn")
        if s == 1 and f_in == c:
            out = self._map(torch.add, out, x)
        return out

    def _mobilenetv2(self, x):
        x = self._conv_bn_act(x, "stem_conv", 32, 3, 2, F.relu6, bn_name="stem_bn")
        skips, stride = {}, 2
        for si, (t, c, reps, s) in enumerate(_MBV2_STAGES):
            if s == 2:
                skips[stride] = x
                stride *= 2
            for ri in range(reps):
                x = self._inverted_residual(x, t, c, s if ri == 0 else 1, 3,
                                            f"block{si + 1}_{ri + 1}", F.relu6, False)
        x = self._conv_bn_act(x, "top_conv", 1280, 1, 1, F.relu6, bn_name="top_bn")
        return x, skips

    def _efficientnet(self, x):
        width_mult, depth_mult = _EFFNET_SCALING[self.encoder]
        x = self._conv_bn_act(x, "stem_conv", _round_filters(32, width_mult), 3, 2, F.silu,
                              bn_name="stem_bn")
        skips, stride = {}, 2
        for si, (t, c, reps, s, k) in enumerate(_EFFNET_STAGES):
            c = _round_filters(c, width_mult)
            if s == 2:
                skips[stride] = x
                stride *= 2
            for ri in range(_round_repeats(reps, depth_mult)):
                x = self._inverted_residual(x, t, c, s if ri == 0 else 1, k,
                                            f"block{si + 1}{chr(97 + ri)}", F.silu, True)
        x = self._conv_bn_act(x, "top_conv", _round_filters(1280, width_mult), 1, 1, F.silu,
                              bn_name="top_bn")
        return x, skips

    def _densenet(self, x):
        growth = 32
        x = self._conv_bn_act(x, "stem_conv", 64, 7, 2, F.relu, bn_name="stem_bn")
        skips = {2: x}
        x = self._map(max_pool_same, x, 2, 3)
        stride = 4
        for bi, n_layers in enumerate(_DENSENET_BLOCKS[self.encoder]):
            for li in range(n_layers):
                name = f"block{bi + 1}_layer{li + 1}"
                out = self._map(F.relu, self._bn_op(x, f"{name}_bn1"))
                out = self._conv_op(out, f"{name}_conv1", 4 * growth, 1, bias=False)
                out = self._map(F.relu, self._bn_op(out, f"{name}_bn2"))
                out = self._conv_op(out, f"{name}_conv2", growth, 3, bias=False)
                x = self._cat([x, out])
            if bi < 3:
                x = self._map(F.relu, self._bn_op(x, f"trans{bi + 1}_bn"))
                skips[stride] = x
                x = self._conv_op(x, f"trans{bi + 1}_conv", self._width(x) // 2, 1, bias=False)
                x = self._map(avg_pool_same, x, 2)
                stride *= 2
        x = self._map(F.relu, self._bn_op(x, "final_bn"))
        return x, skips

    def _graph(self, x):
        if not self._build and x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)  # grayscale tiled to RGB
        if self.encoder in _RESNET_SPECS:
            x, skips = self._resnet(x)
        elif self.encoder in _VGG_REPS:
            x, skips = self._vgg(x)
        elif self.encoder in _DENSENET_BLOCKS:
            x, skips = self._densenet(x)
        elif self.encoder in _EFFNET_SCALING:
            x, skips = self._efficientnet(x)
        elif self.encoder == "mobilenetv2":
            x, skips = self._mobilenetv2(x)
        else:
            x, skips = self._mobilenetv1(x)
        feats: List[IntermediateFeature] = []
        stride = 32
        for i, f in enumerate(self.decoder_filters):
            x = self._map(upsample, x, 2, "nearest")
            stride //= 2
            if stride in skips:
                x = self._cat([x, skips[stride]])
            for sub in ("a", "b"):
                x = self._conv_op(x, f"decoder_stage{i}{sub}_conv", f, 3,
                                  bias=not self.decoder_batchnorm)
                if self.decoder_batchnorm:
                    x = self._bn_op(x, f"decoder_stage{i}{sub}_bn")
                x = self._map(F.relu, x)
            feats.append(IntermediateFeature(x, stride))
        return x, feats

    def forward(self, x: torch.Tensor):
        out, feats = self._graph(x)
        return [out], [feats]


@dataclass(frozen=True)
class UnetPretrainedEncoder:
    """Backbone description (the JAX package's ``UnetPretrainedEncoder``):
    maximum stride 32, output stride ``2 ** (5 - len(decoder_filters))``.
    Its stem kernel has three input channels whatever the frames' (grayscale
    is tiled), so the checkpoint does not tell the input channels
    (``input_conv`` is None): the config's preprocessing does."""

    encoder: str = "efficientnetb0"
    decoder_filters: tuple = (256, 256, 128, 128)
    pretrained: bool = True
    decoder_batchnorm: bool = True
    stacks: int = 1
    input_conv = None

    @property
    def maximum_stride(self) -> int:
        return 32

    @property
    def output_stride(self) -> int:
        return int(2 ** (5 - len(self.decoder_filters)))

    def make_module(self, in_channels: int) -> UnetPretrainedEncoderModule:
        return UnetPretrainedEncoderModule(self.encoder, self.decoder_filters,
                                           self.decoder_batchnorm, in_channels)

    @classmethod
    def from_config(cls, config) -> "UnetPretrainedEncoder":
        """From a ``PretrainedEncoderConfig`` (either package's, read by
        attribute); an encoder without a rebuild raises the JAX package's
        ``ValueError``, word for word."""
        if config.encoder not in AVAILABLE_ENCODERS:
            hint = UNSUPPORTED_ENCODER_HINTS.get(config.encoder)
            if hint:
                raise ValueError(
                    f"Encoder {config.encoder!r} has no native flax rebuild; "
                    f"the nearest supported family is {hint!r} — update the "
                    "config's model.backbone.pretrained_encoder.encoder. "
                    "(Converted weights for supported families load via "
                    "sleap_tpu.models.convert_pretrained + "
                    "$SLEAP_TPU_PRETRAINED_DIR.)"
                )
            raise ValueError(
                f"Unsupported encoder {config.encoder!r}; available: "
                f"{AVAILABLE_ENCODERS}. (The reference's full zoo is in "
                "segmentation_models; these are the native flax rebuilds.)"
            )
        up_blocks = int(math.log2(32 // config.output_stride))
        decoder_filters = tuple(
            int(config.decoder_filters * (config.decoder_filters_rate**i))
            for i in range(up_blocks)
        )
        return cls(encoder=config.encoder, pretrained=config.pretrained,
                   decoder_filters=decoder_filters,
                   decoder_batchnorm=config.decoder_batchnorm)

    def init_weights_hook(self, variables: Dict[str, Any]) -> Dict[str, Any]:
        """Merge ``$SLEAP_TPU_PRETRAINED_DIR/<encoder>.npz`` into a flax
        variables tree (``{"params", "batch_stats"}``, numpy leaves) when
        ``pretrained``; with no such file, warn and return it unchanged."""
        if not self.pretrained:
            return variables
        root = os.environ.get("SLEAP_TPU_PRETRAINED_DIR", "")
        path = os.path.join(root, f"{self.encoder}.npz") if root else ""
        if not (path and os.path.exists(path)):
            logger.warning(
                "pretrained=True but no local weights found (%s); ImageNet "
                "downloads are unavailable offline — using random init. Set "
                "SLEAP_TPU_PRETRAINED_DIR to a folder of converted .npz weights.",
                path or "$SLEAP_TPU_PRETRAINED_DIR unset",
            )
            return variables
        return load_local_encoder_weights(variables, path)


def load_local_encoder_weights(variables: Dict[str, Any], npz_path: str) -> Dict[str, Any]:
    """A copy of a flax variables tree with the arrays of a local ``.npz``
    merged in. Names are ``/``-joined paths without the collection
    (``backbone_module/stem_conv/kernel``); ``params`` and ``batch_stats``
    leaves are both matched (their leaf names never collide). A name the
    file lacks keeps its value; a shape mismatch warns and keeps it."""
    arrays = np.load(npz_path)
    n_loaded = n_total = 0

    def merge(tree, prefix):
        nonlocal n_loaded, n_total
        out = {}
        for key, value in tree.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(value, dict):
                out[key] = merge(value, name)
                continue
            n_total += 1
            out[key] = value
            if name not in arrays.files:
                continue
            arr = arrays[name]
            if arr.shape != np.shape(value):
                logger.warning("Shape mismatch for %s: %s vs %s", name, arr.shape, np.shape(value))
                continue
            out[key] = arr.astype(np.asarray(value).dtype)
            n_loaded += 1
        return out

    merged = {col: merge(tree, "") if col in ("params", "batch_stats") else tree
              for col, tree in variables.items()}
    logger.info("Loaded %d/%d params from %s", n_loaded, n_total, npz_path)
    return merged
