"""ResNetV1 backbone with an upsampling-stack decoder (PyTorch).

Port of :mod:`sleap_tpu.models.resnet`: the bottleneck ResNetV1 encoder
(stride on the first 1x1 conv of a stage, Keras applications' v1), whose
strided stages past ``max_stride`` become dilated convolutions, and the
decoder of transposed-conv or bilinear 2x ups with added or concatenated
skips and refine convs. Layer names are the flax module's; batch norm is
flax's ``epsilon=1e-5``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F

from sleap_tpu_torch.models.common import IntermediateFeature
from sleap_tpu_torch.models.encoder_decoder import FlaxLayers, max_pool_same, upsample

_STACK_BLOCKS = {
    "ResNet50": (3, 4, 6, 3),
    "ResNet101": (3, 4, 23, 3),
    "ResNet152": (3, 8, 36, 3),
}


class ResNetV1Module(FlaxLayers):
    """Bottleneck ResNetV1 encoder + upsampling-stack decoder.

    ``up_blocks_spec`` holds one tuple a 2x up: (filters, transposed,
    kernel, refine convs, refine filters, batch norm, skip mode), skip mode
    ``None``, ``"add"`` or another string for concatenation. Built and run
    by one walk of :meth:`_graph`
    (:class:`~sleap_tpu_torch.models.encoder_decoder.FlaxLayers`);
    ``forward`` returns ``([output], [decoder features])``, the
    :class:`~sleap_tpu_torch.models.encoder_decoder.EncoderDecoderNet`
    contract.
    """

    flax_name = "backbone_module"
    bn_epsilon = 1e-5

    def __init__(self, version: str, max_stride: int, output_stride: int,
                 up_blocks_spec: tuple, in_channels: int):
        super().__init__()
        self.version = version
        self.max_stride = max_stride
        self.up_blocks_spec = tuple(up_blocks_spec)
        self._build = True
        out, feats = self._graph(int(in_channels))
        self._build = False
        self.out_channels = out
        self.output_stride = output_stride
        self.feature_channels = {}
        for f in feats:
            self.feature_channels.setdefault(f.stride, f.tensor)

    def _conv_bn(self, x, name, bn_name, filters, k, stride=1, dilation=1):
        x = self._conv_op(x, name, filters, k, stride, bias=False, dilation=dilation)
        return self._bn_op(x, bn_name)

    def _bottleneck(self, x, filters, stride, dilation, name):
        out = self._map(F.relu, self._conv_bn(x, f"{name}_conv1", f"{name}_bn1", filters, 1,
                                              stride))
        out = self._map(F.relu, self._conv_bn(out, f"{name}_conv2", f"{name}_bn2", filters, 3,
                                              dilation=dilation))
        out = self._conv_bn(out, f"{name}_conv3", f"{name}_bn3", filters * 4, 1)
        shortcut = x
        if self._width(x) != filters * 4 or stride != 1:
            shortcut = self._conv_bn(x, f"{name}_proj", f"{name}_proj_bn", filters * 4, 1, stride)
        return self._map(lambda a, b: F.relu(a + b), out, shortcut)

    def _graph(self, x):
        x = self._map(F.relu, self._conv_bn(x, "stem_conv", "stem_bn", 64, 7, 2))
        enc = {2: x}  # stride -> the first encoder feature there
        x = self._map(max_pool_same, x, 2, 3)
        stride, dilation = 4, 1
        # Strided stages past max_stride dilate instead.
        for si, (f, nb) in enumerate(zip((64, 128, 256, 512), _STACK_BLOCKS[self.version])):
            s1 = 1 if si == 0 else 2
            if s1 > 1:
                if stride < self.max_stride:
                    stride *= s1
                else:
                    dilation *= 2
                    s1 = 1
            for bi in range(nb):
                x = self._bottleneck(x, f, s1 if bi == 0 else 1, dilation, f"stage{si}_block{bi}")
            enc.setdefault(stride, x)
        feats: List[IntermediateFeature] = []
        for ui, (filters, transposed, kernel, n_refine, r_filters, bn,
                 skip_mode) in enumerate(self.up_blocks_spec):
            feats.append(IntermediateFeature(x, stride))
            stride //= 2
            if transposed:
                x = self._conv_transpose_op(x, f"up{ui}_trans_conv", filters, kernel)
                if bn:
                    x = self._bn_op(x, f"up{ui}_trans_bn")
                x = self._map(F.relu, x)
            else:
                x = self._map(upsample, x, 2, "bilinear")
            if skip_mode and stride in enc:
                skip = enc[stride]
                if skip_mode != "add":
                    x = self._cat([skip, x])
                else:
                    if self._width(skip) != self._width(x):
                        skip = self._conv_op(skip, f"up{ui}_skip_proj", self._width(x), 1)
                    x = self._map(torch.add, x, skip)
            for ri in range(n_refine):
                x = self._conv_op(x, f"up{ui}_refine{ri}", r_filters, 3)
                if bn:
                    x = self._bn_op(x, f"up{ui}_refine{ri}_bn")
                x = self._map(F.relu, x)
        return x, feats

    def forward(self, x: torch.Tensor):
        out, feats = self._graph(x)
        return [out], [feats]


@dataclass(frozen=True)
class ResNet:
    """Backbone description (the JAX package's ``ResNet`` descriptor)."""

    version: str = "ResNet50"
    weights: str = "random"
    max_stride: int = 32
    output_stride: int = 4
    upsampling: Optional[tuple] = None  # UpsamplingConfig's fields, see from_config
    stacks: int = 1
    input_conv = ("stem_conv", 1)

    @property
    def maximum_stride(self) -> int:
        return self.max_stride

    def up_blocks_spec(self) -> tuple:
        n_ups = int(math.log2(self.max_stride / self.output_stride))
        if self.upsampling is None:
            return tuple((64, True, 4, 2, 64, True, None) for _ in range(n_ups))
        (method, skip_connections, filters, filters_rate,
         refine_convs, batch_norm, kernel) = self.upsampling
        specs = []
        f = filters
        for _ in range(n_ups):
            specs.append((int(f), method == "transposed_conv", kernel, refine_convs, int(f),
                          batch_norm, skip_connections))
            f *= filters_rate
        return tuple(specs)

    def make_module(self, in_channels: int) -> ResNetV1Module:
        return ResNetV1Module(self.version, self.max_stride, self.output_stride,
                              self.up_blocks_spec(), in_channels)

    @classmethod
    def from_config(cls, config) -> "ResNet":
        """From a ``ResNetConfig`` (either package's, read by attribute).
        Only ``weights="random"`` builds: ImageNet weights would need a
        download, and the JAX package raises the same."""
        if config.weights != "random":
            raise NotImplementedError(
                "ImageNet-pretrained ResNet weights are unavailable offline; "
                "use weights='random' or provide a base_checkpoint."
            )
        upsampling = None
        if config.upsampling is not None:
            u = config.upsampling
            upsampling = (
                u.method if u.method in ("transposed_conv", "interpolation") else "interpolation",
                u.skip_connections,
                u.filters,
                u.filters_rate,
                u.refine_convs,
                u.batch_norm,
                u.transposed_conv_kernel_size,
            )
        return cls(version=config.version, weights=config.weights,
                   max_stride=config.max_stride, output_stride=config.output_stride,
                   upsampling=upsampling)
