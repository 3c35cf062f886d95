"""(Higher)HRNet backbone (PyTorch port of :mod:`sleap_tpu.models.hrnet`).

A stem of strided 3x3 convs; stage 1's residual blocks at the stem's
resolution, projected to ``C``; stages 2-4 of parallel branches at strides
(S, 2S, 4S, 8S) and widths (C, 2C, 4C, 8C), fused all to all (strided
convs downward, 1x1 conv + nearest upsampling upward); then HigherHRNet's
deconv modules, each a 2x up (transposed conv + BN + ReLU, or bilinear)
and four residual blocks. Layer names are the flax module's. Its batch
norm is flax's default (``momentum=0.9``, ``epsilon=1e-5``); the JAX
module casts its input to float32, normalises and casts back to the compute
dtype, which :class:`~sleap_tpu_torch.models.encoder_decoder.FlaxBatchNorm2d`
does for every backbone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from sleap_tpu_torch.models.common import IntermediateFeature
from sleap_tpu_torch.models.encoder_decoder import FlaxLayers, upsample


class HigherHRNetModule(FlaxLayers):
    """Multi-resolution HRNet trunk + HigherHRNet deconv upsampling.

    Construction and ``forward`` walk the same graph, :meth:`_graph`
    (:class:`~sleap_tpu_torch.models.encoder_decoder.FlaxLayers`). ``forward`` returns ``([output], [features])``, the
    :class:`~sleap_tpu_torch.models.encoder_decoder.EncoderDecoderNet`
    contract.
    """

    flax_name = "backbone_module"
    bn_epsilon = 1e-5
    bn_momentum = 0.9

    def __init__(self, C: int = 18, initial_downsampling_steps: int = 2,
                 n_deconv_modules: int = 1, bottleneck: bool = False,
                 deconv_filters: int = 256, bilinear_upsampling: bool = False,
                 stem_filters: int = 64, in_channels: int = 1):
        super().__init__()
        self.C = C
        self.initial_downsampling_steps = initial_downsampling_steps
        self.n_deconv_modules = n_deconv_modules
        self.bottleneck = bottleneck
        self.deconv_filters = deconv_filters
        self.bilinear_upsampling = bilinear_upsampling
        self.stem_filters = stem_filters
        self._build = True
        out, feats = self._graph(int(in_channels))
        self._build = False
        self.out_channels = out
        self.output_stride = 2 ** (initial_downsampling_steps - n_deconv_modules)
        self.feature_channels = {}
        for f in feats:
            self.feature_channels.setdefault(f.stride, f.tensor)

    def _conv_bn(self, x, filters, kernel, stride, scope, bn=True, act=True):
        """conv -> BN -> ReLU (``_conv`` in the JAX module)."""
        x = self._conv_op(x, f"{scope}_conv", filters, kernel, stride, bias=not bn)
        if bn:
            x = self._bn_op(x, f"{scope}_bn")
        return self._map(F.relu, x) if act else x

    def _add_relu(self, a, b):
        return self._map(lambda a, b: F.relu(a + b), a, b)

    def _residual_block(self, x, filters, scope):
        if self.bottleneck:
            y = self._conv_bn(x, filters, 1, 1, f"{scope}_in")
            y = self._conv_bn(y, filters, 3, 1, f"{scope}_3x3")
            y = self._conv_bn(y, filters, 1, 1, f"{scope}_expand", act=False)
        else:
            y = self._conv_bn(x, filters, 3, 1, f"{scope}_c1")
            y = self._conv_bn(y, filters, 3, 1, f"{scope}_c2", act=False)
        residual = x
        if self._width(x) != self._width(y):
            residual = self._conv_bn(x, self._width(y), 1, 1, f"{scope}_proj", act=False)
        return self._add_relu(y, residual)

    def _branch(self, x, filters, blocks, scope):
        for b in range(blocks):
            x = self._residual_block(x, filters, f"{scope}_blk{b}")
        return x

    def _down(self, x, steps, out_filters, scope, relu_last):
        in_filters = self._width(x)
        for s in range(steps - 1):
            x = self._conv_bn(x, in_filters, 3, 2, f"{scope}_d{s}")
        return self._conv_bn(x, out_filters, 3, 2, f"{scope}_d{steps - 1}", act=relu_last)

    def _up(self, x, steps, out_filters, scope):
        x = self._conv_bn(x, out_filters, 1, 1, f"{scope}_1x1", act=False)
        return self._map(upsample, x, 2**steps, "nearest")

    def _fuse(self, branches, scope, single_scale):
        fused = []
        for i in range(1 if single_scale else len(branches)):
            acc = branches[i]
            width = self._width(acc)
            for j, src in enumerate(branches):
                if j > i:
                    src = self._up(src, j - i, width, f"{scope}_f{j}to{i}")
                elif j < i:
                    src = self._down(src, i - j, width, f"{scope}_f{j}to{i}", False)
                else:
                    continue
                acc = self._map(torch.add, acc, src)
            fused.append(self._map(F.relu, acc))
        return fused

    def _stage(self, branches, widths, modules, blocks, scope, single_scale):
        ins = []
        for t, w in enumerate(widths):
            if t < len(branches):
                src = branches[t]
                ins.append(src if self._width(src) == w
                           else self._conv_bn(src, w, 3, 1, f"{scope}_tr{t}"))
            else:
                ins.append(self._down(branches[-1], t - (len(branches) - 1), w,
                                      f"{scope}_tr{t}", True))
        for m in range(modules):
            outs = [self._branch(x, w, blocks, f"{scope}_m{m}_b{i}")
                    for i, (x, w) in enumerate(zip(ins, widths))]
            if len(outs) > 1:
                outs = self._fuse(outs, f"{scope}_m{m}", single_scale and m == modules - 1)
            ins = outs
        return ins

    def _graph(self, x):
        steps = self.initial_downsampling_steps
        for s in range(steps):
            x = self._conv_bn(x, self.stem_filters, 3, 2, f"stem{s}", act=s == steps - 1)
        x = self._branch(x, 64, 4, "stage1")
        x = self._conv_bn(x, self.C, 3, 1, "stage1_out", act=False)
        C = self.C
        branches = self._stage([x], (C, 2 * C), 1, 4, "stage2", False)
        branches = self._stage(branches, (C, 2 * C, 4 * C), 4, 4, "stage3", False)
        branches = self._stage(branches, (C, 2 * C, 4 * C, 8 * C), 3, 4, "stage4", True)
        feats = branches[0]
        stride = 2**steps
        intermediates: List[IntermediateFeature] = [IntermediateFeature(feats, stride)]
        for d in range(self.n_deconv_modules):
            if self.bilinear_upsampling:
                feats = self._map(upsample, feats, 2, "bilinear")
            else:
                feats = self._conv_transpose_op(feats, f"deconv{d}", self.deconv_filters, 4,
                                                bias=False)
                feats = self._map(F.relu, self._bn_op(feats, f"deconv{d}_bn"))
            for b in range(4):
                feats = self._residual_block(feats, 32, f"deconv{d}_blk{b}")
            stride //= 2
            intermediates.append(IntermediateFeature(feats, stride))
        return feats, intermediates[:-1]

    def forward(self, x: torch.Tensor):
        out, feats = self._graph(x)
        return [out], [feats]


@dataclass(frozen=True)
class HigherHRNet:
    """Backbone description (the JAX package's ``HigherHRNet`` descriptor)."""

    C: int = 18
    initial_downsampling_steps: int = 2
    n_deconv_modules: int = 1
    bottleneck: bool = False
    deconv_filters: int = 256
    bilinear_upsampling: bool = False
    stem_filters: int = 64
    stacks: int = 1
    input_conv = ("stem0_conv", 1)

    @property
    def maximum_stride(self) -> int:
        # Trunk branches reach 8x the stem stride (stage 4's deepest branch).
        return (2**self.initial_downsampling_steps) * 8

    @property
    def output_stride(self) -> int:
        return 2 ** (self.initial_downsampling_steps - self.n_deconv_modules)

    def make_module(self, in_channels: int) -> HigherHRNetModule:
        return HigherHRNetModule(self.C, self.initial_downsampling_steps, self.n_deconv_modules,
                                 self.bottleneck, self.deconv_filters, self.bilinear_upsampling,
                                 self.stem_filters, in_channels)

    @classmethod
    def from_config(cls, config) -> "HigherHRNet":
        """From an ``HRNetConfig`` (either package's, read by attribute)."""
        return cls(C=config.C, initial_downsampling_steps=config.initial_downsampling_steps,
                   n_deconv_modules=config.n_deconv_modules, bottleneck=config.bottleneck,
                   deconv_filters=config.deconv_filters,
                   bilinear_upsampling=config.bilinear_upsampling,
                   stem_filters=config.stem_filters)
