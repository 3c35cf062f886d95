"""Model assembly: UNet backbone + 1x1 conv heads -> ``nn.Module``.

Port of :mod:`sleap_tpu.models.model` for the UNet backbones and the conv
heads of the top-down and single-instance paths. Heads attach to the
backbone output when their stride equals the backbone's output stride, and
otherwise to the first decoder feature recorded at their stride
(``apply_heads`` in the JAX package). Inputs and outputs keep the JAX
package's NHWC layout; the network runs NCHW inside.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import (
    EncoderDecoderNet,
    apply_activation,
    first_conv,
)
from sleap_tpu_torch.models.unet import UNet


class HeadSpec(NamedTuple):
    """One conv head: output key, channels, activation and stride."""

    name: str
    channels: int
    activation: str
    output_stride: int


class PoseNet(nn.Module):
    """Backbone + conv heads; ``forward`` maps NHWC images to NHWC maps.

    Integer images are raw pixels and are scaled by their dtype's maximum
    (``ensure_float``'s rule); the JAX module defers that past its s2d stem,
    which moves pixels only, so the result is the same either way.
    """

    def __init__(self, backbone: UNet, heads: Sequence[HeadSpec], in_channels: int):
        super().__init__()
        self.backbone = EncoderDecoderNet(
            backbone.make_stem_blocks(),
            backbone.make_encoder_blocks(),
            backbone.make_decoder_blocks(),
            in_channels=in_channels,
            stacks=backbone.stacks,
        )
        self.in_channels = int(in_channels)
        self.head_specs = tuple(heads)
        self.heads = nn.ModuleDict()
        for h in self.head_specs:
            if h.output_stride == self.backbone.output_stride:
                c = self.backbone.out_channels
            elif h.output_stride in self.backbone.feature_channels:
                c = self.backbone.feature_channels[h.output_stride]
            else:
                raise ValueError(f"No feature at stride {h.output_stride} for head {h.name}.")
            self.heads[h.name] = nn.Conv2d(c, h.channels, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not torch.is_floating_point(x):
            x = x.float() / float(torch.iinfo(x.dtype).max)
        out, feats = self.backbone(x.permute(0, 3, 1, 2))
        results = {}
        for h in self.head_specs:
            src = out
            if h.output_stride != self.backbone.output_stride:
                src = next(f.tensor for f in feats if f.stride == h.output_stride)
            y = apply_activation(self.heads[h.name](src), h.activation)
            results[h.name] = y.permute(0, 2, 3, 1)
        return results


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: He-normal kernels (a normal of std
    ``sqrt(2 / fan_in)`` cut at 2 std, which keeps activations at the input's
    scale through the ReLU stack) and zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                # ConvTranspose2d stores (in, out, kh, kw): fan-in is dim 0.
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1])
                fan_in *= w.shape[2] * w.shape[3]
                std = math.sqrt(2.0 / fan_in)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


@dataclass
class Model:
    """A model description: UNet backbone + conv heads."""

    backbone: UNet
    heads: List[HeadSpec]

    @property
    def maximum_stride(self) -> int:
        return self.backbone.maximum_stride

    @property
    def output_stride(self) -> int:
        return self.backbone.output_stride

    @property
    def input_conv(self):
        """(layer name, s2d channel fold) of the first conv (see
        :func:`~sleap_tpu_torch.models.encoder_decoder.first_conv`)."""
        return first_conv(self.backbone.make_stem_blocks(), self.backbone.make_encoder_blocks())

    def make_module(self, in_channels: int) -> PoseNet:
        return PoseNet(self.backbone, self.heads, in_channels)

    @classmethod
    def from_config(cls, config, skeleton=None) -> "Model":
        """From a ``sleap_tpu.config.ModelConfig``: UNet backbones with
        single-instance, centroid or centered-instance heads (+ offsets).

        Part names missing from the head config come from ``skeleton``, as
        in the JAX package. Other backbones and heads raise.
        """
        from sleap_tpu.models.heads import (
            CenteredInstanceConfmapsHead,
            CentroidConfmapsHead,
            OffsetRefinementHead,
            SingleInstanceConfmapsHead,
        )

        unet_cfg = config.backbone.unet
        if unet_cfg is None:
            raise NotImplementedError(
                "Only UNet backbones are ported (ROADMAP.md, queue 1, item 12)."
            )
        hc = config.heads.which_oneof
        head_name = config.heads.which_oneof_attrib_name

        def part_names():
            names = getattr(hc, "part_names", None)
            if names is None:
                if skeleton is None:
                    raise ValueError("Skeleton required when head config incomplete.")
                names = skeleton.node_names
            return names

        if head_name == "single_instance":
            heads = [SingleInstanceConfmapsHead.from_config(hc, part_names=part_names())]
        elif head_name == "centroid":
            heads = [CentroidConfmapsHead.from_config(hc)]
        elif head_name == "centered_instance":
            heads = [CenteredInstanceConfmapsHead.from_config(hc, part_names=part_names())]
        else:
            raise NotImplementedError(f"Head {head_name!r} is not ported yet.")
        if hc.offset_refinement:
            names = None if head_name == "centroid" else part_names()
            heads.append(OffsetRefinementHead.from_config(hc, part_names=names))
        specs = [HeadSpec(h.name, h.channels, h.activation, h.output_stride) for h in heads]
        return cls(backbone=UNet.from_config(unet_cfg), heads=specs)


def find_head(outputs: Dict[str, torch.Tensor], name_substring: str) -> Optional[str]:
    """Output key containing ``name_substring``, preferring final-stack keys."""
    keys = [k for k in outputs if name_substring in k and "_stack" not in k]
    if keys:
        return keys[0]
    keys = [k for k in outputs if name_substring in k]
    return keys[0] if keys else None
