"""Model assembly: UNet backbone + 1x1 conv heads -> ``nn.Module``.

Port of :mod:`sleap_tpu.models.model` for the UNet backbones and the conv
heads of the top-down, single-instance and bottom-up paths. Heads attach to
the backbone output when their stride equals the backbone's output stride,
and otherwise to the first decoder feature recorded at their stride
(``apply_heads`` in the JAX package). Inputs and outputs keep the JAX
package's NHWC layout; the network runs NCHW inside, in float32, or in bf16
with ``torch.channels_last`` memory (see :class:`PoseNet`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import (
    EncoderDecoderNet,
    apply_activation,
    first_conv,
)
from sleap_tpu_torch.models.heads import (
    CenteredInstanceConfmapsHead,
    CentroidConfmapsHead,
    MultiInstanceConfmapsHead,
    OffsetRefinementHead,
    PartAffinityFieldsHead,
    SingleInstanceConfmapsHead,
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
    (``ensure_float``'s rule) in float32; the JAX module defers that past its
    s2d stem, which moves pixels only, so the result is the same either way.

    ``compute_dtype`` is the JAX module's: the input is cast to it, and in
    bf16 the weights are bf16 (flax casts its float32 params at each layer,
    which rounds them the same way) and the head outputs stay bf16. A bf16
    module keeps its weights and activations in ``torch.channels_last``
    memory: cuDNN's bf16 tensor-core convolutions take NHWC, and the NHWC
    head outputs are then contiguous, the layout the bf16 peak kernel reads.
    """

    def __init__(
        self,
        backbone: UNet,
        heads: Sequence[HeadSpec],
        in_channels: int,
        compute_dtype: torch.dtype = torch.float32,
    ):
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
        self.compute_dtype = compute_dtype
        if compute_dtype != torch.float32:
            self.to(dtype=compute_dtype, memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not torch.is_floating_point(x):
            x = x.float() / float(torch.iinfo(x.dtype).max)
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if self.compute_dtype != torch.float32:
            x = x.contiguous(memory_format=torch.channels_last)
        out, feats = self.backbone(x)
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
    """A model description: UNet backbone + conv heads, with the part names
    and (for PAF heads) the edges the heads were built for."""

    backbone: UNet
    heads: List[HeadSpec]
    part_names: List[str] = field(default_factory=list)
    edges: List[Tuple[str, str]] = field(default_factory=list)

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

    def make_module(
        self, in_channels: int, compute_dtype: torch.dtype = torch.float32
    ) -> PoseNet:
        return PoseNet(self.backbone, self.heads, in_channels, compute_dtype)

    @classmethod
    def from_config(cls, config, skeleton=None) -> "Model":
        """From a model config (:class:`sleap_tpu_torch.config.ModelConfig`,
        or any object with its attributes, the JAX package's included): UNet
        backbones with single-instance, centroid, centered-instance
        (+ offsets) or multi-instance heads (confmaps, PAFs, + offsets).

        Part names and edges missing from the head config come from
        ``skeleton``, as in the JAX package. Other backbones and heads raise.
        """
        unet_cfg = config.backbone.unet
        if unet_cfg is None:
            raise NotImplementedError(
                "Only UNet backbones are ported (ROADMAP.md, queue 1, item 12)."
            )
        hc = config.heads.which_oneof
        head_name = config.heads.which_oneof_attrib_name

        def skeleton_field(value, name):
            if value is None:
                if skeleton is None:
                    raise ValueError("Skeleton required when head config incomplete.")
                value = getattr(skeleton, name)
            return list(value)

        names: List[str] = []
        edges: List[Tuple[str, str]] = []
        offsets_cfg = hc
        if head_name == "single_instance":
            names = skeleton_field(hc.part_names, "node_names")
            heads = [SingleInstanceConfmapsHead.from_config(hc, part_names=names)]
        elif head_name == "centroid":
            heads = [CentroidConfmapsHead.from_config(hc)]
        elif head_name == "centered_instance":
            names = skeleton_field(hc.part_names, "node_names")
            heads = [CenteredInstanceConfmapsHead.from_config(hc, part_names=names)]
        elif head_name == "multi_instance":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps.part_names, "node_names")
            edges = [tuple(e) for e in skeleton_field(hc.pafs.edges, "edge_names")]
            heads = [
                MultiInstanceConfmapsHead.from_config(hc.confmaps, part_names=names),
                PartAffinityFieldsHead.from_config(hc.pafs, edges=edges),
            ]
        else:
            raise NotImplementedError(f"Head {head_name!r} is not ported yet.")
        if offsets_cfg.offset_refinement:
            heads.append(
                OffsetRefinementHead.from_config(offsets_cfg, part_names=names or None)
            )
        specs = [HeadSpec(h.name, h.channels, h.activation, h.output_stride) for h in heads]
        return cls(
            backbone=UNet.from_config(unet_cfg), heads=specs, part_names=names, edges=edges
        )


def find_head(outputs: Dict[str, torch.Tensor], name_substring: str) -> Optional[str]:
    """Output key containing ``name_substring``, preferring final-stack keys."""
    keys = [k for k in outputs if name_substring in k and "_stack" not in k]
    if keys:
        return keys[0]
    keys = [k for k in outputs if name_substring in k]
    return keys[0] if keys else None
