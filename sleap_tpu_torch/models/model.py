"""Model assembly: UNet backbone + heads -> ``nn.Module``.

Port of :mod:`sleap_tpu.models.model` for the UNet backbones and the heads
of the top-down, single-instance, bottom-up and multiclass paths: 1x1 conv
heads, and the dense class-vector head. Heads attach to the backbone output
when their stride equals the backbone's output stride, and otherwise to the
first decoder feature recorded at their stride (``apply_heads`` in the JAX
package). Inputs and outputs keep the JAX
package's NHWC layout; the network runs NCHW inside, in float32, or in bf16
with ``torch.channels_last`` memory (see :class:`PoseNet`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import (
    EncoderDecoderNet,
    apply_activation,
    first_conv,
)
from sleap_tpu_torch.models.heads import (
    CenteredInstanceConfmapsHead,
    CentroidConfmapsHead,
    ClassMapsHead,
    ClassVectorsHead,
    MultiInstanceConfmapsHead,
    OffsetRefinementHead,
    PartAffinityFieldsHead,
    SingleInstanceConfmapsHead,
)
from sleap_tpu_torch.models.unet import UNet


class HeadSpec(NamedTuple):
    """One head: output key, channels, activation and stride; a dense head
    (``kind="dense"``) also has its hidden layers and pooling."""

    name: str
    channels: int
    activation: str
    output_stride: int
    kind: str = "conv"
    num_fc_layers: int = 0
    num_fc_units: int = 0
    global_pool: bool = True

    @classmethod
    def of(cls, head) -> "HeadSpec":
        if isinstance(head, ClassVectorsHead):
            return cls(head.name, head.channels, head.activation, head.output_stride, "dense",
                       head.num_fc_layers, head.num_fc_units, head.global_pool)
        return cls(head.name, head.channels, head.activation, head.output_stride)


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

    A dense head (``ClassVectorsHead``) averages its feature over space, or
    flattens it in NHWC order, and runs ``pre_classification{i}_fc`` dense +
    ReLU layers and a dense layer named after the head, then its activation:
    output (samples, classes). A flattening head needs ``input_hw``, the
    network input's (height, width), to size its first layer.
    """

    def __init__(
        self,
        backbone: UNet,
        heads: Sequence[HeadSpec],
        in_channels: int,
        compute_dtype: torch.dtype = torch.float32,
        input_hw: Optional[Tuple[int, int]] = None,
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
            if h.kind == "conv":
                self.heads[h.name] = nn.Conv2d(c, h.channels, 1)
                continue
            if not h.global_pool:
                if input_hw is None:
                    raise ValueError(f"Head {h.name} flattens its feature: give input_hw.")
                c *= -(-input_hw[0] // h.output_stride) * -(-input_hw[1] // h.output_stride)
            for i in range(h.num_fc_layers):
                self.heads[f"pre_classification{i}_fc"] = nn.Linear(c, h.num_fc_units)
                c = h.num_fc_units
            self.heads[h.name] = nn.Linear(c, h.channels)
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
            if h.kind == "conv":
                y = apply_activation(self.heads[h.name](src), h.activation)
                results[h.name] = y.permute(0, 2, 3, 1)
                continue
            y = src.mean(dim=(2, 3)) if h.global_pool else src.permute(0, 2, 3, 1).flatten(1)
            for i in range(h.num_fc_layers):
                y = F.relu(self.heads[f"pre_classification{i}_fc"](y))
            results[h.name] = apply_activation(self.heads[h.name](y), h.activation)
        return results


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: He-normal kernels (a normal of std
    ``sqrt(2 / fan_in)`` cut at 2 std, which keeps activations at the input's
    scale through the ReLU stack) and zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                # ConvTranspose2d stores (in, out, kh, kw): fan-in is dim 0.
                fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1])
                fan_in *= w[0, 0].numel()
                std = math.sqrt(2.0 / fan_in)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return module


@dataclass
class Model:
    """A model description: UNet backbone + heads, with the part names, the
    edges (PAF heads) and the classes (multiclass heads) they were built for."""

    backbone: UNet
    heads: List[HeadSpec]
    part_names: List[str] = field(default_factory=list)
    edges: List[Tuple[str, str]] = field(default_factory=list)
    classes: List[str] = field(default_factory=list)

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
        self,
        in_channels: int,
        compute_dtype: torch.dtype = torch.float32,
        input_hw: Optional[Tuple[int, int]] = None,
    ) -> PoseNet:
        return PoseNet(self.backbone, self.heads, in_channels, compute_dtype, input_hw)

    @classmethod
    def from_config(cls, config, skeleton=None) -> "Model":
        """From a model config (:class:`sleap_tpu_torch.config.ModelConfig`,
        or any object with its attributes, the JAX package's included): UNet
        backbones with single-instance, centroid, centered-instance
        (+ offsets), multi-instance (confmaps, PAFs, + offsets), multiclass
        bottom-up (confmaps, class maps, + offsets) or multiclass top-down
        (confmaps, class vectors, + offsets) heads.

        Part names and edges missing from the head config come from
        ``skeleton``, as in the JAX package; a multiclass head config must
        name its classes. Other backbones raise.
        """
        unet_cfg = config.backbone.unet
        if unet_cfg is None:
            raise NotImplementedError(
                "Only UNet backbones are ported (ROADMAP.md, queue 1, item 10)."
            )
        hc = config.heads.which_oneof
        head_name = config.heads.which_oneof_attrib_name

        def skeleton_field(value, name):
            if value is None:
                if skeleton is None:
                    raise ValueError("Skeleton required when head config incomplete.")
                value = getattr(skeleton, name)
            return list(value)

        def class_names(value):
            if value is None:
                raise ValueError(f"The {head_name} head config names no classes.")
            return list(value)

        names: List[str] = []
        classes: List[str] = []
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
        elif head_name == "multi_class_bottomup":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps.part_names, "node_names")
            classes = class_names(hc.class_maps.classes)
            heads = [
                MultiInstanceConfmapsHead.from_config(hc.confmaps, part_names=names),
                ClassMapsHead.from_config(hc.class_maps, classes=classes),
            ]
        elif head_name == "multi_class_topdown":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps.part_names, "node_names")
            classes = class_names(hc.class_vectors.classes)
            heads = [
                CenteredInstanceConfmapsHead.from_config(hc.confmaps, part_names=names),
                ClassVectorsHead.from_config(hc.class_vectors, classes=classes),
            ]
        else:
            raise ValueError(f"Head type {head_name!r} is unknown or unset.")
        if offsets_cfg.offset_refinement:
            heads.append(
                OffsetRefinementHead.from_config(offsets_cfg, part_names=names or None)
            )
        return cls(
            backbone=UNet.from_config(unet_cfg),
            heads=[HeadSpec.of(h) for h in heads],
            part_names=names,
            edges=edges,
            classes=classes,
        )


def find_head(outputs: Dict[str, torch.Tensor], name_substring: str) -> Optional[str]:
    """Output key containing ``name_substring``, preferring final-stack keys."""
    keys = [k for k in outputs if name_substring in k and "_stack" not in k]
    if keys:
        return keys[0]
    keys = [k for k in outputs if name_substring in k]
    return keys[0] if keys else None
