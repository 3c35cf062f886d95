"""Model assembly: backbone + heads -> ``nn.Module``.

Port of :mod:`sleap_tpu.models.model`: every backbone the JAX package builds
(UNet, LEAP, stacked Hourglass, ResNet, HigherHRNet and the
pretrained-encoder UNet) and the heads of the top-down, single-instance,
bottom-up and multiclass paths: 1x1 conv heads, and the dense class-vector
head. Heads attach to the backbone output when their stride equals the
backbone's output stride, and otherwise to the first decoder feature
recorded at their stride (``apply_heads`` in the JAX package); a stacked
backbone gets heads on every stack, keyed ``{name}_stack{i}`` on all but
the last. Inputs and outputs keep the JAX package's NHWC layout; the
network runs NCHW inside, in float32, or in bf16 with ``torch.channels_last``
memory and float32 batch norm (see :class:`PoseNet`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import (
    EncoderDecoderNet,
    apply_activation,
    first_conv,
)
from sleap_tpu_torch.models.hourglass import Hourglass
from sleap_tpu_torch.models.hrnet import HigherHRNet
from sleap_tpu_torch.models.leap import LeapCNN
from sleap_tpu_torch.models.pretrained_encoder import UnetPretrainedEncoder
from sleap_tpu_torch.models.resnet import ResNet
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
from sleap_tpu_torch.models.params import flax_variables_from_state_dict, state_dict_from_flax
from sleap_tpu_torch.models.unet import UNet
from sleap_tpu_torch.parallel.spatial import frame_mean, gather_frame

# ``backbone`` oneof name in the config -> its description's class.
BACKBONES = {
    "unet": UNet,
    "leap": LeapCNN,
    "hourglass": Hourglass,
    "resnet": ResNet,
    "hrnet": HigherHRNet,
    "pretrained_encoder": UnetPretrainedEncoder,
}

def make_backbone(backbone, in_channels: int) -> nn.Module:
    """The backbone module of a description: its own module (ResNet,
    HRNet, pretrained encoder), or the block stacks it describes (UNet,
    LEAP, Hourglass) run by ``EncoderDecoderNet``."""
    if hasattr(backbone, "make_module"):
        return backbone.make_module(in_channels)
    return EncoderDecoderNet(
        backbone.make_stem_blocks(),
        backbone.make_encoder_blocks(),
        backbone.make_decoder_blocks(),
        in_channels=in_channels,
        stacks=backbone.stacks,
    )


class HeadSpec(NamedTuple):
    """One head: output key, channels, activation and stride; a dense head
    (``kind="dense"``) also has its hidden layers and pooling. Training
    reads its loss (``"mse"`` or ``"categorical_crossentropy"``) and weight."""

    name: str
    channels: int
    activation: str
    output_stride: int
    kind: str = "conv"
    num_fc_layers: int = 0
    num_fc_units: int = 0
    global_pool: bool = True
    loss_function: str = "mse"
    loss_weight: float = 1.0

    @classmethod
    def of(cls, head) -> "HeadSpec":
        loss = {"loss_function": head.loss_function, "loss_weight": head.loss_weight}
        if isinstance(head, ClassVectorsHead):
            return cls(head.name, head.channels, head.activation, head.output_stride, "dense",
                       head.num_fc_layers, head.num_fc_units, head.global_pool, **loss)
        return cls(head.name, head.channels, head.activation, head.output_stride, **loss)


class PoseNet(nn.Module):
    """Backbone + heads; ``forward`` maps NHWC images to NHWC maps, keyed
    by head name (and ``_stack{i}`` for the heads of a stack but the last).

    Integer images are raw pixels and are scaled by their dtype's maximum
    (``ensure_float``'s rule) in float32; the JAX module defers that past its
    s2d stem, which moves pixels only, so the result is the same either way.

    ``compute_dtype`` is the JAX module's: the input is cast to it, and in
    bf16 the weights are bf16 (flax casts its float32 params at each layer,
    which rounds them the same way) and the head outputs stay bf16; batch
    norm keeps float32 parameters and statistics and normalises in float32
    (:class:`~sleap_tpu_torch.models.encoder_decoder.FlaxBatchNorm2d`), as
    flax's does under a bf16 ``dtype``. A bf16
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
        backbone,
        heads: Sequence[HeadSpec],
        in_channels: int,
        compute_dtype: torch.dtype = torch.float32,
        input_hw: Optional[Tuple[int, int]] = None,
    ):
        super().__init__()
        self.backbone = make_backbone(backbone, in_channels)
        self.stacks = int(backbone.stacks)
        self.in_channels = int(in_channels)
        self.head_specs = tuple(heads)
        self.heads = nn.ModuleDict()
        for h in self.head_specs:
            if h.output_stride == self.backbone.output_stride:
                c0 = self.backbone.out_channels
            elif h.output_stride in self.backbone.feature_channels:
                c0 = self.backbone.feature_channels[h.output_stride]
            else:
                raise ValueError(f"No feature at stride {h.output_stride} for head {h.name}.")
            for suffix in self.stack_suffixes:
                c = c0
                if h.kind == "conv":
                    self.heads[f"{h.name}{suffix}"] = nn.Conv2d(c, h.channels, 1)
                    continue
                if not h.global_pool:
                    if input_hw is None:
                        raise ValueError(f"Head {h.name} flattens its feature: give input_hw.")
                    c *= -(-input_hw[0] // h.output_stride) * -(-input_hw[1] // h.output_stride)
                for i in range(h.num_fc_layers):
                    self.heads[f"pre_classification{i}_fc{suffix}"] = nn.Linear(c, h.num_fc_units)
                    c = h.num_fc_units
                self.heads[f"{h.name}{suffix}"] = nn.Linear(c, h.channels)
        self.compute_dtype = compute_dtype
        if compute_dtype != torch.float32:
            self.to(dtype=compute_dtype, memory_format=torch.channels_last)

    @property
    def stack_suffixes(self) -> List[str]:
        """Head-name suffix of each stack: ``_stack{i}``, none on the last."""
        return [f"_stack{i}" for i in range(self.stacks - 1)] + [""]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not torch.is_floating_point(x):
            x = x.float() / float(torch.iinfo(x.dtype).max)
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        if self.compute_dtype != torch.float32:
            x = x.contiguous(memory_format=torch.channels_last)
        outputs, intermediates = self.backbone(x)
        results = {}
        for h in self.head_specs:
            for suffix, out, feats in zip(self.stack_suffixes, outputs, intermediates):
                src = out
                if h.output_stride != self.backbone.output_stride:
                    src = next(f.tensor for f in feats if f.stride == h.output_stride)
                if h.kind == "conv":
                    y = apply_activation(self.heads[f"{h.name}{suffix}"](src), h.activation)
                    results[f"{h.name}{suffix}"] = y.permute(0, 2, 3, 1)
                    continue
                # Over the whole frame when ``src`` is a band of it.
                y = (frame_mean(src).flatten(1) if h.global_pool
                     else gather_frame(src).permute(0, 2, 3, 1).flatten(1))
                for i in range(h.num_fc_layers):
                    y = F.relu(self.heads[f"pre_classification{i}_fc{suffix}"](y))
                results[f"{h.name}{suffix}"] = apply_activation(
                    self.heads[f"{h.name}{suffix}"](y), h.activation)
        return results


# The JAX package wraps block-stack backbones in ``PoseNet`` and module
# backbones (ResNet, HRNet, pretrained encoders) in ``BackboneWithHeads``,
# with one head contract; here one class runs both.
BackboneWithHeads = PoseNet


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


# Stddev of a standard normal truncated to [-2, 2]: flax's lecun_normal
# divides by it so that the truncated draw has variance 1 / fan_in.
_TRUNC_NORMAL_STD = 0.87962566


def init_params_lecun(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Training's initial weights, as flax initializes the JAX module:
    every kernel ``lecun_normal`` (a normal of std
    ``sqrt(1 / fan_in) / 0.87962566`` cut at 2 std), every bias 0, batch
    norm scales and running variances 1, running means 0.

    Kernels are drawn in the flax params tree's shapes
    (:func:`~sleap_tpu_torch.models.params.flax_variables_from_state_dict`),
    whose fan-in is the product of all axes but the last, so each layer's
    fan-in is flax's (the first decoder conv's covers the skip and the
    upsampled channels), and loaded back through
    :func:`~sleap_tpu_torch.models.params.state_dict_from_flax`.
    """
    def draw(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = draw(leaf)
            elif name == "kernel":
                std = math.sqrt(1.0 / math.prod(leaf.shape[:-1])) / _TRUNC_NORMAL_STD
                w = torch.empty(leaf.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                out[name] = w.numpy()
            elif name in ("scale", "var"):
                out[name] = np.ones_like(leaf)
            else:
                out[name] = np.zeros_like(leaf)
        return out

    module.load_state_dict(state_dict_from_flax(module, draw(flax_variables_from_state_dict(module))))
    return module


@dataclass
class Model:
    """A model description: a backbone description (:data:`BACKBONES`) +
    heads, with the part names, the edges (PAF heads) and the classes
    (multiclass heads) they were built for."""

    backbone: Any
    heads: List[HeadSpec]
    part_names: List[str] = field(default_factory=list)
    edges: List[Tuple[str, str]] = field(default_factory=list)
    classes: List[str] = field(default_factory=list)

    @property
    def head_names(self) -> List[str]:
        return [h.name for h in self.heads]

    @property
    def maximum_stride(self) -> int:
        return self.backbone.maximum_stride

    @property
    def output_stride(self) -> int:
        return self.backbone.output_stride

    @property
    def input_conv(self) -> Optional[Tuple[str, int]]:
        """(layer name, s2d channel fold) of the first conv (see
        :func:`~sleap_tpu_torch.models.encoder_decoder.first_conv`), or None
        when its kernel does not tell the input channels (the pretrained
        encoders tile grayscale to RGB)."""
        if hasattr(self.backbone, "make_module"):
            return self.backbone.input_conv
        return first_conv(self.backbone.make_stem_blocks(), self.backbone.make_encoder_blocks())

    def make_module(
        self,
        in_channels: int,
        compute_dtype: torch.dtype = torch.float32,
        input_hw: Optional[Tuple[int, int]] = None,
    ) -> PoseNet:
        return PoseNet(self.backbone, self.heads, in_channels, compute_dtype, input_hw)

    def init(self, in_channels: int, generator: torch.Generator,
             input_hw: Optional[Tuple[int, int]] = None) -> PoseNet:
        """A float32 module with training's initial weights, as the JAX
        package's ``Model.init``: flax's initialization
        (:func:`init_params_lecun`), then the backbone's
        ``init_weights_hook`` (the pretrained encoders' local weights), on
        the flax variables. No forward runs, so the batch-norm statistics
        stay at 0 and 1 (flax initializes with ``train=False``)."""
        module = init_params_lecun(self.make_module(in_channels, input_hw=input_hw), generator)
        hook = getattr(self.backbone, "init_weights_hook", None)
        if hook is not None:
            variables = hook(flax_variables_from_state_dict(module))
            module.load_state_dict(state_dict_from_flax(module, variables))
        return module

    @classmethod
    def from_config(cls, config, skeleton=None, tracks=None, update_config=False) -> "Model":
        """From a model config (:class:`sleap_tpu_torch.config.ModelConfig`,
        or any object with its attributes, the JAX package's included): any
        backbone of :data:`BACKBONES` with single-instance, centroid,
        centered-instance (+ offsets), multi-instance (confmaps, PAFs,
        + offsets), multiclass bottom-up (confmaps, class maps, + offsets)
        or multiclass top-down (confmaps, class vectors, + offsets) heads.

        Part names and edges missing from the head config come from
        ``skeleton``, and classes from the names of ``tracks``, as in the JAX
        package; with ``update_config`` they are written into the config.
        """
        backbone_name = config.backbone.which_oneof_attrib_name
        if backbone_name is None:
            raise ValueError("Backbone architecture was not specified.")
        backbone = BACKBONES[backbone_name].from_config(config.backbone.which_oneof)
        hc = config.heads.which_oneof
        head_name = config.heads.which_oneof_attrib_name

        def skeleton_field(cfg, attr, name):
            value = getattr(cfg, attr)
            if value is None:
                if skeleton is None:
                    raise ValueError("Skeleton required when head config incomplete.")
                value = getattr(skeleton, name)
                if update_config:
                    setattr(cfg, attr, value)
            return list(value)

        def class_names(cfg):
            if cfg.classes is not None:
                return list(cfg.classes)
            if tracks is None:
                raise ValueError(f"The {head_name} head config names no classes.")
            names = [t.name for t in tracks]
            if update_config:
                cfg.classes = names
            return list(names)

        names: List[str] = []
        classes: List[str] = []
        edges: List[Tuple[str, str]] = []
        offsets_cfg = hc
        if head_name == "single_instance":
            names = skeleton_field(hc, "part_names", "node_names")
            heads = [SingleInstanceConfmapsHead.from_config(hc, part_names=names)]
        elif head_name == "centroid":
            heads = [CentroidConfmapsHead.from_config(hc)]
        elif head_name == "centered_instance":
            names = skeleton_field(hc, "part_names", "node_names")
            heads = [CenteredInstanceConfmapsHead.from_config(hc, part_names=names)]
        elif head_name == "multi_instance":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps, "part_names", "node_names")
            edges = [tuple(e) for e in skeleton_field(hc.pafs, "edges", "edge_names")]
            heads = [
                MultiInstanceConfmapsHead.from_config(hc.confmaps, part_names=names),
                PartAffinityFieldsHead.from_config(hc.pafs, edges=edges),
            ]
        elif head_name == "multi_class_bottomup":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps, "part_names", "node_names")
            classes = class_names(hc.class_maps)
            heads = [
                MultiInstanceConfmapsHead.from_config(hc.confmaps, part_names=names),
                ClassMapsHead.from_config(hc.class_maps, classes=classes),
            ]
        elif head_name == "multi_class_topdown":
            offsets_cfg = hc.confmaps
            names = skeleton_field(hc.confmaps, "part_names", "node_names")
            classes = class_names(hc.class_vectors)
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
            backbone=backbone,
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
