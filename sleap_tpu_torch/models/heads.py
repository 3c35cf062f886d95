"""Output head descriptors: name, channels, activation and stride of each
head the port builds: 1x1 conv heads, and the dense class-vector head.

A copy of the part of :mod:`sleap_tpu.models.heads` that inference uses.
``from_config`` reads any config object by attribute: the port's
:mod:`sleap_tpu_torch.config` or the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class Head:
    output_stride: int = 1

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def channels(self) -> int:
        raise NotImplementedError

    @property
    def activation(self) -> str:
        return "linear"


@dataclass
class SingleInstanceConfmapsHead(Head):
    part_names: List[str] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.part_names)

    @classmethod
    def from_config(cls, config, part_names=None) -> "SingleInstanceConfmapsHead":
        return cls(part_names=part_names or config.part_names, output_stride=config.output_stride)


@dataclass
class CentroidConfmapsHead(Head):
    @property
    def channels(self) -> int:
        return 1

    @classmethod
    def from_config(cls, config) -> "CentroidConfmapsHead":
        return cls(output_stride=config.output_stride)


@dataclass
class CenteredInstanceConfmapsHead(Head):
    part_names: List[str] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.part_names)

    @classmethod
    def from_config(cls, config, part_names=None) -> "CenteredInstanceConfmapsHead":
        return cls(part_names=part_names or config.part_names, output_stride=config.output_stride)


@dataclass
class MultiInstanceConfmapsHead(Head):
    part_names: List[str] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.part_names)

    @classmethod
    def from_config(cls, config, part_names=None) -> "MultiInstanceConfmapsHead":
        return cls(part_names=part_names or config.part_names, output_stride=config.output_stride)


@dataclass
class PartAffinityFieldsHead(Head):
    edges: Sequence[Tuple[str, str]] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.edges) * 2

    @classmethod
    def from_config(cls, config, edges=None) -> "PartAffinityFieldsHead":
        return cls(edges=edges or config.edges, output_stride=config.output_stride)


@dataclass
class ClassMapsHead(Head):
    """Per-pixel class probabilities: one sigmoid map per class."""

    classes: List[str] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.classes)

    @property
    def activation(self) -> str:
        return "sigmoid"

    @classmethod
    def from_config(cls, config, classes=None) -> "ClassMapsHead":
        return cls(classes=classes or config.classes, output_stride=config.output_stride)


@dataclass
class ClassVectorsHead(Head):
    """Class probabilities of a whole crop: the feature at ``output_stride``,
    averaged over space (``global_pool``) or flattened, through
    ``num_fc_layers`` dense + ReLU layers of ``num_fc_units``, then a dense
    layer and a softmax over the classes."""

    classes: List[str] = field(default_factory=list)
    num_fc_layers: int = 1
    num_fc_units: int = 64
    global_pool: bool = True

    @property
    def channels(self) -> int:
        return len(self.classes)

    @property
    def activation(self) -> str:
        return "softmax"

    @classmethod
    def from_config(cls, config, classes=None) -> "ClassVectorsHead":
        return cls(
            classes=classes or config.classes,
            num_fc_layers=config.num_fc_layers,
            num_fc_units=config.num_fc_units,
            global_pool=config.global_pool,
            output_stride=config.output_stride,
        )


@dataclass
class OffsetRefinementHead(Head):
    """Learned subpixel offsets: 2 channels per part. A centroid head has
    one part, its (possibly unset) anchor."""

    part_names: List[Optional[str]] = field(default_factory=list)

    @property
    def channels(self) -> int:
        return len(self.part_names) * 2

    @classmethod
    def from_config(cls, config, part_names=None) -> "OffsetRefinementHead":
        if part_names is None:
            if getattr(config, "part_names", None) is not None:
                part_names = config.part_names
            elif hasattr(config, "anchor_part"):
                part_names = [config.anchor_part]
        return cls(part_names=part_names, output_stride=config.output_stride)
