"""Output head descriptors: name, channels, activation and stride of each
1x1 conv head the port builds.

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
