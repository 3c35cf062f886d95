"""Training job configuration: the fields of ``training_config.json`` that
inference reads.

A dataclass copy of part of :mod:`sleap_tpu.config` (same field names and
defaults), so run folders load with plain Python: no ``attr``, no JAX
package. It covers the labels' skeletons, the preprocessing and cropping
fields inference reads (input scaling, pad to stride, ImageNet mode, crop
size), the UNet backbone (the other backbones are kept as raw dicts, enough to see
that ``unet`` is None), and every head type, so that ``which_oneof`` names
a head group the port does not run yet. Unknown fields are ignored and
``//`` and ``/* */`` comments stripped, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import typing
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

from sleap_tpu_torch.core.skeleton import Skeleton


class _OneOf:
    """``which_oneof`` over a dataclass whose fields are alternatives."""

    @property
    def which_oneof_attrib_name(self) -> Optional[str]:
        set_fields = [f.name for f in dataclasses.fields(self) if getattr(self, f.name) is not None]
        if len(set_fields) > 1:
            raise ValueError(f"Only one of {type(self).__name__} may be set; got {set_fields}.")
        return set_fields[0] if set_fields else None

    @property
    def which_oneof(self):
        name = self.which_oneof_attrib_name
        return getattr(self, name) if name else None


# --------------------------------------------------------------------------- #
# Heads
# --------------------------------------------------------------------------- #


@dataclass
class SingleInstanceConfmapsHeadConfig:
    part_names: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0
    offset_refinement: bool = False


@dataclass
class CentroidsHeadConfig:
    anchor_part: Optional[str] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0
    offset_refinement: bool = False


@dataclass
class CenteredInstanceConfmapsHeadConfig:
    anchor_part: Optional[str] = None
    part_names: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0
    offset_refinement: bool = False


@dataclass
class MultiInstanceConfmapsHeadConfig:
    part_names: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0
    offset_refinement: bool = False


@dataclass
class PartAffinityFieldsHeadConfig:
    edges: Optional[Sequence[Tuple[str, str]]] = None
    sigma: float = 15.0
    output_stride: int = 1
    loss_weight: float = 1.0


@dataclass
class MultiInstanceConfig:
    confmaps: MultiInstanceConfmapsHeadConfig = field(default_factory=MultiInstanceConfmapsHeadConfig)
    pafs: PartAffinityFieldsHeadConfig = field(default_factory=PartAffinityFieldsHeadConfig)


@dataclass
class ClassMapsHeadConfig:
    classes: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0


@dataclass
class MultiClassBottomUpConfig:
    confmaps: MultiInstanceConfmapsHeadConfig = field(default_factory=MultiInstanceConfmapsHeadConfig)
    class_maps: ClassMapsHeadConfig = field(default_factory=ClassMapsHeadConfig)


@dataclass
class ClassVectorsHeadConfig:
    classes: Optional[List[str]] = None
    num_fc_layers: int = 1
    num_fc_units: int = 64
    global_pool: bool = True
    output_stride: int = 1
    loss_weight: float = 1.0


@dataclass
class MultiClassTopDownConfig:
    confmaps: CenteredInstanceConfmapsHeadConfig = field(
        default_factory=CenteredInstanceConfmapsHeadConfig
    )
    class_vectors: ClassVectorsHeadConfig = field(default_factory=ClassVectorsHeadConfig)


@dataclass
class HeadsConfig(_OneOf):
    """Exactly one head group may be set."""

    single_instance: Optional[SingleInstanceConfmapsHeadConfig] = None
    centroid: Optional[CentroidsHeadConfig] = None
    centered_instance: Optional[CenteredInstanceConfmapsHeadConfig] = None
    multi_instance: Optional[MultiInstanceConfig] = None
    multi_class_bottomup: Optional[MultiClassBottomUpConfig] = None
    multi_class_topdown: Optional[MultiClassTopDownConfig] = None


# --------------------------------------------------------------------------- #
# Backbones
# --------------------------------------------------------------------------- #


@dataclass
class UNetConfig:
    stem_stride: Optional[int] = None
    max_stride: int = 16
    output_stride: int = 1
    filters: int = 64
    filters_rate: float = 2
    middle_block: bool = True
    up_interpolate: bool = False
    stacks: int = 1
    space_to_depth: int = 1
    fold_s2d_stem: Optional[bool] = None


@dataclass
class BackboneConfig(_OneOf):
    """Exactly one backbone may be set; only the UNet is ported, the others
    stay raw dicts."""

    leap: Optional[dict] = None
    unet: Optional[UNetConfig] = None
    hourglass: Optional[dict] = None
    resnet: Optional[dict] = None
    pretrained_encoder: Optional[dict] = None
    hrnet: Optional[dict] = None


@dataclass
class ModelConfig:
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    heads: HeadsConfig = field(default_factory=HeadsConfig)


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #


@dataclass
class LabelsConfig:
    skeletons: List[Skeleton] = field(default_factory=list)


@dataclass
class PreprocessingConfig:
    imagenet_mode: Optional[str] = None
    input_scaling: float = 1.0
    pad_to_stride: Optional[int] = None


@dataclass
class InstanceCroppingConfig:
    crop_size: Optional[int] = None


@dataclass
class DataConfig:
    labels: LabelsConfig = field(default_factory=LabelsConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    instance_cropping: InstanceCroppingConfig = field(default_factory=InstanceCroppingConfig)


# --------------------------------------------------------------------------- #
# Root
# --------------------------------------------------------------------------- #


@dataclass
class TrainingJobConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    filename: Optional[str] = ""

    @classmethod
    def from_json(cls, json_data: str) -> "TrainingJobConfig":
        return _structure(cls, json.loads(_strip_comments(json_data)))

    @classmethod
    def load_json(cls, filename: str) -> "TrainingJobConfig":
        """Load from a JSON file or a run folder (``training_config.json``,
        else ``initial_config.json``)."""
        if os.path.isdir(filename):
            for cand in ("training_config.json", "initial_config.json"):
                path = os.path.join(filename, cand)
                if os.path.exists(path):
                    filename = path
                    break
            else:
                raise FileNotFoundError(f"No config JSON found in {filename}.")
        with open(filename, "r") as f:
            cfg = cls.from_json(f.read())
        cfg.filename = filename
        return cfg

    def to_json(self) -> str:
        """The JSON form ``load_json`` reads (skeletons in jsonpickle form)."""
        return json.dumps(_unstructure(self), indent=4)

    def save_json(self, filename: str) -> None:
        with open(filename, "w") as f:
            f.write(self.to_json())


# --------------------------------------------------------------------------- #
# JSON (de)structuring
# --------------------------------------------------------------------------- #

_COMMENT_RE = re.compile(r"^\s*//.*$", re.MULTILINE)
_BLOCK_COMMENT_RE = re.compile(r"/\*.*?\*/", re.DOTALL)


def _strip_comments(text: str) -> str:
    """Drop whole-line ``//`` and ``/* */`` comments; string values that
    contain e.g. ``http://`` are untouched."""
    return _COMMENT_RE.sub("", _BLOCK_COMMENT_RE.sub("", text))


def _dataclass_of(tp) -> Optional[type]:
    """The dataclass a field holds, unwrapping ``Optional[...]``."""
    if dataclasses.is_dataclass(tp):
        return tp
    if typing.get_origin(tp) is typing.Union:
        inner = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(inner) == 1 and dataclasses.is_dataclass(inner[0]):
            return inner[0]
    return None


def _structure(cls, data: Any):
    """A dataclass from a JSON dict: unknown keys are ignored, nested
    dataclasses recurse, and skeletons decode from their jsonpickle form."""
    if data is None:
        return None
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        target = _dataclass_of(hints[f.name])
        if f.name == "skeletons" and isinstance(value, list):
            value = [Skeleton.from_dict(s) if isinstance(s, dict) else s for s in value]
        elif target is not None:
            value = _structure(target, value)
        kwargs[f.name] = value
    return cls(**kwargs)


def _unstructure(obj: Any):
    if isinstance(obj, Skeleton):
        return obj.to_dict()
    if dataclasses.is_dataclass(obj):
        return {f.name: _unstructure(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_unstructure(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _unstructure(v) for k, v in obj.items()}
    return obj
