"""Training job configuration: ``training_config.json``.

A dataclass copy of :mod:`sleap_tpu.config` (same field names and
defaults), so run folders load and training runs with plain Python: no
``attr``, no JAX package. It covers the data (labels, preprocessing,
cropping), the UNet backbone (the other backbones are kept as raw dicts,
enough to see that ``unet`` is None), every head type, the optimization
(augmentation, hard keypoint mining, learning-rate schedule, early
stopping) and the outputs (checkpoints, TensorBoard, ZMQ), so a config
written by either package reads back equal in the other. Unknown fields are
ignored and ``//`` and ``/* */`` comments stripped, as in the JAX package.
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
    base_checkpoint: Optional[str] = None


# --------------------------------------------------------------------------- #
# Data
# --------------------------------------------------------------------------- #


@dataclass
class LabelsConfig:
    training_labels: Optional[str] = None
    validation_labels: Optional[str] = None
    validation_fraction: float = 0.1
    test_labels: Optional[str] = None
    split_by_inds: bool = False
    training_inds: Optional[List[int]] = None
    validation_inds: Optional[List[int]] = None
    test_inds: Optional[List[int]] = None
    search_path_hints: List[str] = field(default_factory=list)
    skeletons: List[Skeleton] = field(default_factory=list)


@dataclass
class PreprocessingConfig:
    ensure_rgb: bool = False
    ensure_grayscale: bool = False
    imagenet_mode: Optional[str] = None
    input_scaling: float = 1.0
    pad_to_stride: Optional[int] = None
    resize_and_pad_to_target: bool = True
    target_height: Optional[int] = None
    target_width: Optional[int] = None


@dataclass
class InstanceCroppingConfig:
    center_on_part: Optional[str] = None
    crop_size: Optional[int] = None
    crop_size_detection_padding: int = 16


@dataclass
class DataConfig:
    labels: LabelsConfig = field(default_factory=LabelsConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    instance_cropping: InstanceCroppingConfig = field(default_factory=InstanceCroppingConfig)


# --------------------------------------------------------------------------- #
# Optimization
# --------------------------------------------------------------------------- #


@dataclass
class AugmentationConfig:
    rotate: bool = False
    rotation_min_angle: float = -180
    rotation_max_angle: float = 180
    translate: bool = False
    translate_min: int = -5
    translate_max: int = 5
    scale: bool = False
    scale_min: float = 0.9
    scale_max: float = 1.1
    uniform_noise: bool = False
    uniform_noise_min_val: float = 0.0
    uniform_noise_max_val: float = 10.0
    gaussian_noise: bool = False
    gaussian_noise_mean: float = 5.0
    gaussian_noise_stddev: float = 1.0
    contrast: bool = False
    contrast_min_gamma: float = 0.5
    contrast_max_gamma: float = 2.0
    brightness: bool = False
    brightness_min_val: float = 0.0
    brightness_max_val: float = 10.0
    random_crop: bool = False
    random_crop_height: int = 256
    random_crop_width: int = 256
    random_flip: bool = False
    flip_horizontal: bool = True


@dataclass
class HardKeypointMiningConfig:
    online_mining: bool = False
    hard_to_easy_ratio: float = 2.0
    min_hard_keypoints: int = 2
    max_hard_keypoints: Optional[int] = None
    loss_scale: float = 5.0


@dataclass
class LearningRateScheduleConfig:
    reduce_on_plateau: bool = True
    reduction_factor: float = 0.5
    plateau_min_delta: float = 1e-6
    plateau_patience: int = 5
    plateau_cooldown: int = 3
    min_learning_rate: float = 1e-8


@dataclass
class EarlyStoppingConfig:
    stop_training_on_plateau: bool = True
    plateau_min_delta: float = 1e-6
    plateau_patience: int = 10


@dataclass
class OptimizationConfig:
    """``mixed_precision`` runs the forward and backward in bf16 while the
    parameters, the optimizer state and the loss stay float32."""

    preload_data: bool = True
    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    online_shuffling: bool = True
    shuffle_buffer_size: int = 128
    prefetch: bool = True
    batch_size: int = 8
    batches_per_epoch: Optional[int] = None
    min_batches_per_epoch: int = 200
    val_batches_per_epoch: Optional[int] = None
    min_val_batches_per_epoch: int = 10
    epochs: int = 100
    optimizer: str = "adam"
    initial_learning_rate: float = 1e-4
    learning_rate_schedule: LearningRateScheduleConfig = field(
        default_factory=LearningRateScheduleConfig
    )
    hard_keypoint_mining: HardKeypointMiningConfig = field(
        default_factory=HardKeypointMiningConfig
    )
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    mixed_precision: bool = False


# --------------------------------------------------------------------------- #
# Outputs
# --------------------------------------------------------------------------- #


@dataclass
class CheckpointingConfig:
    initial_model: bool = False
    best_model: bool = True
    every_epoch: bool = False
    latest_model: bool = False
    final_model: bool = False


@dataclass
class TensorBoardConfig:
    write_logs: bool = False
    loss_frequency: str = "epoch"
    architecture_graph: bool = False
    profile_graph: bool = False
    visualizations: bool = True


@dataclass
class ZMQConfig:
    subscribe_to_controller: bool = False
    controller_address: str = "tcp://127.0.0.1:9000"
    controller_polling_timeout: int = 10
    publish_updates: bool = False
    publish_address: str = "tcp://127.0.0.1:9001"


@dataclass
class OutputsConfig:
    save_outputs: bool = True
    run_name: Optional[str] = None
    run_name_prefix: str = ""
    run_name_suffix: Optional[str] = None
    runs_folder: str = "models"
    tags: List[str] = field(default_factory=list)
    save_visualizations: bool = True
    keep_viz_images: bool = False
    zip_outputs: bool = False
    log_to_csv: bool = True
    checkpointing: CheckpointingConfig = field(default_factory=CheckpointingConfig)
    tensorboard: TensorBoardConfig = field(default_factory=TensorBoardConfig)
    zmq: ZMQConfig = field(default_factory=ZMQConfig)

    @property
    def run_path(self) -> str:
        if self.run_name is None:
            raise ValueError("run_name must be set to determine run_path.")
        name = f"{self.run_name_prefix}{self.run_name}{self.run_name_suffix or ''}"
        return os.path.join(self.runs_folder, name)


# --------------------------------------------------------------------------- #
# Root
# --------------------------------------------------------------------------- #

# The JAX package's version, which its configs carry as ``sleap_version``.
SLEAP_VERSION = "0.1.0"


@dataclass
class TrainingJobConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    outputs: OutputsConfig = field(default_factory=OutputsConfig)
    name: Optional[str] = ""
    description: Optional[str] = ""
    sleap_version: Optional[str] = SLEAP_VERSION
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


def load_config(filename: str) -> TrainingJobConfig:
    """A training config from a JSON file or a run folder
    (``sleap.load_config``)."""
    return TrainingJobConfig.load_json(filename)


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
