"""Task data pipeline builders (port of :mod:`sleap_tpu.data.pipelines`).

The six builders have the JAX package's names, attributes and methods:

- ``make_base_pipeline``: host batches (image and instance points) with
  threaded prefetch;
- ``make_training_pipeline``: batches with their ground truth (confidence
  maps, PAFs, offsets, class maps or vectors), built by the port's trainer
  of the head type (:meth:`~sleap_tpu_torch.training.trainer.Trainer.make_batch`
  and ``build_gt_fn``) on the builder's ``device``: the uint8 frames are
  staged there (:func:`~sleap_tpu_torch.data.streaming.stage_to_device`),
  normalized, augmented, resized, padded or cropped, and the maps made
  there; each batch comes back as host numpy;
- ``make_viz_pipeline``: batches of one example.

Random streams: the example order comes from ``np.random.default_rng(seed)``
as in JAX; the augmentation draws from a ``torch.Generator`` on the device
seeded with ``seed``, in place of JAX's ``PRNGKey(seed)``, so with
augmentation on the two packages draw differently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.data.prefetch import prefetch
from sleap_tpu_torch.data.providers import LabelsReader, batch_examples
from sleap_tpu_torch.data.streaming import stage_to_device
from sleap_tpu_torch.precision import ieee_fp32

Device = Union[str, torch.device]


@dataclass
class Pipeline:
    """A provider, host batching and, for training, the ground-truth
    function on ``device``.

    Iterates ``(batch dict, n_valid)``. With ``gt_fn`` set, each batch holds
    the float input images under ``"image"``, the host ``"instances"``, and
    one key per supervised head output with its ground truth; the last
    batch is padded to ``batch_size`` by repeating examples.
    """

    provider: Any
    batch_size: int = 4
    prefetch_buffer: int = 2
    gt_fn: Optional[Any] = None  # (device batch, torch.Generator) -> (images, gt dict)
    example_maker: Optional[Any] = None  # examples, rng -> host batch (trainer.make_batch)
    examples: Optional[list] = None  # preloaded training examples
    shuffle: bool = False
    seed: int = 0
    device: Device = field(default_factory=lambda: torch.device("cuda"))

    def make_dataset(self) -> Iterator[Tuple[dict, int]]:
        """Iterate ``(batch, n_valid)`` with threaded prefetch."""
        if self.gt_fn is None:
            return prefetch(batch_examples(self.provider, self.batch_size),
                            buffer_size=self.prefetch_buffer)
        return self._training_iter()

    def __iter__(self) -> Iterator[Tuple[dict, int]]:
        return self.make_dataset()

    def _host_batches(self, rng: np.random.Generator) -> Iterator[Tuple[dict, int]]:
        n = len(self.examples)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            n_valid = len(idx)
            # The last batch is padded to the batch size by repeating examples.
            idx = np.concatenate([idx, idx[:self.batch_size - n_valid]])
            while len(idx) < self.batch_size:
                idx = np.concatenate([idx, idx])[:self.batch_size]
            yield self.example_maker([self.examples[i] for i in idx], rng), n_valid

    def _training_iter(self) -> Iterator[Tuple[dict, int]]:
        rng = np.random.default_rng(self.seed)
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        for batch, n_valid, image in stage_to_device(self._host_batches(rng), self.device):
            dev = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                   for k, v in batch.items() if k != "image"}
            dev["image"] = image
            with ieee_fp32(), torch.no_grad():
                imgs, gt = self.gt_fn(dev, generator)
                out = {"image": imgs.cpu().numpy(), "instances": batch["instances"]}
                out.update({k: v.cpu().numpy() for k, v in gt.items()})
            yield out, n_valid


def _labels_of(provider) -> Labels:
    if isinstance(provider, Labels):
        return provider
    if isinstance(provider, LabelsReader):
        return provider.labels
    raise ValueError("Training pipelines need labeled data (Labels or LabelsReader); "
                     f"got {type(provider).__name__}.")


@dataclass
class _BasePipelineBuilder:
    """What the six builders share. Each sets ``head_name`` and holds its
    head configs under the JAX package's attribute names."""

    data_config: Any = None
    optimization_config: Any = None
    head_name: str = ""
    device: Device = field(default_factory=lambda: torch.device("cuda"), kw_only=True)

    def _head_configs(self) -> Dict[str, Any]:
        """The head configs this builder was given, by their ``HeadsConfig``
        field name."""
        raise NotImplementedError

    def _make_trainer(self, labels: Labels):
        """The port's trainer of this head type on ``device``, set up for
        data only (no module is built: the pipeline runs no model)."""
        from sleap_tpu_torch import config as cfg
        from sleap_tpu_torch.training.trainer import Trainer

        job = cfg.TrainingJobConfig()
        if self.data_config is not None:
            job.data = self.data_config
        if self.optimization_config is not None:
            job.optimization = self.optimization_config
        for name, value in self._head_configs().items():
            setattr(job.model.heads, name, value)
        # A tiny backbone, as JAX's: the trainer needs one to be built.
        if job.model.backbone.which_oneof is None:
            job.model.backbone.unet = cfg.UNetConfig(max_stride=2, output_stride=2, filters=1)
        job.outputs.save_outputs = False
        trainer = Trainer.from_config(job, training_labels=labels, validation_labels=labels,
                                      device=self.device)
        trainer._max_instances = max(
            (len(lf.training_instances)
             for lf in trainer.data_readers.training_labels.labeled_frames),
            default=1,
        ) or 1
        trainer._input_channels = trainer._image_channels()
        return trainer

    def make_base_pipeline(self, data_provider) -> Pipeline:
        batch = getattr(self.optimization_config, "batch_size", 4)
        return Pipeline(provider=data_provider, batch_size=batch, device=self.device)

    def make_training_pipeline(self, data_provider) -> Pipeline:
        from sleap_tpu_torch.training.trainer import preload_examples

        labels = _labels_of(data_provider)
        trainer = self._make_trainer(labels)
        examples = preload_examples(trainer.data_readers.training_labels, trainer._max_instances)
        if hasattr(trainer, "expand_examples"):
            # The crop trainers take one example a (frame, instance) pair.
            examples = trainer.expand_examples(examples)
        batch = getattr(self.optimization_config, "batch_size", 4) or 4
        return Pipeline(
            provider=data_provider,
            batch_size=batch,
            gt_fn=trainer.build_gt_fn(),
            example_maker=trainer.make_batch,
            examples=examples,
            shuffle=True,
            device=self.device,
        )

    def make_viz_pipeline(self, data_provider) -> Pipeline:
        return Pipeline(provider=data_provider, batch_size=1, device=self.device)

    @property
    def trainer_cls(self):
        from sleap_tpu_torch.training import trainer as T

        return {
            "single_instance": T.SingleInstanceTrainer,
            "centroid": T.CentroidTrainer,
            "centered_instance": T.TopdownConfmapsTrainer,
            "multi_instance": T.BottomUpTrainer,
            "multi_class_bottomup": T.BottomUpMultiClassTrainer,
            "multi_class_topdown": T.TopDownMultiClassTrainer,
        }[self.head_name]


@dataclass
class SingleInstanceConfmapsPipeline(_BasePipelineBuilder):
    single_instance_confmap_head: Any = None
    head_name: str = "single_instance"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"single_instance": self.single_instance_confmap_head
                or cfg.SingleInstanceConfmapsHeadConfig()}


@dataclass
class CentroidConfmapsPipeline(_BasePipelineBuilder):
    centroid_confmap_head: Any = None
    head_name: str = "centroid"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"centroid": self.centroid_confmap_head or cfg.CentroidsHeadConfig()}


@dataclass
class TopdownConfmapsPipeline(_BasePipelineBuilder):
    instance_confmap_head: Any = None
    head_name: str = "centered_instance"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"centered_instance": self.instance_confmap_head
                or cfg.CenteredInstanceConfmapsHeadConfig()}


@dataclass
class BottomUpPipeline(_BasePipelineBuilder):
    confmaps_head: Any = None
    pafs_head: Any = None
    head_name: str = "multi_instance"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"multi_instance": cfg.MultiInstanceConfig(
            confmaps=self.confmaps_head or cfg.MultiInstanceConfmapsHeadConfig(),
            pafs=self.pafs_head or cfg.PartAffinityFieldsHeadConfig(),
        )}


@dataclass
class BottomUpMultiClassPipeline(_BasePipelineBuilder):
    confmaps_head: Any = None
    class_maps_head: Any = None
    head_name: str = "multi_class_bottomup"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"multi_class_bottomup": cfg.MultiClassBottomUpConfig(
            confmaps=self.confmaps_head or cfg.MultiInstanceConfmapsHeadConfig(),
            class_maps=self.class_maps_head or cfg.ClassMapsHeadConfig(),
        )}


@dataclass
class TopDownMultiClassPipeline(_BasePipelineBuilder):
    instance_confmap_head: Any = None
    class_vectors_head: Any = None
    head_name: str = "multi_class_topdown"

    def _head_configs(self):
        from sleap_tpu_torch import config as cfg

        return {"multi_class_topdown": cfg.MultiClassTopDownConfig(
            confmaps=self.instance_confmap_head or cfg.CenteredInstanceConfmapsHeadConfig(),
            class_vectors=self.class_vectors_head or cfg.ClassVectorsHeadConfig(),
        )}
