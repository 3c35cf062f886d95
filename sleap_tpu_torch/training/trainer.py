"""Training: config -> PyTorch train loop -> a run folder ``load_model`` reads.

Port of :mod:`sleap_tpu.training.trainer`: the data splitting and
preloading, the host-side schedule callbacks, the base :class:`Trainer` and
its six per-head trainers, with the JAX loop's behaviour:

- batches are drawn with ``np.random.default_rng(0)`` in the same call
  order (each epoch its train batches, then its validation batches), so
  with augmentation off the port trains on the JAX package's batches;
- a step runs on the trainer's device (``"cuda"`` unless the caller asks for
  another, with no fallback): uint8 frames are staged there
  (:func:`~sleap_tpu_torch.data.streaming.stage_to_device`) and normalized,
  augmented (draws from a ``torch.Generator`` on the device), resized and
  padded there; the ground-truth maps are built there, batched over
  samples and instances (:mod:`sleap_tpu_torch.ops.confmaps`, ``offsets``,
  ``edge_maps``); then the forward, the loss, the backward and the update;
- per-step losses stay on the device until the epoch ends;
- ``mixed_precision`` runs the forward and backward under bf16 autocast in
  channels-last memory while the parameters, batch-norm statistics,
  optimizer state and loss stay float32;
- every backbone trains; weights start as the JAX package's ``Model.init``
  gives them (:meth:`~sleap_tpu_torch.models.model.Model.init`: flax's
  initialization, then the pretrained encoders' local weights);
- batch norm follows flax's rule
  (:class:`~sleap_tpu_torch.models.encoder_decoder.FlaxBatchNorm2d`): a
  train step's one forward normalises with the batch's statistics and moves
  the running ones once; validation and evaluation run on the running
  statistics and move nothing;
- frames of a project whose videos differ in size are matched to the
  largest height and width on the host, and that size is recorded in the
  config (``target_height``, ``target_width``) as upstream SLEAP records it
  and the JAX trainer does not, so predictors match frames to it.

A run folder holds ``initial_config.json``, ``training_config.json`` (part
names, edges and classes filled in), ``training_log.csv`` and the
checkpoints ``CheckpointingConfig`` asks for as ``torch.save`` files of the
module's float32 CPU ``state_dict`` (``best_model.pt``, ``latest_model.pt``,
...), PyTorch's counterpart of the JAX package's orbax directories;
:func:`~sleap_tpu_torch.inference.predictors.load_trained_model` reads
``best_model.pt``. After training, as in JAX, the split labels are saved as
``labels_gt.{train,val}.slp`` and the folder's model is scored on both
splits on the trainer's device (:func:`~sleap_tpu_torch.evals.evaluate_model`:
``labels_pr.{split}.slp``, ``metrics.{split}.npz``). Not ported (ROADMAP.md,
queue 1): visualizations, TensorBoard and ZMQ, and data-parallel training.
"""

from __future__ import annotations

import contextlib
import csv
import logging
import os
import shutil
import time
from datetime import datetime
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.core.labels import Labels, load_file
from sleap_tpu_torch.data.augmentation import augment
from sleap_tpu_torch.data.instance_centroids import get_instance_centroids
from sleap_tpu_torch.data.normalization import (
    apply_imagenet_mode,
    ensure_float,
    ensure_grayscale,
    ensure_rgb,
)
from sleap_tpu_torch.data.resizing import pad_to_stride, resize_image, resize_linear_uint8
from sleap_tpu_torch.data.streaming import stage_to_device
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.ops.confmaps import (
    make_confmaps,
    make_multi_confmaps,
    make_multi_confmaps_with_offsets,
)
from sleap_tpu_torch.ops.edge_maps import get_edge_points, make_multi_pafs
from sleap_tpu_torch.ops.grid import make_grid_vectors
from sleap_tpu_torch.ops.offsets import make_offsets, mask_offsets
from sleap_tpu_torch.ops.peak_finding import crop_and_resize, make_centered_bboxes
from sleap_tpu_torch.precision import ieee_fp32
from sleap_tpu_torch.training.losses import categorical_crossentropy, compute_ohkm_loss, mse_loss
from sleap_tpu_torch.training.optimizers import make_optimizer, set_learning_rate

logger = logging.getLogger(__name__)

Batch = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Data splitting / preloading
# --------------------------------------------------------------------------- #


class DataReaders:
    """Train, validation and test labels."""

    def __init__(self, training_labels: Labels, validation_labels: Labels,
                 test_labels: Optional[Labels] = None):
        self.training_labels = training_labels
        self.validation_labels = validation_labels
        self.test_labels = test_labels

    @classmethod
    def from_config(cls, labels_config, training: Any = None, validation: Any = None,
                    test: Any = None) -> "DataReaders":
        """In-memory ``Labels`` or ``.slp`` paths. Only user instances
        train; without validation labels, the training labels are split by
        the config's indices or fraction."""

        def load(x):
            if x is None or isinstance(x, Labels):
                return x
            return load_file(x)

        training = load(training or labels_config.training_labels)
        validation = load(validation or labels_config.validation_labels)
        test = load(test or labels_config.test_labels)
        if training is None:
            raise ValueError("Training labels must be provided.")
        training = training.with_user_labels_only(copy=False)
        if validation is None:
            if labels_config.split_by_inds and labels_config.validation_inds:
                validation = training.extract(labels_config.validation_inds)
                training = training.extract(labels_config.training_inds)
            else:
                training, validation = training.split(1.0 - labels_config.validation_fraction)
        else:
            validation = validation.with_user_labels_only(copy=False)
        return cls(training, validation, test)


def size_match_image(img: np.ndarray, target_hw: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Scale a frame to fit inside ``target_hw`` (OpenCV's bilinear resize,
    done here: :func:`~sleap_tpu_torch.data.resizing.resize_linear_uint8`)
    and pad it bottom/right; points map as ``pts * scale``. Returns
    (matched image, scale)."""
    th, tw = target_hw
    h, w = img.shape[0], img.shape[1]
    if (h, w) == (th, tw):
        return img, 1.0
    scale = min(th / h, tw / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    if (new_h, new_w) != (h, w):
        resized = resize_linear_uint8(img, (new_h, new_w))
        if resized.ndim == 2:
            resized = resized[..., None]
    else:
        resized = img
    out = np.zeros((th, tw) + img.shape[2:], img.dtype)
    out[:new_h, :new_w] = resized
    return out, scale


def build_example(
    lf,
    labels: Labels,
    max_instances: int,
    target_hw: Optional[Tuple[int, int]] = None,
    class_names: Optional[List[str]] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """One labeled frame -> ``{"image", "instances", "track_inds"}`` (or
    None without training instances): points NaN-padded to
    ``max_instances``; track indices into ``class_names`` by name when
    given (the head's class order), else into ``labels.tracks``; -1 for
    none."""
    insts = lf.training_instances
    if not insts:
        return None
    try:
        img = lf.image
    except Exception:
        return None
    scale = 1.0
    if target_hw is not None:
        img, scale = size_match_image(np.asarray(img), target_hw)
    pts = np.full((max_instances, insts[0].skeleton.n_nodes, 2), np.nan, "f4")
    tracks = np.full(max_instances, -1, "i4")
    for i, inst in enumerate(insts[:max_instances]):
        pts[i] = inst.numpy() * scale
        if inst.track is None:
            continue
        if class_names is not None:
            if inst.track.name in class_names:
                tracks[i] = class_names.index(inst.track.name)
        elif inst.track in labels.tracks:  # tracks compare by identity
            tracks[i] = labels.tracks.index(inst.track)
    return {"image": img, "instances": pts, "track_inds": tracks}


def preload_examples(labels: Labels, max_instances: int,
                     target_hw: Optional[Tuple[int, int]] = None,
                     class_names: Optional[List[str]] = None) -> List[Dict[str, np.ndarray]]:
    """Every labeled frame's example, decoded into memory."""
    examples = []
    for lf in labels.labeled_frames:
        ex = build_example(lf, labels, max_instances, target_hw, class_names)
        if ex is not None:
            examples.append(ex)
    return examples


class LazyExamples:
    """Examples decoded on access instead of preloaded, for projects too
    large to hold in memory."""

    def __init__(self, labels: Labels, max_instances: int,
                 target_hw: Optional[Tuple[int, int]] = None,
                 class_names: Optional[List[str]] = None):
        self.labels = labels
        self.max_instances = max_instances
        self.target_hw = target_hw
        self.class_names = class_names
        self._lfs = [lf for lf in labels.labeled_frames if lf.training_instances]

    def __len__(self) -> int:
        return len(self._lfs)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        ex = build_example(self._lfs[i], self.labels, self.max_instances, self.target_hw,
                           self.class_names)
        if ex is None:
            raise RuntimeError(f"Failed to decode frame {self._lfs[i].frame_idx} while streaming.")
        return ex

    def expand_instances(self) -> "LazyInstanceExamples":
        """Per-instance view (crop trainers) without decoding frames."""
        return LazyInstanceExamples(self)


class LazyInstanceExamples:
    """Flat (frame, instance) indexing over :class:`LazyExamples`."""

    def __init__(self, base: LazyExamples):
        self.base = base
        self._index = [
            (fi, ci)
            for fi, lf in enumerate(base._lfs)
            for ci in range(min(len(lf.training_instances), base.max_instances))
        ]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        fi, ci = self._index[i]
        return {**self.base[fi], "ctr_ind": ci}


def find_instance_crop_size(labels: Labels, padding: int = 0, maximum_stride: int = 2,
                            input_scaling: float = 1.0,
                            min_crop_size: Optional[int] = None) -> int:
    """The dataset's crop size: the largest instance extent plus
    ``padding``, rounded up to the stride."""
    min_crop_size = 0 if min_crop_size is None else min_crop_size
    if min_crop_size > 0 and min_crop_size % maximum_stride == 0:
        return min_crop_size
    max_length = 0.0
    for inst in labels.user_instances:
        pts = inst.numpy() * input_scaling
        with np.errstate(all="ignore"):
            max_length = max(
                max_length,
                np.nanmax(pts[:, 0]) - np.nanmin(pts[:, 0]),
                np.nanmax(pts[:, 1]) - np.nanmin(pts[:, 1]),
                min_crop_size - padding,
            )
    max_length += float(padding)
    return int(np.ceil(max_length / maximum_stride) * maximum_stride)


# --------------------------------------------------------------------------- #
# Host-side schedule callbacks
# --------------------------------------------------------------------------- #


class ReduceLROnPlateau:
    """Halve (``reduction_factor``) the learning rate after
    ``plateau_patience`` epochs without a validation gain, then wait
    ``plateau_cooldown`` epochs."""

    def __init__(self, cfg, initial_lr: float):
        self.cfg = cfg
        self.lr = initial_lr
        self.best = np.inf
        self.wait = 0
        self.cooldown = 0

    def update(self, val_loss: float) -> float:
        if not self.cfg.reduce_on_plateau:
            return self.lr
        if self.cooldown > 0:
            self.cooldown -= 1
            self.best = min(self.best, val_loss)
            return self.lr
        if val_loss < self.best - self.cfg.plateau_min_delta:
            self.best = val_loss
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.cfg.plateau_patience:
                self.lr = max(self.lr * self.cfg.reduction_factor, self.cfg.min_learning_rate)
                self.wait = 0
                self.cooldown = self.cfg.plateau_cooldown
                logger.info("Reducing learning rate to %g", self.lr)
        return self.lr


class EarlyStopping:
    """Stop after ``plateau_patience`` epochs without a validation gain."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.best = np.inf
        self.wait = 0

    def should_stop(self, val_loss: float) -> bool:
        if not self.cfg.stop_training_on_plateau:
            return False
        if val_loss < self.best - self.cfg.plateau_min_delta:
            self.best = val_loss
            self.wait = 0
            return False
        self.wait += 1
        return self.wait >= self.cfg.plateau_patience


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #


def _one_hot(inds: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: float32, all 0 for an index out of range (-1)."""
    return (inds[..., None] == torch.arange(n, device=inds.device)).float()


class Trainer:
    """Base trainer; the per-head subclasses build the batches and the
    ground truth."""

    def __init__(self, config: TrainingJobConfig, data_readers: DataReaders, model: Model,
                 device: Union[str, torch.device] = "cuda"):
        self.config = config
        self.data_readers = data_readers
        self.model = model
        self.device = torch.device(device)
        self.module: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.run_path: Optional[str] = None
        self._train_examples: Any = []
        self._val_examples: Any = []
        self._max_instances = 1
        self._input_channels = 1
        self._gt_fn: Optional[Callable] = None
        self.log_rows: List[Dict[str, float]] = []

    @classmethod
    def from_config(cls, config: TrainingJobConfig, training_labels: Any = None,
                    validation_labels: Any = None, test_labels: Any = None,
                    device: Union[str, torch.device] = "cuda") -> "Trainer":
        """The trainer of the config's head type, on ``device`` (the card by
        default; pass ``device="cpu"`` for the CPU: there is no fallback).
        Part names, edges and classes the config leaves unset are filled in
        from the labels' skeleton and tracks."""
        head_name = config.model.heads.which_oneof_attrib_name
        trainer_cls = {
            "single_instance": SingleInstanceTrainer,
            "centroid": CentroidTrainer,
            "centered_instance": TopdownConfmapsTrainer,
            "multi_instance": BottomUpTrainer,
            "multi_class_bottomup": BottomUpMultiClassTrainer,
            "multi_class_topdown": TopDownMultiClassTrainer,
        }.get(head_name)
        if trainer_cls is None:
            raise ValueError(f"No trainer for head type {head_name!r}.")
        data_readers = DataReaders.from_config(
            config.data.labels, training=training_labels, validation=validation_labels,
            test=test_labels,
        )
        skeleton = (config.data.labels.skeletons[0] if config.data.labels.skeletons
                    else data_readers.training_labels.skeleton)
        if not config.data.labels.skeletons:
            config.data.labels.skeletons = [skeleton]
        tracks = data_readers.training_labels.tracks or None
        model = Model.from_config(config.model, skeleton=skeleton, tracks=tracks,
                                  update_config=True)
        return trainer_cls(config=config, data_readers=data_readers, model=model, device=device)

    # ------------------------------------------------------------------ #
    @property
    def skeleton(self):
        return self.config.data.labels.skeletons[0]

    def _image_channels(self) -> int:
        pp = self.config.data.preprocessing
        if pp.ensure_grayscale:
            return 1
        if pp.ensure_rgb:
            return 3
        # The JAX trainer reads ``labels.video``, which raises for a project
        # of several videos; here the videos need only agree.
        channels = {int(v.channels) for v in self.data_readers.training_labels.videos}
        if len(channels) > 1:
            raise ValueError(f"The training videos differ in channels ({sorted(channels)}): "
                             "set ensure_grayscale or ensure_rgb in the config.")
        return channels.pop() if channels else 1

    def _size_matching_target(self) -> Optional[Tuple[int, int]]:
        """The (height, width) every frame is size-matched to: the config's
        target, else, for a project whose videos differ in size, the largest
        height and width. The latter is written into the config when
        ``resize_and_pad_to_target`` is set, as upstream SLEAP does (the
        JAX trainer leaves it out), so that inference matches frames to the
        size the model trained at whatever videos it is given."""
        pp = self.config.data.preprocessing
        if pp.target_height and pp.target_width:
            return int(pp.target_height), int(pp.target_width)
        sizes = {
            (int(v.height), int(v.width))
            for labels in (self.data_readers.training_labels, self.data_readers.validation_labels)
            for v in labels.videos
            if v.height and v.width
        }
        if len(sizes) <= 1:
            return None
        target_hw = (max(h for h, _ in sizes), max(w for _, w in sizes))
        if pp.resize_and_pad_to_target:
            pp.target_height, pp.target_width = target_hw
        return target_hw

    def _check_outputs_config(self) -> None:
        out = self.config.outputs
        if out.tensorboard.write_logs or out.tensorboard.profile_graph:
            raise NotImplementedError("TensorBoard logging is not ported (ROADMAP.md, queue 1).")
        if out.zmq.publish_updates or out.zmq.subscribe_to_controller:
            raise NotImplementedError("ZMQ progress and control are not ported (ROADMAP.md, "
                                      "queue 1).")

    def setup(self) -> None:
        """Decode the examples, build and initialize the module on the
        device, and write the run folder's configs."""
        self._check_outputs_config()
        self._max_instances = max(
            (len(lf.training_instances) for lf in self.data_readers.training_labels.labeled_frames),
            default=1,
        ) or 1
        self._input_channels = self._image_channels()
        target_hw = self._size_matching_target()
        maker = preload_examples if self.config.optimization.preload_data else LazyExamples
        class_names = list(self.model.classes) or None
        self._train_examples = maker(self.data_readers.training_labels, self._max_instances,
                                     target_hw, class_names)
        self._val_examples = maker(self.data_readers.validation_labels, self._max_instances,
                                   target_hw, class_names)
        if not len(self._train_examples):
            raise ValueError("No trainable examples found.")
        init_hw = max(4 * self.model.maximum_stride, 32)
        module = self.model.init(self._input_channels, torch.Generator().manual_seed(0),
                                 input_hw=(init_hw, init_hw))
        if self.config.model.base_checkpoint:
            from sleap_tpu_torch.inference.predictors import load_trained_model

            base = load_trained_model(self.config.model.base_checkpoint, device="cpu")
            module.load_state_dict(base.module.state_dict())
        module.to(self.device)
        if self.config.optimization.mixed_precision:
            module.to(memory_format=torch.channels_last)
        self.module = module
        self._setup_run_folder()

    def _setup_run_folder(self) -> None:
        out = self.config.outputs
        if not out.save_outputs:
            self.run_path = None
            return
        if out.run_name is None:
            out.run_name = datetime.now().strftime("%y%m%d_%H%M%S") + ".{}".format(
                type(self).__name__.replace("Trainer", "").lower() or "model"
            )
        self.run_path = out.run_path
        os.makedirs(self.run_path, exist_ok=True)
        self.config.save_json(os.path.join(self.run_path, "initial_config.json"))
        # Written up front too, so a crashed or running folder loads.
        self.config.save_json(os.path.join(self.run_path, "training_config.json"))

    # ------------------------------------------------------------------ #
    # To be provided by subclasses:
    # ------------------------------------------------------------------ #
    def make_batch(self, examples: List[Dict], rng: np.random.Generator) -> Batch:
        """Assemble a host batch dict from cached examples."""
        raise NotImplementedError

    def build_gt_fn(self) -> Callable:
        """fn(batch of device tensors, generator) -> (float images, gt dict)."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def _loss_terms(self) -> List[Tuple[str, float, str]]:
        """(output key, weight, loss kind) per supervised head output."""
        return [
            (h.name, h.loss_weight,
             "xent" if h.loss_function == "categorical_crossentropy" else "mse")
            for h in self.model.heads
        ]

    def to_device(self, batch: Batch, image: Optional[torch.Tensor] = None) -> Batch:
        """A host batch's arrays as tensors on the trainer's device
        (``image`` if it is already there)."""
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()
               if k != "image" or image is None}
        if image is not None:
            out["image"] = image
        return out

    def _autocast(self):
        if not self.config.optimization.mixed_precision:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=torch.bfloat16)

    def compute_loss(self, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        """The weighted sum of every head's loss (plus hard keypoint mining
        where configured) on one device batch, in float32."""
        if self._gt_fn is None:
            self._gt_fn = self.build_gt_fn()
        imgs, gt = self._gt_fn(batch, generator)
        with self._autocast():
            preds = self.module(imgs)
        ohkm = self.config.optimization.hard_keypoint_mining
        stacks = getattr(self.model.backbone, "stacks", 1)
        loss = torch.zeros((), device=imgs.device)
        for name, weight, kind in self._loss_terms():
            target = gt[name]
            for key in [name] + [f"{name}_stack{i}" for i in range(stacks - 1)]:
                if key not in preds:
                    continue
                pred = preds[key].float()
                if kind == "xent":
                    term = categorical_crossentropy(target, pred)
                else:
                    term = mse_loss(target, pred)
                    if ohkm.online_mining:
                        term = term + compute_ohkm_loss(
                            target, pred,
                            hard_to_easy_ratio=ohkm.hard_to_easy_ratio,
                            min_hard_keypoints=ohkm.min_hard_keypoints,
                            max_hard_keypoints=ohkm.max_hard_keypoints,
                            loss_scale=ohkm.loss_scale,
                        )
                loss = loss + weight * term
        return loss

    def make_optimizer(self) -> torch.optim.Optimizer:
        opt = self.config.optimization
        self.optimizer = make_optimizer(opt.optimizer, self.module.parameters(),
                                        opt.initial_learning_rate)
        return self.optimizer

    @ieee_fp32()
    def train_step(self, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        """One update on a device batch; returns the loss, on the device.
        Its one forward runs in ``train()`` mode: batch norm normalises with
        the batch's statistics and moves its running ones once (every
        stack's heads and hard keypoint mining read that same forward)."""
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.compute_loss(batch, generator)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @ieee_fp32()
    @torch.no_grad()
    def val_step(self, batch: Batch, generator: torch.Generator) -> torch.Tensor:
        self.module.eval()
        return self.compute_loss(batch, generator)

    def _state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's weights as float32 CPU tensors."""
        return {k: v.detach().float().cpu().clone() for k, v in self.module.state_dict().items()}

    def _save_checkpoint(self, name: str, state: Optional[Dict[str, torch.Tensor]] = None) -> None:
        if self.run_path:
            torch.save(state if state is not None else self._state_dict(),
                       os.path.join(self.run_path, name))

    def _epoch_batches(self, examples, n_batches: int, batch_size: int,
                       rng: np.random.Generator) -> Iterator[Tuple[Batch, int]]:
        n = max(len(examples), 1)
        for _ in range(n_batches):
            idx = rng.integers(0, n, batch_size)
            yield self.make_batch([examples[i % len(examples)] for i in idx], rng), batch_size

    @ieee_fp32()
    def train(self) -> None:
        """Run the optimization loop and write the run folder, with TF32
        off (:func:`~sleap_tpu_torch.precision.ieee_fp32`)."""
        if self.module is None:
            self.setup()
        opt_cfg = self.config.optimization
        self.make_optimizer()
        batch_size = opt_cfg.batch_size
        n_train = len(self._train_examples)
        batches_per_epoch = opt_cfg.batches_per_epoch or max(
            opt_cfg.min_batches_per_epoch, -(-n_train // batch_size)
        )
        val_batches = opt_cfg.val_batches_per_epoch or max(
            opt_cfg.min_val_batches_per_epoch, -(-len(self._val_examples) // batch_size)
        )
        lr_sched = ReduceLROnPlateau(opt_cfg.learning_rate_schedule, opt_cfg.initial_learning_rate)
        stopper = EarlyStopping(opt_cfg.early_stopping)
        rng = np.random.default_rng(0)
        generator = torch.Generator(device=self.device).manual_seed(42)
        log_rows = []
        best_val = np.inf
        best_state = None
        t_train = time.time()
        ckpt_cfg = self.config.outputs.checkpointing
        if ckpt_cfg.initial_model:
            self._save_checkpoint("initial_model.pt")
        for epoch in range(opt_cfg.epochs):
            t0 = time.time()
            train_losses = [
                self.train_step(self.to_device(batch, image), generator)
                for batch, _, image in stage_to_device(
                    self._epoch_batches(self._train_examples, batches_per_epoch, batch_size, rng),
                    self.device)
            ]
            # No usable validation examples: val_loss falls back to the train loss.
            val_losses = [
                self.val_step(self.to_device(batch, image), generator)
                for batch, _, image in stage_to_device(
                    self._epoch_batches(self._val_examples,
                                        val_batches if len(self._val_examples) else 0,
                                        batch_size, rng),
                    self.device)
            ]
            train_losses = torch.stack(train_losses).double().cpu().tolist() if train_losses else []
            val_losses = torch.stack(val_losses).double().cpu().tolist() if val_losses else []
            train_loss = float(np.mean(train_losses)) if train_losses else np.nan
            val_loss = float(np.mean(val_losses)) if val_losses else train_loss
            lr = lr_sched.update(val_loss)
            set_learning_rate(self.optimizer, lr)
            log_rows.append({"epoch": epoch, "loss": train_loss, "val_loss": val_loss, "lr": lr})
            logger.info("Epoch %d/%d - loss: %.6f - val_loss: %.6f (%.1fs)", epoch + 1,
                        opt_cfg.epochs, train_loss, val_loss, time.time() - t0)
            if val_loss < best_val and ckpt_cfg.best_model:
                best_val = val_loss
                best_state = self._state_dict()
                self._save_checkpoint("best_model.pt", best_state)
            if ckpt_cfg.every_epoch:
                self._save_checkpoint(f"model.epoch{epoch:04d}.pt")
            if ckpt_cfg.latest_model:
                self._save_checkpoint("latest_model.pt")
            if stopper.should_stop(val_loss):
                logger.info("Early stopping at epoch %d.", epoch + 1)
                break
        if ckpt_cfg.final_model:
            self._save_checkpoint("final_model.pt")
        # The module keeps the best weights, as the JAX trainer's variables do.
        if best_state is not None:
            self.module.load_state_dict(best_state)
        logger.info("Finished training in %.1fs.", time.time() - t_train)
        self.log_rows = log_rows
        if self.run_path:
            self.config.save_json(os.path.join(self.run_path, "training_config.json"))
            if self.config.outputs.log_to_csv and log_rows:
                with open(os.path.join(self.run_path, "training_log.csv"), "w", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=list(log_rows[0].keys()))
                    writer.writeheader()
                    writer.writerows(log_rows)
            self._save_gt_labels()
            self.evaluate()
            if self.config.outputs.zip_outputs:
                self.package()

    def _save_gt_labels(self) -> None:
        """The training and validation splits as ``labels_gt.{train,val}.slp``
        (frames not embedded); a failure is logged, as in JAX."""
        try:
            self.data_readers.training_labels.save(
                os.path.join(self.run_path, "labels_gt.train.slp"))
            self.data_readers.validation_labels.save(
                os.path.join(self.run_path, "labels_gt.val.slp"))
        except Exception as e:
            logger.warning("Could not save GT labels: %s", e)

    def evaluate(self) -> None:
        """Score the run folder's model on the training and validation
        splits, on the trainer's device; a split that fails is logged, as in
        JAX."""
        from sleap_tpu_torch.evals import evaluate_model

        for split, labels in (("train", self.data_readers.training_labels),
                              ("val", self.data_readers.validation_labels)):
            try:
                evaluate_model(self.config, labels, self.run_path, split_name=split,
                               device=self.device)
            except Exception as e:
                logger.warning("Evaluation on %s split failed: %s", split, e)

    def package(self) -> None:
        """Zip the run folder."""
        if self.run_path:
            logger.info("Packaging run folder: %s.zip", self.run_path)
            shutil.make_archive(self.run_path, "zip", self.run_path)

    # Shared preprocessing of the ground-truth functions, on the device.
    def _prep_images(self, images: torch.Tensor) -> torch.Tensor:
        pp = self.config.data.preprocessing
        imgs = ensure_grayscale(images) if self._input_channels == 1 else ensure_rgb(images)
        imgs = ensure_float(imgs)
        if pp.imagenet_mode:
            imgs = apply_imagenet_mode(imgs, pp.imagenet_mode)
        return imgs

    def _resize_pad(self, imgs: torch.Tensor) -> torch.Tensor:
        pp = self.config.data.preprocessing
        if pp.input_scaling != 1.0:
            imgs = resize_image(imgs, pp.input_scaling)
        stride = pp.pad_to_stride or self.model.maximum_stride
        if stride > 1:
            imgs = pad_to_stride(imgs, stride)
        return imgs

    def _augment(self, imgs: torch.Tensor, instances: torch.Tensor,
                 generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
        return augment(imgs, instances, self.config.optimization.augmentation_config,
                       generator, self.skeleton.flip_idx())

    def _prep_augment(self, batch: Batch, generator: torch.Generator):
        return self._augment(self._prep_images(batch["image"]), batch["instances"].float(),
                             generator)


# --------------------------------------------------------------------------- #
# Concrete trainers
# --------------------------------------------------------------------------- #


def _with_offsets(gt: Dict[str, torch.Tensor], offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, H, W, N, 2) offsets as the head's (B, H, W, 2N) channels."""
    gt["OffsetRefinementHead"] = offsets.reshape(*offsets.shape[:3], -1)
    return gt


class _FullFrameBatchMixin:
    def make_batch(self, examples, rng):
        return {
            "image": np.stack([e["image"] for e in examples]),
            "instances": np.stack([e["instances"] for e in examples]),
            "track_inds": np.stack([e["track_inds"] for e in examples]),
        }


class SingleInstanceTrainer(_FullFrameBatchMixin, Trainer):
    """Full-frame confidence maps of a single instance."""

    def build_gt_fn(self):
        head = self.config.model.heads.single_instance
        sigma, stride = head.sigma, head.output_stride
        scale = self.config.data.preprocessing.input_scaling

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            imgs = self._resize_pad(imgs)
            points = instances[:, 0] * scale
            xv, yv = make_grid_vectors(imgs.shape[1], imgs.shape[2], stride, imgs.device)
            cms = make_confmaps(points, xv, yv, sigma)
            gt = {"SingleInstanceConfmapsHead": cms}
            if head.offset_refinement:
                _with_offsets(gt, mask_offsets(make_offsets(points, xv, yv, stride), cms))
            return imgs, gt

        return gt_fn


class CentroidTrainer(_FullFrameBatchMixin, Trainer):
    """Confidence maps of every instance's anchor part or box midpoint."""

    def _anchor_ind(self) -> Optional[int]:
        anchor = self.config.model.heads.centroid.anchor_part
        if anchor and anchor in self.skeleton.node_names:
            return self.skeleton.node_names.index(anchor)
        return None

    def build_gt_fn(self):
        head = self.config.model.heads.centroid
        sigma, stride = head.sigma, head.output_stride
        scale = self.config.data.preprocessing.input_scaling
        anchor_ind = self._anchor_ind()

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            imgs = self._resize_pad(imgs)
            anchors = get_instance_centroids(instances * scale, anchor_ind)[:, :, None, :]
            xv, yv = make_grid_vectors(imgs.shape[1], imgs.shape[2], stride, imgs.device)
            if head.offset_refinement:
                cms, offs = make_multi_confmaps_with_offsets(anchors, xv, yv, stride, sigma)
                return imgs, _with_offsets({"CentroidConfmapsHead": cms}, offs)
            return imgs, {"CentroidConfmapsHead": make_multi_confmaps(anchors, xv, yv, sigma)}

        return gt_fn


class _InstanceCropBatchMixin:
    """Instance-level examples: (frame, instance index) pairs."""

    @staticmethod
    def expand_examples(examples):
        """Frame examples -> one example per instance (``ctr_ind``)."""
        if isinstance(examples, LazyExamples):
            return examples.expand_instances()
        out = []
        for ex in examples:
            n = int((~np.isnan(ex["instances"][..., 0]).all(axis=-1)).sum())
            for i in range(n):
                out.append({**ex, "ctr_ind": i})
        return out

    def setup(self):
        super().setup()
        self._train_examples = self.expand_examples(self._train_examples)
        self._val_examples = self.expand_examples(self._val_examples)

    def make_batch(self, examples, rng):
        return {
            "image": np.stack([e["image"] for e in examples]),
            "instances": np.stack([e["instances"] for e in examples]),
            "track_inds": np.stack([e["track_inds"] for e in examples]),
            "ctr_ind": np.array([e["ctr_ind"] for e in examples], "i4"),
        }

    def _crop_setup(self) -> Tuple[int, Optional[int]]:
        ic = self.config.data.instance_cropping
        crop_size = ic.crop_size or find_instance_crop_size(
            self.data_readers.training_labels,
            padding=ic.crop_size_detection_padding,
            maximum_stride=self.model.maximum_stride,
            input_scaling=self.config.data.preprocessing.input_scaling,
            min_crop_size=ic.crop_size,
        )
        if ic.crop_size is None:
            ic.crop_size = crop_size
        anchor = ic.center_on_part
        names = self.skeleton.node_names
        return crop_size, (names.index(anchor) if anchor and anchor in names else None)

    def _crop_batch(self, imgs, instances, ctr_ind, crop_size, anchor_ind, scale):
        """Augmented full frames -> crops centered on each sample's instance
        ``ctr_ind``, and that instance's points in crop coordinates."""
        imgs = self._resize_pad(imgs)
        instances = instances * scale
        B = imgs.shape[0]
        samples = torch.arange(B, device=imgs.device)
        target = instances[samples, ctr_ind.long()]  # (B, N, 2)
        centroids = get_instance_centroids(target, anchor_ind)
        bboxes = make_centered_bboxes(torch.nan_to_num(centroids), crop_size, crop_size)
        crops = crop_and_resize(imgs, bboxes, samples, (crop_size, crop_size))
        offsets = centroids - (crop_size - 1) / 2.0
        return crops, target - offsets[:, None, :]


class TopdownConfmapsTrainer(_InstanceCropBatchMixin, Trainer):
    """Centered-instance confidence maps on crops."""

    def build_gt_fn(self):
        head = self.config.model.heads.centered_instance
        sigma, stride = head.sigma, head.output_stride
        scale = self.config.data.preprocessing.input_scaling
        crop_size, anchor_ind = self._crop_setup()

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            crops, pts = self._crop_batch(imgs, instances, batch["ctr_ind"], crop_size,
                                          anchor_ind, scale)
            xv, yv = make_grid_vectors(crop_size, crop_size, stride, crops.device)
            cms = make_confmaps(pts, xv, yv, sigma)
            gt = {"CenteredInstanceConfmapsHead": cms}
            if head.offset_refinement:
                _with_offsets(gt, mask_offsets(make_offsets(pts, xv, yv, stride), cms))
            return crops, gt

        return gt_fn


class BottomUpTrainer(_FullFrameBatchMixin, Trainer):
    """Multi-instance confidence maps and part affinity fields."""

    def build_gt_fn(self):
        heads = self.config.model.heads.multi_instance
        cm_sigma, cm_stride = heads.confmaps.sigma, heads.confmaps.output_stride
        paf_sigma, paf_stride = heads.pafs.sigma, heads.pafs.output_stride
        scale = self.config.data.preprocessing.input_scaling
        edge_inds = self.skeleton.edge_inds

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            imgs = self._resize_pad(imgs)
            instances = instances * scale
            H, W = imgs.shape[1], imgs.shape[2]
            xv_c, yv_c = make_grid_vectors(H, W, cm_stride, imgs.device)
            xv_p, yv_p = make_grid_vectors(H, W, paf_stride, imgs.device)
            src, dst = get_edge_points(instances, edge_inds)
            pafs = make_multi_pafs(xv_p, yv_p, src, dst, paf_sigma)
            gt = {"PartAffinityFieldsHead": pafs.reshape(*pafs.shape[:3], -1)}
            if heads.confmaps.offset_refinement:
                cms, offs = make_multi_confmaps_with_offsets(instances, xv_c, yv_c, cm_stride,
                                                             cm_sigma)
                _with_offsets(gt, offs)
            else:
                cms = make_multi_confmaps(instances, xv_c, yv_c, cm_sigma)
            gt["MultiInstanceConfmapsHead"] = cms
            return imgs, gt

        return gt_fn


class BottomUpMultiClassTrainer(_FullFrameBatchMixin, Trainer):
    """Multi-instance confidence maps and class maps."""

    def build_gt_fn(self):
        heads = self.config.model.heads.multi_class_bottomup
        cm_sigma, cm_stride = heads.confmaps.sigma, heads.confmaps.output_stride
        class_sigma, class_stride = heads.class_maps.sigma, heads.class_maps.output_stride
        n_classes = len(heads.class_maps.classes)
        scale = self.config.data.preprocessing.input_scaling

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            imgs = self._resize_pad(imgs)
            instances = instances * scale
            H, W = imgs.shape[1], imgs.shape[2]
            xv_c, yv_c = make_grid_vectors(H, W, cm_stride, imgs.device)
            gt = {"MultiInstanceConfmapsHead": make_multi_confmaps(instances, xv_c, yv_c,
                                                                   cm_sigma)}
            # Class maps: each instance's node-max map, normalized over the
            # instances where it exceeds 0.2, times its class's one-hot.
            xv_k, yv_k = make_grid_vectors(H, W, class_stride, imgs.device)
            per_inst = make_confmaps(instances, xv_k, yv_k, class_sigma).amax(dim=-1)
            per_inst = per_inst.permute(0, 2, 3, 1)  # (B, H', W', I)
            total = per_inst.sum(dim=-1, keepdim=True)
            w = torch.where(per_inst > 0.2, per_inst / torch.clamp(total, min=1e-8), 0.0)
            one_hot = _one_hot(batch["track_inds"], n_classes)  # (B, I, n_classes)
            gt["ClassMapsHead"] = (w[..., None] * one_hot[:, None, None]).amax(dim=3)
            if heads.confmaps.offset_refinement:
                _, offs = make_multi_confmaps_with_offsets(instances, xv_c, yv_c, cm_stride,
                                                           cm_sigma)
                _with_offsets(gt, offs)
            return imgs, gt

        return gt_fn


class TopDownMultiClassTrainer(_InstanceCropBatchMixin, Trainer):
    """Centered-instance confidence maps and class vectors on crops."""

    def build_gt_fn(self):
        heads = self.config.model.heads.multi_class_topdown
        sigma, stride = heads.confmaps.sigma, heads.confmaps.output_stride
        n_classes = len(heads.class_vectors.classes)
        scale = self.config.data.preprocessing.input_scaling
        crop_size, anchor_ind = self._crop_setup()

        def gt_fn(batch, generator):
            imgs, instances = self._prep_augment(batch, generator)
            ctr_ind = batch["ctr_ind"].long()
            crops, pts = self._crop_batch(imgs, instances, ctr_ind, crop_size, anchor_ind, scale)
            xv, yv = make_grid_vectors(crop_size, crop_size, stride, crops.device)
            cms = make_confmaps(pts, xv, yv, sigma)
            tracks = batch["track_inds"][torch.arange(len(ctr_ind), device=crops.device), ctr_ind]
            gt = {"CenteredInstanceConfmapsHead": cms,
                  "ClassVectorsHead": _one_hot(tracks, n_classes)}
            if heads.confmaps.offset_refinement:
                _with_offsets(gt, mask_offsets(make_offsets(pts, xv, yv, stride), cms))
            return crops, gt

        return gt_fn
