"""Multiclass (supervised identity) predictors.

Port of :mod:`sleap_tpu.inference.multiclass`. The model predicts identities
directly, by class maps (bottom-up) or by one class vector per crop
(top-down); peaks are assigned to classes by
:mod:`sleap_tpu_torch.ops.identity`, and each class becomes a
:class:`~sleap_tpu_torch.core.instance.Track` named after it. An instance's
score is the mean of its point values, its tracking score the mean of its
class probabilities.

Each batch runs on the caller's device (the card unless the caller passes
``device="cpu"``), through the same kernels as the other paths: local peaks
(kernel 2, or kernel 4 for bf16 maps), crops (kernel 3) and global peaks
(kernel 1). The class tracks are made once per predictor, and every
``Labels`` it returns registers all of them, in class order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance, Track
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.inference.predictors import (
    Predictor,
    TopDownPredictor,
    TrainedModel,
    _adjust_peaks,
    _loader,
    _preprocess,
    _skeleton,
)
from sleap_tpu_torch.models.model import find_head
from sleap_tpu_torch.ops.identity import classify_peaks_from_maps, classify_peaks_from_vectors
from sleap_tpu_torch.ops.peak_finding import find_local_peaks, find_local_peaks_with_offsets


class _ClassFrames:
    """Labeled frames from ``points``, ``point_vals`` and ``class_probs`` of
    shape (S, n_classes, n_nodes, ...): one instance per class that has a
    point, on that class's track."""

    class_tracks: List[Track]

    def _tracks(self) -> List[Track]:
        return self.class_tracks

    def _track(self, frames):
        """The class heads give the identities: no tracker runs, as in the
        JAX package's multiclass predictors."""
        return frames

    def _make_labeled_frames(self, examples, videos):
        skeleton = _skeleton(self._skeleton_model)
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                instances = []
                for ci, track in enumerate(self.class_tracks):
                    pts = ex["points"][i, ci]
                    if np.all(np.isnan(pts)):
                        continue
                    confs = ex["point_vals"][i, ci]
                    instances.append(
                        PredictedInstance.from_arrays(
                            points=pts,
                            point_confidences=np.nan_to_num(confs),
                            instance_score=float(np.nanmean(confs)),
                            skeleton=skeleton,
                            track=track,
                            tracking_score=float(np.nanmean(ex["class_probs"][i, ci])),
                        )
                    )
                frames.append(
                    LabeledFrame(
                        video=videos[int(ex["video_ind"][i])],
                        frame_idx=int(ex["frame_ind"][i]),
                        instances=instances,
                    )
                )
        return frames


@dataclass(kw_only=True)
class BottomUpMultiClassPredictor(_ClassFrames, Predictor):
    """Confidence maps + class maps -> one instance per class.

    ``max_peaks_per_node`` is the static K of local peaks per node map.
    Frames are batched without size matching, as in the JAX predictor.
    """

    model: TrainedModel
    max_peaks_per_node: int = 8

    size_matching = False

    @classmethod
    def from_trained_models(cls, model_path: str, *, device: Union[str, torch.device] = "cuda",
                            params: Optional[Mapping[str, Any]] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            **kwargs) -> "BottomUpMultiClassPredictor":
        """A predictor of a multi-class bottom-up run folder on ``device``;
        ``params`` maps the folder to weights that replace its own, and the
        other keyword arguments are the predictor's fields."""
        kwargs.pop("max_instances", None)
        load = _loader(device, params, compute_dtype)
        return cls(model=load(model_path), device=torch.device(device), **kwargs)

    @property
    def config(self) -> TrainingJobConfig:
        return self.model.config

    @property
    def classes(self) -> List[str]:
        return self.config.model.heads.multi_class_bottomup.class_maps.classes

    def __post_init__(self):
        self.class_tracks = [Track(spawned_on=0, name=c) for c in self.model.classes]

    @property
    def _skeleton_model(self) -> TrainedModel:
        return self.model

    def _infer(self, images: torch.Tensor, batch: dict) -> Dict[str, torch.Tensor]:
        tm = self.model
        imgs = _preprocess(
            images, tm.grayscale, tm.input_scale, tm.pad_to_stride,
            imagenet_mode=tm.imagenet_mode,
        )
        return self.classify_heads(tm.module(imgs))

    def classify_heads(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Head outputs -> ``points`` (S, n_classes, n_nodes, 2) in frame
        coordinates, ``point_vals`` and ``class_probs`` (S, n_classes,
        n_nodes): local peaks, then each class's peak by the class maps."""
        tm = self.model
        K = self.max_peaks_per_node
        cms = out[find_head(out, "MultiInstanceConfmapsHead")]
        class_maps = out[find_head(out, "ClassMapsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            peaks, vals, mask = find_local_peaks_with_offsets(
                cms, out[off_key], max_peaks=K, threshold=self.peak_threshold
            )
        else:
            peaks, vals, mask = find_local_peaks(
                cms, max_peaks=K, threshold=self.peak_threshold,
                refinement="integral" if self.integral_refinement else "local",
                integral_patch_size=self.integral_patch_size,
            )
        peaks = peaks * float(tm.output_stride)  # model-input scale
        points, point_vals, class_probs = classify_peaks_from_maps(
            class_maps, peaks, vals, mask, class_maps_stride=tm.class_maps_stride
        )
        return {
            "points": _adjust_peaks(points, 1, tm.input_scale),  # / scale + 0.5
            "point_vals": point_vals,
            "class_probs": class_probs.float(),
        }


@dataclass(kw_only=True)
class TopDownMultiClassPredictor(_ClassFrames, TopDownPredictor):
    """Centroid crops -> confidence maps + class vectors -> one instance per
    class.

    K, the crops per frame, is ``max_instances`` or else the number of
    classes (at least 2). Without a centroid model, the crops are centred on
    the ground-truth instances of the labels the frames come from, as in
    :class:`~sleap_tpu_torch.inference.predictors.TopDownPredictor`.
    """

    centroid_model: Optional[TrainedModel] = None

    size_matching = False

    def __post_init__(self):
        super().__post_init__()
        self.class_tracks = [Track(spawned_on=0, name=c) for c in self.confmap_model.classes]

    @property
    def _skeleton_model(self) -> TrainedModel:
        return self.confmap_model

    @property
    def classes(self) -> List[str]:
        return self.confmap_config.model.heads.multi_class_topdown.class_vectors.classes

    @property
    def _max_peaks(self) -> int:
        return self.max_instances or max(len(self.confmap_model.classes), 2)

    def _infer(self, images: torch.Tensor, batch: dict) -> Dict[str, torch.Tensor]:
        centroids, _, centroid_mask = self._centroids(images, batch, self._max_peaks)
        pk, pv, out = self._crop_peaks(images, centroids)
        S, K = centroid_mask.shape
        class_vecs = out[find_head(out, "ClassVectorsHead")].reshape(S, K, -1)
        points, point_vals, class_probs = classify_peaks_from_vectors(
            pk, pv, class_vecs, centroid_mask
        )
        return {"points": points, "point_vals": point_vals, "class_probs": class_probs.float()}
