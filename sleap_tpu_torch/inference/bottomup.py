"""Bottom-up predictor: multi-peak confidence maps + PAF grouping.

Port of :mod:`sleap_tpu.inference.bottomup`. Each batch runs on the
caller's device: preprocessing, the UNet forward, local peaks (the bf16
kernel for bf16 maps on a CUDA device), ``peaks * confmap stride``, PAF line
scores, LAP matching, greedy assembly and ``/ input_scale + 0.5``. The host
then keeps each frame's valid instances and, past ``max_instances``, the
best-scoring ones by the JAX package's own ``np.argsort(-scores)``.

Frames are batched without size matching, as in the JAX predictor: mixed
sizes are not resized to one, and coordinates are not rescaled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.inference.predictors import (
    Predictor,
    TrainedModel,
    _loader,
    _preprocess,
    _skeleton,
)
from sleap_tpu_torch.models.model import find_head
from sleap_tpu_torch.ops.paf_grouping import PAFScorer
from sleap_tpu_torch.ops.peak_finding import find_local_peaks, find_local_peaks_with_offsets


@dataclass(kw_only=True)
class BottomUpPredictor(Predictor):
    """Multi-instance inference by PAF grouping.

    ``max_peaks_per_node`` is the static K of local peaks per node map;
    ``max_instances`` trims each frame's instances on the host.
    """

    bottomup_model: TrainedModel
    max_edge_length_ratio: float = 0.25
    dist_penalty_weight: float = 1.0
    paf_line_points: int = 10
    min_line_scores: float = 0.25
    max_instances: Optional[int] = None
    max_peaks_per_node: int = 16

    size_matching = False

    @classmethod
    def from_trained_models(cls, model_path: str, *, device: Union[str, torch.device] = "cuda",
                            params: Optional[Mapping[str, Any]] = None,
                            compute_dtype: torch.dtype = torch.float32, **kwargs) -> "BottomUpPredictor":
        """A predictor of a multi-instance run folder on ``device``;
        ``params`` maps the folder to weights that replace its own, and the
        other keyword arguments are the predictor's fields."""
        load = _loader(device, params, compute_dtype)
        return cls(bottomup_model=load(model_path), device=torch.device(device), **kwargs)

    @property
    def bottomup_config(self) -> TrainingJobConfig:
        return self.bottomup_model.config

    def __post_init__(self):
        tm = self.bottomup_model
        self.paf_scorer = PAFScorer(
            part_names=tm.part_names,
            edges=tm.edges,
            pafs_stride=tm.paf_stride,
            max_edge_length_ratio=self.max_edge_length_ratio,
            dist_penalty_weight=self.dist_penalty_weight,
            n_points=self.paf_line_points,
            min_line_scores=self.min_line_scores,
        )

    def _infer(self, images: torch.Tensor, batch: dict) -> Dict[str, torch.Tensor]:
        tm = self.bottomup_model
        imgs = _preprocess(
            images, tm.grayscale, tm.input_scale, tm.pad_to_stride,
            imagenet_mode=tm.imagenet_mode,
        )
        return self.group_heads(tm.module(imgs))

    def group_heads(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Head outputs -> instances: peaks, line scores, matching, assembly.

        Returns ``instances`` (S, M, N, 2) in frame coordinates,
        ``instance_peak_vals``, ``instance_scores`` and ``instance_valid``
        (see :func:`~sleap_tpu_torch.ops.paf_grouping.group_instances_batch`).
        """
        tm, scorer = self.bottomup_model, self.paf_scorer
        K = self.max_peaks_per_node
        cms = out[find_head(out, "MultiInstanceConfmapsHead")]
        pafs = out[find_head(out, "PartAffinityFieldsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            peaks, vals, _ = find_local_peaks_with_offsets(
                cms, out[off_key], max_peaks=K, threshold=self.peak_threshold
            )
        else:
            peaks, vals, _ = find_local_peaks(
                cms, max_peaks=K, threshold=self.peak_threshold,
                refinement="integral" if self.integral_refinement else "local",
                integral_patch_size=self.integral_patch_size,
            )
        peaks = peaks * float(tm.output_stride)  # model-input scale
        dst_for_src, match_scores, _ = scorer.score_and_match(pafs, peaks)
        grouped = scorer.group_batch(peaks, vals, dst_for_src, match_scores)
        if tm.input_scale != 1.0:
            grouped["instances"] = grouped["instances"] / tm.input_scale + 0.5
        return grouped

    def _postprocess(self, ex: Dict[str, np.ndarray], batch: dict) -> Dict[str, Any]:
        """Each frame's valid instances, the best ``max_instances`` by score."""
        peaks, peak_vals, scores = [], [], []
        for s in range(ex["instances"].shape[0]):
            keep = ex["instance_valid"][s]
            inst = ex["instances"][s][keep]
            inst_vals = ex["instance_peak_vals"][s][keep]
            inst_scores = ex["instance_scores"][s][keep]
            if self.max_instances is not None and len(inst) > self.max_instances:
                order = np.argsort(-inst_scores)[: self.max_instances]
                inst, inst_vals, inst_scores = inst[order], inst_vals[order], inst_scores[order]
            peaks.append(inst)
            peak_vals.append(inst_vals)
            scores.append(inst_scores)
        return {"instance_peaks": peaks, "instance_peak_vals": peak_vals, "instance_scores": scores}

    def _make_labeled_frames(self, examples, videos):
        skeleton = _skeleton(self.bottomup_model)
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                instances = [
                    PredictedInstance.from_arrays(
                        points=pts,
                        point_confidences=confs,
                        instance_score=float(score),
                        skeleton=skeleton,
                    )
                    for pts, confs, score in zip(
                        ex["instance_peaks"][i],
                        ex["instance_peak_vals"][i],
                        ex["instance_scores"][i],
                    )
                    if not np.all(np.isnan(pts))
                ]
                frames.append(
                    LabeledFrame(
                        video=videos[int(ex["video_ind"][i])],
                        frame_idx=int(ex["frame_ind"][i]),
                        instances=instances,
                    )
                )
        return frames
