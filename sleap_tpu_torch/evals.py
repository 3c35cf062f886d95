"""Evaluation: OKS matching, VOC-style mAP/mAR, distance, PCK and
visibility metrics of predicted against ground-truth labels.

A copy of :mod:`sleap_tpu.evals` on the port's ``Labels``, in plain numpy on
the host. The metrics dict has the JAX package's keys and value types, and
``metrics.{split}.npz`` files go both ways between the packages
(:func:`load_metrics`). Where the port differs:

- its instances carry no link to their frame, so :func:`compute_dists` takes
  the ground-truth frame of each pair from ``frames`` (built from the frame
  pairs by :func:`evaluate`); a pair without one gets frame -1 and path ""
  as a frameless instance does in JAX; a video's path is taken without
  opening it (JAX takes the video's length, so reads its file);
- :func:`evaluate_model` predicts on ``device`` (the card unless the caller
  asks for another), with no fallback;
- :func:`load_metrics` always unpickles through :class:`_ForeignUnpickler`,
  so a file that names ``sleap.*`` or ``sleap_tpu.*`` classes loads with
  stubs and never imports either package.
"""

from __future__ import annotations

import logging
import os
import pickle
import zipfile
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.core.instance import Instance, LabeledFrame, PredictedInstance
from sleap_tpu_torch.core.labels import Labels

logger = logging.getLogger(__name__)

PositivePair = Tuple[Instance, PredictedInstance, float]


def compute_instance_area(points: np.ndarray) -> np.ndarray:
    """Bounding-box area of each (n_nodes, 2) point set."""
    if points.ndim == 2:
        points = np.expand_dims(points, axis=0)
    min_pt = np.nanmin(points, axis=-2)
    max_pt = np.nanmax(points, axis=-2)
    return np.prod(max_pt - min_pt, axis=-1)


def compute_oks(
    points_gt: np.ndarray,
    points_pr: np.ndarray,
    scale: Optional[float] = None,
    stddev: float = 0.025,
    use_cocoeval: bool = True,
) -> np.ndarray:
    """COCO object keypoint similarity, (n_gt, n_pr): the mean over visible
    ground-truth nodes of exp(-d² / denom), with cocoeval's denominator
    2 (area + eps) (2 sigma)², or the paper's 2 (area + eps)² sigma² when
    ``use_cocoeval`` is False. A node missing from the prediction scores 0."""
    gt = np.asarray(points_gt, dtype=np.float64)
    pr = np.asarray(points_pr, dtype=np.float64)
    if gt.ndim == 2:
        gt = gt[None]
    if pr.ndim == 2:
        pr = pr[None]

    box_area = compute_instance_area(gt) if scale is None else scale
    area = np.broadcast_to(np.asarray(box_area, dtype=np.float64), (gt.shape[0],))
    sigma = np.broadcast_to(np.asarray(stddev, dtype=np.float64), (gt.shape[1],))

    eps = np.finfo(np.float64).eps
    if use_cocoeval:
        denom = (4.0 * sigma**2)[None, None, :] * (2.0 * (area + eps))[:, None, None]
    else:
        denom = (sigma**2)[None, None, :] * (2.0 * (area + eps) ** 2)[:, None, None]

    sq_dist = np.square(gt[:, None] - pr[None]).sum(axis=-1)  # (n_gt, n_pr, nodes)
    node_sim = np.exp(-sq_dist / denom)
    visible_gt = ~np.isnan(gt).any(axis=-1)
    visible_pr = ~np.isnan(pr).any(axis=-1)
    node_sim = np.where(visible_pr[None, :, :], node_sim, 0.0)
    node_sim = np.where(visible_gt[:, None, :], node_sim, 0.0)
    return node_sim.sum(axis=-1) / visible_gt.sum(axis=-1, keepdims=True)


def find_frame_pairs(
    labels_gt: Labels, labels_pr: Labels, user_labels_only: bool = True
) -> List[Tuple[LabeledFrame, LabeledFrame]]:
    """Pair ground-truth and predicted frames by video and frame index;
    videos pair by the basename of their filename (the first match)."""
    pairs = []
    for video_gt in labels_gt.videos:
        video_pr = None
        for v in labels_pr.videos:
            if os.path.basename(str(v.filename)) == os.path.basename(str(video_gt.filename)):
                video_pr = v
                break
        if video_pr is None:
            continue
        for lf_gt in labels_gt.find(video_gt):
            if user_labels_only and not lf_gt.has_user_instances:
                continue
            lfs_pr = labels_pr.find(video_pr, frame_idx=lf_gt.frame_idx)
            if lfs_pr:
                pairs.append((lf_gt, lfs_pr[0]))
    return pairs


def match_instances(
    frame_gt: LabeledFrame,
    frame_pr: LabeledFrame,
    stddev: float = 0.025,
    scale: Optional[float] = None,
    threshold: float = 0,
    user_labels_only: bool = True,
) -> Tuple[List[PositivePair], List[Instance]]:
    """Greedy best-OKS matching, predictions taken in descending score order
    (a stable sort, so ties keep their order); returns the matched
    (ground truth, prediction, OKS) triples and the unmatched ground truth."""
    scores_pr = np.array(
        [getattr(inst, "score", np.nan) for inst in frame_pr.instances if hasattr(inst, "score")]
    )
    idxs_pr = np.argsort(-scores_pr, kind="mergesort")

    available_gt = frame_gt.user_instances if user_labels_only else list(frame_gt.instances)
    available_idxs = list(range(len(available_gt)))

    positive_pairs = []
    for idx_pr in idxs_pr:
        instance_pr = frame_pr.instances[int(idx_pr)]
        if not available_idxs:
            break
        points_pr = np.expand_dims(instance_pr.numpy(), axis=0)
        points_gt = np.stack([available_gt[i].numpy() for i in available_idxs], axis=0)
        oks = np.squeeze(compute_oks(points_gt, points_pr, stddev=stddev, scale=scale), axis=1)
        oks[oks <= threshold] = np.nan
        best = int(np.argsort(-oks, kind="mergesort")[0])
        if np.isnan(oks[best]):
            continue
        gt_idx = available_idxs.pop(best)
        positive_pairs.append((available_gt[gt_idx], instance_pr, oks[best]))

    false_negatives = [available_gt[i] for i in available_idxs]
    return positive_pairs, false_negatives


def match_frame_pairs(
    frame_pairs: List[Tuple[LabeledFrame, LabeledFrame]],
    stddev: float = 0.025,
    scale: Optional[float] = None,
    threshold: float = 0,
    user_labels_only: bool = True,
) -> Tuple[List[PositivePair], List[Instance]]:
    """:func:`match_instances` over every frame pair, concatenated."""
    positive_pairs, false_negatives = [], []
    for frame_gt, frame_pr in frame_pairs:
        pp, fn = match_instances(
            frame_gt, frame_pr, stddev=stddev, scale=scale, threshold=threshold,
            user_labels_only=user_labels_only,
        )
        positive_pairs.extend(pp)
        false_negatives.extend(fn)
    return positive_pairs, false_negatives


def compute_generalized_voc_metrics(
    positive_pairs,
    false_negatives,
    match_scores: np.ndarray,
    match_score_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
    recall_thresholds: np.ndarray = np.linspace(0, 1, 101),
    name: str = "voc",
) -> Dict[str, Any]:
    """COCO-style AP and AR with 101-point precision interpolation, over
    every match-score threshold at once: detections ranked by confidence
    (stable), a (T, N) cumulative true-positive count, the right-to-left
    running maximum of precision as the envelope, and each recall sample
    point's first reaching rank."""
    confidences = np.asarray([pair[1].score for pair in positive_pairs])
    order = np.argsort(-confidences, kind="mergesort")
    match_scores = np.asarray(match_scores)[order]

    n_det = match_scores.size
    n_positives = len(positive_pairs) + len(false_negatives)
    thresholds = np.asarray(match_score_thresholds, dtype=np.float64)
    eps = np.finfo(np.float64).eps

    is_tp = match_scores[None, :] >= thresholds[:, None]
    tp_cum = np.cumsum(is_tp, axis=1).astype(np.float64)
    rank = np.arange(1, n_det + 1, dtype=np.float64)

    recall_curve = tp_cum / n_positives
    precision_curve = tp_cum / (rank[None, :] + eps)
    precision_env = np.flip(np.maximum.accumulate(np.flip(precision_curve, axis=1), axis=1), axis=1)

    if n_det:
        recalls = recall_curve[:, -1]
        sample_idx = (recall_curve[:, :, None] < recall_thresholds[None, None, :]).sum(axis=1)
        reachable = sample_idx < n_det
        precisions = np.where(
            reachable,
            np.take_along_axis(precision_env, np.minimum(sample_idx, n_det - 1), axis=1),
            0.0,
        )
    else:
        recalls = np.zeros(thresholds.shape)
        precisions = np.zeros((thresholds.size, np.asarray(recall_thresholds).size))
    return {
        f"{name}.match_score_thresholds": match_score_thresholds,
        f"{name}.recall_thresholds": recall_thresholds,
        f"{name}.match_scores": match_scores,
        f"{name}.precisions": precisions,
        f"{name}.recalls": recalls,
        f"{name}.AP": precisions.mean(axis=1),
        f"{name}.AR": recalls,
        f"{name}.mAP": precisions.mean(),
        f"{name}.mAR": recalls.mean(),
    }


def compute_dists(
    positive_pairs, frames: Optional[Mapping[int, LabeledFrame]] = None
) -> Dict[str, Any]:
    """Per-node distances of each matched pair, with the frame index and
    video filename of its ground truth; ``frames`` maps ``id(instance_gt)``
    to the frame holding it."""
    frames = frames or {}
    dists, frame_idxs, video_paths = [], [], []
    for instance_gt, instance_pr, _ in positive_pairs:
        dists.append(np.linalg.norm(instance_pr.numpy() - instance_gt.numpy(), axis=-1))
        frame = frames.get(id(instance_gt))
        frame_idxs.append(frame.frame_idx if frame is not None else -1)
        video = frame.video if frame is not None else None
        video_paths.append(video.filename if video is not None else "")
    return {"dists": np.array(dists), "frame_idxs": frame_idxs, "video_paths": video_paths}


def compute_dist_metrics(dists_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Mean and percentiles of the non-NaN distances."""
    dists = dists_dict["dists"]
    results = {
        "dist.frame_idxs": dists_dict["frame_idxs"],
        "dist.video_paths": dists_dict["video_paths"],
        "dist.dists": dists,
        "dist.avg": np.nanmean(dists) if dists.size else np.nan,
        "dist.p50": np.nan,
        "dist.p75": np.nan,
        "dist.p90": np.nan,
        "dist.p95": np.nan,
        "dist.p99": np.nan,
    }
    non_nan = dists[~np.isnan(dists)] if dists.size else np.array([])
    if non_nan.size:
        for ptile in (50, 75, 90, 95, 99):
            results[f"dist.p{ptile}"] = np.percentile(non_nan, ptile)
    return results


def compute_pck_metrics(
    dists: np.ndarray, thresholds: np.ndarray = np.linspace(1, 10, 10)
) -> Dict[str, Any]:
    """Percentage of correct keypoints at each distance threshold (NaN
    distances count as misses)."""
    dists = np.copy(dists)
    dists[np.isnan(dists)] = np.inf
    pcks = np.expand_dims(dists, -1) < thresholds.reshape(1, 1, -1)
    mPCK_parts = pcks.mean(axis=0).mean(axis=-1)
    return {
        "pck.thresholds": thresholds,
        "pck.pcks": pcks,
        "pck.mPCK_parts": mPCK_parts,
        "pck.mPCK": mPCK_parts.mean(),
    }


def compute_visibility_conf(positive_pairs) -> Dict[str, float]:
    """Node visibility confusion counts over the matched pairs."""
    vis_tp = vis_fn = vis_fp = vis_tn = 0
    for instance_gt, instance_pr, _ in positive_pairs:
        missing_gt = np.isnan(instance_gt.numpy()).any(axis=-1)
        missing_pr = np.isnan(instance_pr.numpy()).any(axis=-1)
        vis_tn += (missing_gt & missing_pr).sum()
        vis_fn += (~missing_gt & missing_pr).sum()
        vis_fp += (missing_gt & ~missing_pr).sum()
        vis_tp += (~missing_gt & ~missing_pr).sum()
    return {
        "vis.tp": vis_tp,
        "vis.fp": vis_fp,
        "vis.tn": vis_tn,
        "vis.fn": vis_fn,
        "vis.precision": vis_tp / (vis_tp + vis_fp) if (vis_tp + vis_fp) else np.nan,
        "vis.recall": vis_tp / (vis_tp + vis_fn) if (vis_tp + vis_fn) else np.nan,
    }


def evaluate(
    labels_gt: Labels,
    labels_pr: Labels,
    oks_stddev: float = 0.025,
    oks_scale: Optional[float] = None,
    match_threshold: float = 0,
    user_labels_only: bool = True,
) -> Dict[str, Any]:
    """Every metric of a (ground truth, predictions) pair of labels; an
    empty dict when no frame pairs."""
    metrics: Dict[str, Any] = {}
    frame_pairs = find_frame_pairs(labels_gt, labels_pr, user_labels_only)
    if not frame_pairs:
        return metrics
    positive_pairs, false_negatives = match_frame_pairs(
        frame_pairs, stddev=oks_stddev, scale=oks_scale, threshold=match_threshold,
        user_labels_only=user_labels_only,
    )
    frames = {id(inst): lf_gt for lf_gt, _ in frame_pairs for inst in lf_gt.instances}
    dists_dict = compute_dists(positive_pairs, frames)
    metrics.update(compute_visibility_conf(positive_pairs))
    metrics.update(compute_dist_metrics(dists_dict))
    metrics.update(compute_pck_metrics(dists_dict["dists"]))

    pair_oks = np.array([oks for _, _, oks in positive_pairs])
    pair_pck = metrics["pck.pcks"].mean(axis=-1).mean(axis=-1)
    metrics["oks.mOKS"] = pair_oks.mean() if pair_oks.size else np.nan
    metrics.update(compute_generalized_voc_metrics(
        positive_pairs, false_negatives, match_scores=pair_oks, name="oks_voc"))
    metrics.update(compute_generalized_voc_metrics(
        positive_pairs, false_negatives, match_scores=pair_pck, name="pck_voc"))
    return metrics


def evaluate_model(
    cfg,
    labels_gt: Union[Labels, Any],
    model_dir: str,
    save: bool = True,
    split_name: str = "test",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[Labels, Dict[str, Any]]:
    """Predict on ``labels_gt`` (labels, or a provider holding them) with
    the run folder ``model_dir`` on ``device`` and score the predictions;
    with ``save``, write ``labels_pr.{split}.slp`` and
    ``metrics.{split}.npz`` there."""
    from sleap_tpu_torch.inference.predictors import Predictor

    if not isinstance(labels_gt, Labels):
        labels_gt = labels_gt.labels

    predictor = Predictor.from_model_paths(model_dir, device=device)
    labels_pr = predictor.predict(labels_gt)

    if save:
        labels_pr.save(os.path.join(model_dir, f"labels_pr.{split_name}.slp"))
    metrics = evaluate(labels_gt, labels_pr)
    if save and metrics:
        np.savez_compressed(os.path.join(model_dir, f"metrics.{split_name}.npz"), metrics=metrics)
    if metrics:
        logger.info("Evaluation (%s): mOKS=%s mAP=%s dist.avg=%s", split_name,
                    metrics.get("oks.mOKS"), metrics.get("oks_voc.mAP"), metrics.get("dist.avg"))
    return labels_pr, metrics


def load_metrics(model_path: str, split: str = "val") -> Dict[str, Any]:
    """The metrics dict saved in a run folder (``metrics.{split}.npz``) or
    in the ``.npz`` file ``model_path``; the JAX package's files and those
    of upstream SLEAP read too."""
    if os.path.isdir(model_path):
        metrics_path = os.path.join(model_path, f"metrics.{split}.npz")
    else:
        metrics_path = model_path
    from numpy.lib import format as npformat

    with zipfile.ZipFile(metrics_path) as zf, zf.open("metrics.npy") as f:
        version = npformat.read_magic(f)
        read_header = (npformat.read_array_header_1_0 if version == (1, 0)
                       else npformat.read_array_header_2_0)
        read_header(f)
        arr = _ForeignUnpickler(f).load()
    return arr.item() if hasattr(arr, "item") else arr


class _ForeignUnpickler(pickle.Unpickler):
    """Unpickles metrics without the packages their classes came from.

    Classes of ``sleap`` (upstream SLEAP's files) and ``sleap_tpu`` become
    stubs: array subclasses (``PointArray``, ...) plain ndarray subclasses,
    other objects attribute bags. Numbers, numpy arrays and builtins load as
    usual.
    """

    _cache: Dict[Any, type] = {}

    def find_class(self, module, name):
        if module.split(".")[0] not in ("sleap", "sleap_tpu"):
            return super().find_class(module, name)
        key = (module, name)
        if key not in self._cache:
            if "Array" in name:
                self._cache[key] = type(name, (np.ndarray,), {})
            else:
                self._cache[key] = type(name, (), {
                    "__setstate__": _set_stub_state,
                    "__init__": lambda self, *a, **k: None,
                    "__new__": lambda cls, *a, **k: object.__new__(cls),
                })
        return self._cache[key]


def _set_stub_state(self, state) -> None:
    """A stub's ``__setstate__``: a dict, a (dict, slots dict) pair, or
    anything else kept as ``_state``."""
    if isinstance(state, dict):
        self.__dict__.update(state)
    elif (isinstance(state, tuple) and len(state) == 2
          and isinstance(state[0], (dict, type(None)))):
        if state[0]:
            self.__dict__.update(state[0])
        if isinstance(state[1], dict):
            self.__dict__.update(state[1])
    else:
        self.__dict__["_state"] = state
