"""Tracking building blocks: similarities, matching, culling (port of
:mod:`sleap_tpu.tracking.components`).

Host-side numpy and scipy on small per-frame instance lists, as in the JAX
package, with the same arithmetic (dtypes, reduction order), so the port
picks the same matches and scores. Each stock similarity function carries a
vectorized ``batch_fn`` computing the full (n_ref, n_query) similarity
matrix at once; ``FrameMatches.from_candidate_instances`` uses it when
present and the scalar pairwise loop for any other callable. The
per-point work of flow tracking runs on the device in
:mod:`sleap_tpu_torch.ops.optical_flow`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
from scipy.optimize import linear_sum_assignment

from sleap_tpu_torch.core.instance import PredictedInstance, Track

# --------------------------------------------------------------------------- #
# Similarity functions
# --------------------------------------------------------------------------- #


def _points_stack(instances) -> np.ndarray:
    """Stack ``inst.numpy()`` for a list of instances into (n, n_nodes, 2)."""
    return np.stack([inst.numpy() for inst in instances], axis=0)


def instance_similarity(ref_instance, query_instance) -> float:
    """Sum of exp(-d^2) over nodes / number of visible ref nodes."""
    ref_pts = ref_instance.numpy()
    query_pts = query_instance.numpy()
    ref_visible = ~(np.isnan(ref_pts).any(axis=1))
    dists = np.sum((query_pts - ref_pts) ** 2, axis=1)
    n_vis = np.sum(ref_visible)
    if n_vis == 0:
        return np.nan
    return np.nansum(np.exp(-dists)) / n_vis


def normalized_instance_similarity(ref_instance, query_instance, img_hw=None) -> float:
    """Keypoints normalized by image size before similarity."""
    ref_pts = ref_instance.numpy()
    query_pts = query_instance.numpy()
    if img_hw is not None:
        norm = np.array([img_hw[1], img_hw[0]], dtype="f8")
        ref_pts = ref_pts / norm
        query_pts = query_pts / norm
    ref_visible = ~(np.isnan(ref_pts).any(axis=1))
    dists = np.sum((query_pts - ref_pts) ** 2, axis=1)
    n_vis = np.sum(ref_visible)
    if n_vis == 0:
        return np.nan
    return np.nansum(np.exp(-dists)) / n_vis


def _batch_instance_similarity(ref_instances, query_instances) -> np.ndarray:
    ref_pts = _points_stack(ref_instances)  # (R, N, 2)
    query_pts = _points_stack(query_instances)  # (Q, N, 2)
    diff = query_pts[None, :] - ref_pts[:, None]  # (R, Q, N, 2)
    dists = np.sum(diff * diff, axis=-1)  # (R, Q, N)
    ref_visible = ~(np.isnan(ref_pts).any(axis=-1))  # (R, N)
    n_vis = np.sum(ref_visible, axis=-1).astype("f8")  # (R,)
    with np.errstate(invalid="ignore", divide="ignore"):
        sims = np.nansum(np.exp(-dists), axis=-1) / np.where(
            n_vis == 0, np.nan, n_vis
        )[:, None]
    return sims


instance_similarity.batch_fn = _batch_instance_similarity
# img_hw is only bound via functools.partial inside Tracker.track (which hides
# this attribute), so the batch path covers exactly the img_hw=None case —
# where the formula coincides with instance_similarity.
normalized_instance_similarity.batch_fn = _batch_instance_similarity


def centroid_distance(ref_instance, query_instance) -> float:
    """Negative euclidean distance between centroids."""
    return -float(np.linalg.norm(ref_instance.centroid - query_instance.centroid))


def _batch_centroid_distance(ref_instances, query_instances) -> np.ndarray:
    ref_c = np.stack([inst.centroid for inst in ref_instances])  # (R, 2)
    query_c = np.stack([inst.centroid for inst in query_instances])  # (Q, 2)
    return -np.linalg.norm(ref_c[:, None] - query_c[None, :], axis=-1)


centroid_distance.batch_fn = _batch_centroid_distance


def compute_iou(bbox1: np.ndarray, bbox2: np.ndarray) -> float:
    """IoU of two (y1, x1, y2, x2) boxes."""
    y1 = max(bbox1[0], bbox2[0])
    x1 = max(bbox1[1], bbox2[1])
    y2 = min(bbox1[2], bbox2[2])
    x2 = min(bbox1[3], bbox2[3])
    inter = max(0.0, y2 - y1) * max(0.0, x2 - x1)
    a1 = (bbox1[2] - bbox1[0]) * (bbox1[3] - bbox1[1])
    a2 = (bbox2[2] - bbox2[0]) * (bbox2[3] - bbox2[1])
    union = a1 + a2 - inter
    return float(inter / union) if union > 0 else 0.0


def instance_iou(ref_instance, query_instance) -> float:
    """Bounding-box IoU similarity."""
    return compute_iou(ref_instance.bounding_box, query_instance.bounding_box)


def _batch_instance_iou(ref_instances, query_instances) -> np.ndarray:
    b1 = np.stack([inst.bounding_box for inst in ref_instances])[:, None]  # (R,1,4)
    b2 = np.stack([inst.bounding_box for inst in query_instances])[None]  # (1,Q,4)
    y1 = np.maximum(b1[..., 0], b2[..., 0])
    x1 = np.maximum(b1[..., 1], b2[..., 1])
    y2 = np.minimum(b1[..., 2], b2[..., 2])
    x2 = np.minimum(b1[..., 3], b2[..., 3])
    inter = np.maximum(0.0, y2 - y1) * np.maximum(0.0, x2 - x1)
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = a1 + a2 - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(union > 0, inter / union, 0.0)


instance_iou.batch_fn = _batch_instance_iou


def factory_object_keypoint_similarity(
    keypoint_errors: Optional[Union[List, int, float]] = None,
    score_weighting: bool = False,
    normalization_keypoints: str = "all",
) -> Callable:
    """OKS-flavored similarity with configurable per-node errors."""
    keypoint_errors = 1 if keypoint_errors in (None, []) else keypoint_errors

    def object_keypoint_similarity(ref_instance, query_instance) -> float:
        ref_pts = ref_instance.numpy()
        query_pts = query_instance.numpy()
        errors = np.broadcast_to(np.asarray(keypoint_errors, "f8"), (len(ref_pts),))
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = 2 * (errors**2)
            if score_weighting and isinstance(ref_instance, PredictedInstance):
                scores = np.nan_to_num(ref_instance.scores, nan=0.0)
                qscores = (
                    np.nan_to_num(query_instance.scores, nan=0.0)
                    if isinstance(query_instance, PredictedInstance)
                    else np.ones(len(ref_pts))
                )
                denom = denom / np.maximum(scores * qscores, 1e-8)
            dists = np.sum((query_pts - ref_pts) ** 2, axis=1)
            ks = np.exp(-dists / denom)
        ref_vis = ~np.isnan(ref_pts).any(axis=1)
        query_vis = ~np.isnan(query_pts).any(axis=1)
        if normalization_keypoints == "ref":
            n = np.sum(ref_vis)
        elif normalization_keypoints == "union":
            n = np.sum(ref_vis | query_vis)
        else:
            n = len(ref_pts)
        if n == 0:
            return np.nan
        return float(np.nansum(np.where(ref_vis & query_vis, ks, 0.0)) / n)

    def _batch(ref_instances, query_instances) -> np.ndarray:
        ref_pts = _points_stack(ref_instances)  # (R, N, 2)
        query_pts = _points_stack(query_instances)  # (Q, N, 2)
        n_nodes = ref_pts.shape[1]
        errors = np.broadcast_to(np.asarray(keypoint_errors, "f8"), (n_nodes,))
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.broadcast_to(2 * (errors**2), (len(ref_instances), n_nodes))
            if score_weighting:
                ref_scores = np.stack(
                    [
                        np.nan_to_num(inst.scores, nan=0.0)
                        if isinstance(inst, PredictedInstance)
                        else np.full(n_nodes, np.nan)
                        for inst in ref_instances
                    ]
                )  # (R, N); NaN rows mark non-predicted refs (unweighted)
                query_scores = np.stack(
                    [
                        np.nan_to_num(inst.scores, nan=0.0)
                        if isinstance(inst, PredictedInstance)
                        else np.ones(n_nodes)
                        for inst in query_instances
                    ]
                )  # (Q, N)
                weighted = denom[:, None] / np.maximum(
                    ref_scores[:, None] * query_scores[None], 1e-8
                )  # (R, Q, N)
                denom = np.where(
                    np.isnan(ref_scores).any(axis=-1)[:, None, None],
                    denom[:, None],
                    weighted,
                )
            else:
                denom = denom[:, None]
            diff = query_pts[None] - ref_pts[:, None]
            dists = np.sum(diff * diff, axis=-1)  # (R, Q, N)
            ks = np.exp(-dists / denom)
        ref_vis = ~np.isnan(ref_pts).any(axis=-1)  # (R, N)
        query_vis = ~np.isnan(query_pts).any(axis=-1)  # (Q, N)
        if normalization_keypoints == "ref":
            n = np.sum(ref_vis, axis=-1)[:, None].astype("f8")  # (R, 1)
        elif normalization_keypoints == "union":
            n = np.sum(ref_vis[:, None] | query_vis[None], axis=-1).astype("f8")
        else:
            n = np.full((1, 1), float(n_nodes))
        masked = np.where(ref_vis[:, None, :] & query_vis[None, :, :], ks, 0.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.nansum(masked, axis=-1) / np.where(n == 0, np.nan, n)

    object_keypoint_similarity.batch_fn = _batch
    return object_keypoint_similarity


# --------------------------------------------------------------------------- #
# Matching functions
# --------------------------------------------------------------------------- #


def hungarian_matching(cost_matrix: np.ndarray) -> List[Tuple[int, int]]:
    cost = np.where(np.isfinite(cost_matrix), cost_matrix, 1e9)
    row_ind, col_ind = linear_sum_assignment(cost)
    return list(zip(row_ind, col_ind))


def greedy_matching(cost_matrix: np.ndarray) -> List[Tuple[int, int]]:
    """Iteratively take the lowest-cost pair."""
    rows, cols = np.unravel_index(
        np.argsort(cost_matrix, axis=None), cost_matrix.shape
    )
    unassigned = list(zip(rows, cols))
    assignments = []
    while unassigned:
        r, c = unassigned.pop(0)
        if not np.isfinite(cost_matrix[r, c]):
            break
        assignments.append((int(r), int(c)))
        unassigned = [(ri, ci) for ri, ci in unassigned if ri != r and ci != c]
    return assignments


def first_choice_matching(cost_matrix: np.ndarray) -> List[Tuple[int, int]]:
    """Every instance takes its own best track (may duplicate)."""
    best = cost_matrix.argmin(axis=1)
    return [(i, int(j)) for i, j in enumerate(best) if np.isfinite(cost_matrix[i, j])]


# --------------------------------------------------------------------------- #
# Match containers
# --------------------------------------------------------------------------- #


@dataclass
class Match:
    instance: Any
    track: Track
    score: float = 0.0
    is_first_choice: bool = False


@dataclass
class FrameMatches:
    """Cost-matrix construction + match extraction."""

    matches: List[Match]
    cost_matrix: np.ndarray
    unmatched_instances: List[Any] = field(default_factory=list)

    @property
    def has_only_first_choice_matches(self) -> bool:
        return all(m.is_first_choice for m in self.matches)

    @classmethod
    def from_candidate_instances(
        cls,
        untracked_instances: List[Any],
        candidate_instances: List[Any],
        similarity_function: Callable,
        matching_function: Callable,
        robust_best_instance: float = 1.0,
    ) -> "FrameMatches":
        cost = np.ndarray((0,))
        candidate_tracks: List[Track] = []
        if candidate_instances:
            by_track = defaultdict(list)
            for k, inst in enumerate(candidate_instances):
                by_track[inst.track].append(k)
            candidate_tracks = list(by_track.keys())
            sims = np.full((len(untracked_instances), len(candidate_tracks)), np.nan)
            batch_fn = getattr(similarity_function, "batch_fn", None)
            if batch_fn is not None and untracked_instances:
                # One vectorized (n_candidates, n_untracked) similarity matrix,
                # then per-track column reduction — bit-identical to the
                # scalar pairwise loop below, minus the Python overhead.
                sims_cu = np.asarray(
                    batch_fn(candidate_instances, untracked_instances), "f8"
                )
                for j, track in enumerate(candidate_tracks):
                    vals = sims_cu[by_track[track]]  # (k_track, n_untracked)
                    if 0 < robust_best_instance < 1:
                        sims[:, j] = np.quantile(vals, robust_best_instance, axis=0)
                    else:
                        sims[:, j] = np.max(vals, axis=0)
            else:
                for i, untracked in enumerate(untracked_instances):
                    for j, track in enumerate(candidate_tracks):
                        vals = [
                            similarity_function(candidate_instances[k], untracked)
                            for k in by_track[track]
                        ]
                        if 0 < robust_best_instance < 1:
                            sims[i, j] = np.quantile(vals, robust_best_instance)
                        else:
                            sims[i, j] = np.max(vals)
            cost = -sims
            cost[np.isnan(cost)] = np.inf
        return cls.from_cost_matrix(
            cost, untracked_instances, candidate_tracks, matching_function
        )

    @classmethod
    def from_cost_matrix(
        cls,
        cost_matrix: np.ndarray,
        instances: List[Any],
        tracks: List[Track],
        matching_function: Callable,
    ) -> "FrameMatches":
        matches = []
        matched_inds = []
        if instances and tracks:
            match_inds = matching_function(cost_matrix)
            best = cost_matrix.argmin(axis=1)
            for i, j in match_inds:
                matched_inds.append(i)
                matches.append(
                    Match(
                        instance=instances[i],
                        track=tracks[j],
                        score=-cost_matrix[i, j],
                        is_first_choice=bool(best[i] == j),
                    )
                )
        unmatched = [inst for i, inst in enumerate(instances) if i not in matched_inds]
        return cls(cost_matrix=cost_matrix, matches=matches, unmatched_instances=unmatched)


# --------------------------------------------------------------------------- #
# Culling / cleanup
# --------------------------------------------------------------------------- #


def nms_fast(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> List[int]:
    """Greedy box NMS; returns indices of *suppressed* boxes."""
    order = np.argsort(-scores)
    keep, suppressed = [], []
    for idx in order:
        if any(compute_iou(boxes[idx], boxes[k]) > iou_threshold for k in keep):
            suppressed.append(int(idx))
        else:
            keep.append(int(idx))
    return suppressed


def nms_instances(
    instances: List[Any], iou_threshold: float, target_count: Optional[int] = None
) -> Tuple[List[Any], List[Any]]:
    """(kept, suppressed); keeps at least target_count instances."""
    boxes = np.array([inst.bounding_box for inst in instances])
    scores = np.array(
        [getattr(inst, "score", inst.n_visible_points) for inst in instances]
    )
    picks = nms_fast(boxes, scores, iou_threshold)
    if target_count is not None and (len(instances) - len(picks)) < target_count:
        n_to_keep = len(instances) - target_count
        picks = sorted(picks, key=lambda i: scores[i])[:n_to_keep]
    to_remove = [instances[i] for i in picks]
    kept = [inst for i, inst in enumerate(instances) if i not in picks]
    return kept, to_remove


def cull_instances(
    frames,
    instance_count: int,
    iou_threshold: Optional[float] = None,
) -> None:
    """Remove extra instances per frame, NMS first if iou_threshold."""
    for lf in frames:
        if len(lf.instances) <= instance_count:
            continue
        instances = list(lf.instances)
        if iou_threshold:
            instances, _ = nms_instances(
                instances, iou_threshold=iou_threshold, target_count=instance_count
            )
        if len(instances) > instance_count:
            instances.sort(
                key=lambda inst: getattr(inst, "score", inst.n_visible_points),
                reverse=True,
            )
            instances = instances[:instance_count]
        lf.instances = instances


def cull_frame_instances(
    instances_list: List[Any],
    instance_count: int,
    iou_threshold: Optional[float] = None,
) -> List[Any]:
    """In-place cull for a single frame's instance list."""
    if len(instances_list) <= instance_count:
        return instances_list
    if iou_threshold:
        instances_list, _ = nms_instances(
            instances_list, iou_threshold=iou_threshold, target_count=instance_count
        )
    if len(instances_list) > instance_count:
        instances_list = sorted(
            instances_list,
            key=lambda inst: getattr(inst, "score", inst.n_visible_points),
            reverse=True,
        )[:instance_count]
    return instances_list


def connect_single_track_breaks(frames, instance_count: int) -> None:
    """Merge new tracks back into lost ones when exactly one track breaks."""
    if not frames:
        return
    lost_track: Optional[Track] = None
    last_tracks: set = set()
    for lf in frames:
        tracks = {inst.track for inst in lf.instances if inst.track is not None}
        if lost_track is not None:
            new_tracks = tracks - last_tracks
            if len(new_tracks) == 1:
                new_track = new_tracks.pop()
                for inst in lf.instances:
                    if inst.track is new_track:
                        inst.track = lost_track
                tracks = {inst.track for inst in lf.instances if inst.track is not None}
                lost_track = None
        if len(last_tracks) and len(tracks) < len(last_tracks):
            missing = last_tracks - tracks
            if len(missing) == 1 and len(last_tracks) == instance_count:
                lost_track = missing.pop()
        last_tracks = tracks
