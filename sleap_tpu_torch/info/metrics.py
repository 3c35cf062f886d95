"""Pairwise instance metrics between two label sets (port of
:mod:`sleap_tpu.info.metrics`): nodewise instance matching and point
distance matrices, on the port's ``Labels``. Host numpy (and scipy's
Hungarian solver for :func:`match_instance_lists`)."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.core.instance import Instance, PredictedInstance
from sleap_tpu_torch.core.labels import Labels


def matched_instance_distances(
    labels_gt: Labels,
    labels_pr: Labels,
    match_lists_function: Optional[Callable] = None,
    frame_range: Optional[range] = None,
) -> Tuple[List[int], np.ndarray, np.ndarray, np.ndarray]:
    """Distances between closest-matched instances in corresponding frames.

    Returns (frame indices, D (n_points, n_nodes), points_gt, points_pr).
    """
    match_lists_function = match_lists_function or match_instance_lists_nodewise
    frame_idxs = []
    points_gt = []
    points_pr = []
    for lf_gt in labels_gt.labeled_frames:
        frame_idx = lf_gt.frame_idx
        if frame_range is not None and frame_idx not in frame_range:
            continue
        lfs_pr = [lf for lf in labels_pr.labeled_frames if lf.frame_idx == frame_idx]
        if not lfs_pr:
            continue
        insts_gt = lf_gt.user_instances or list(lf_gt.instances)
        insts_pr = [i for i in lfs_pr[0].instances if isinstance(i, PredictedInstance)]
        if not insts_gt or not insts_pr:
            continue
        sorted_gt, sorted_pr = match_lists_function(insts_gt, insts_pr)
        for a, b in zip(sorted_gt, sorted_pr):
            points_gt.append(a.numpy())
            points_pr.append(b.numpy())
            frame_idxs.append(frame_idx)
    if not points_gt:
        return [], np.zeros((0, 0)), np.zeros((0, 0, 2)), np.zeros((0, 0, 2))
    points_gt = np.stack(points_gt)
    points_pr = np.stack(points_pr)
    D = np.linalg.norm(points_gt - points_pr, axis=2)
    return frame_idxs, D, points_gt, points_pr


def match_instance_lists_nodewise(
    instances_a: List[Instance], instances_b: List[Instance], thresh: float = 5
) -> Tuple[List[Instance], List[Instance]]:
    """For each A instance, the B instance with the most points within
    ``thresh`` px."""
    best_b = []
    for inst_a in instances_a:
        pts_a = inst_a.numpy()
        counts = []
        for inst_b in instances_b:
            d = np.linalg.norm(pts_a - inst_b.numpy(), axis=1)
            counts.append(np.sum(np.nan_to_num(d, nan=np.inf) < thresh))
        best_b.append(instances_b[int(np.argmax(counts))])
    return instances_a, best_b


def match_instance_lists(
    instances_a: List[Instance],
    instances_b: List[Instance],
    cost_function: Callable,
) -> Tuple[List[Instance], List[Instance]]:
    """Hungarian pairing by a pairwise cost function."""
    from scipy.optimize import linear_sum_assignment

    cost = np.full((len(instances_a), len(instances_b)), np.inf)
    for i, a in enumerate(instances_a):
        for j, b in enumerate(instances_b):
            cost[i, j] = cost_function(a, b)
    cost = np.nan_to_num(cost, nan=1e9, posinf=1e9)
    rows, cols = linear_sum_assignment(cost)
    return [instances_a[i] for i in rows], [instances_b[j] for j in cols]


def point_dist(inst_a: Instance, inst_b: Instance) -> np.ndarray:
    return np.linalg.norm(inst_a.numpy() - inst_b.numpy(), axis=1)


def nodeless_point_dist(inst_a: Instance, inst_b: Instance) -> np.ndarray:
    """Each A point's distance to the nearest B point, of any node."""
    a, b = inst_a.numpy(), inst_b.numpy()
    D = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=2)
    return np.nanmin(D, axis=1)


def compare_instance_lists(
    instances_a: List[Instance], instances_b: List[Instance]
) -> np.ndarray:
    return np.stack([point_dist(a, b) for a, b in zip(instances_a, instances_b)])


def list_points(instances: List[Instance]) -> np.ndarray:
    return np.concatenate([inst.numpy() for inst in instances], axis=0)
