"""Rigid alignment of instances to a template (port of
:mod:`sleap_tpu.info.align`): point sets rotated onto a mean pose (2D,
Kabsch) for pose statistics; host numpy."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_mean_and_std_for_points(
    points: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and std over an (instances, nodes, 2) stack."""
    return np.nanmean(points, axis=0), np.nanstd(points, axis=0)


def align_instance_points(source_points: np.ndarray, target_points: np.ndarray) -> np.ndarray:
    """Rotate source points (about their centroid) to best match target."""
    src_c = np.nanmean(source_points, axis=0)
    tgt_c = np.nanmean(target_points, axis=0)
    src = source_points - src_c
    tgt = target_points - tgt_c
    mask = ~(np.isnan(src).any(axis=1) | np.isnan(tgt).any(axis=1))
    if mask.sum() < 2:
        return source_points
    H = src[mask].T @ tgt[mask]
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1, d]) @ U.T
    return (src @ R.T) + tgt_c


def align_instances(
    all_points: np.ndarray, node_a: int = 0, node_b: int = 1, rotate_on_axis: bool = False
) -> np.ndarray:
    """Center all instances on node_a and rotate so node_a->node_b aligns
    with the vertical axis."""
    aligned = []
    for pts in all_points:
        pts = pts.copy()
        origin = pts[node_a]
        pts = pts - origin
        vec = pts[node_b]
        if not np.isnan(vec).any() and np.linalg.norm(vec) > 0:
            theta = np.arctan2(vec[0], vec[1])
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s], [s, c]])
            pts = pts @ R.T
        aligned.append(pts)
    return np.stack(aligned)


def align_instances_on_most_stable(
    all_points: np.ndarray, min_stable_dist: float = 4.0
) -> np.ndarray:
    """Pick the most consistently-distanced node pair and align on it."""
    n_nodes = all_points.shape[1]
    best = (0, min(1, n_nodes - 1))
    best_cv = np.inf
    for a in range(n_nodes):
        for b in range(a + 1, n_nodes):
            d = np.linalg.norm(all_points[:, a] - all_points[:, b], axis=1)
            d = d[~np.isnan(d)]
            if len(d) < 2 or np.mean(d) < min_stable_dist:
                continue
            cv = np.std(d) / (np.mean(d) + 1e-9)
            if cv < best_cv:
                best_cv = cv
                best = (a, b)
    return align_instances(all_points, node_a=best[0], node_b=best[1])


def get_instances_points(instances) -> np.ndarray:
    return np.stack([inst.numpy() for inst in instances])


def get_template_points_array(instances) -> np.ndarray:
    """Mean pose of aligned instances."""
    pts = get_instances_points(instances)
    aligned = align_instances_on_most_stable(pts)
    mean, _ = get_mean_and_std_for_points(aligned)
    return mean
