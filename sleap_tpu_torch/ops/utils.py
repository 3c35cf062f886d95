"""Grouping and matching helpers (port of :mod:`sleap_tpu.ops.utils`).

``group_array`` and ``compute_iou`` run on the host; ``match_points`` solves
its assignment with the port's LAP solver (:func:`~sleap_tpu_torch.ops.lap.solve_lap`)
on the points' device: torch tensors stay where they are, numpy arrays run
on the CPU.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np
import torch

from sleap_tpu_torch.ops.lap import PAD_COST, solve_lap


def group_array(X: np.ndarray, groups: np.ndarray, axis: int = 0) -> Dict[object, np.ndarray]:
    """Group slices of ``X`` along ``axis`` into a dict keyed by ``groups``.

    Example::

        >>> group_array(np.arange(5), np.array([1, 5, 2, 1, 5]))
        {1: array([0, 3]), 5: array([1, 4]), 2: array([2])}
    """
    group_inds = defaultdict(list)
    for ind, key in enumerate(groups):
        group_inds[key].append(ind)
    return {key: np.take(X, inds, axis=axis) for key, inds in group_inds.items()}


def compute_iou(bbox1: np.ndarray, bbox2: np.ndarray) -> float:
    """IoU of two ``[y1, x1, y2, x2]`` boxes, counting pixels inclusively
    (a width is ``x2 - x1 + 1``)."""
    b1y1, b1x1, b1y2, b1x2 = bbox1
    b2y1, b2x1, b2y2, b2x2 = bbox2
    iy = max(min(b1y2, b2y2) - max(b1y1, b2y1) + 1, 0)
    ix = max(min(b1x2, b2x2) - max(b1x1, b2x1) + 1, 0)
    inter = ix * iy
    a1 = (b1x2 - b1x1 + 1) * (b1y2 - b1y1 + 1)
    a2 = (b2x2 - b2x1 + 1) * (b2y2 - b2y1 + 1)
    return inter / (a1 + a2 - inter)


def match_points(points1, points2) -> Tuple[np.ndarray, np.ndarray]:
    """Match two point sets by minimum total Euclidean distance.

    Returns int32 index vectors ``(inds1, inds2)`` of length ``min(N, M)``:
    ``points1[inds1[k]]`` pairs with ``points2[inds2[k]]``. The cost is
    padded square with ``PAD_COST`` (1e3), which no real pairing beats, and
    solved on the device of ``points1`` (the CPU for numpy input).
    """
    device = points1.device if isinstance(points1, torch.Tensor) else torch.device("cpu")
    p1 = torch.as_tensor(points1, dtype=torch.float32, device=device)
    p2 = torch.as_tensor(points2, dtype=torch.float32, device=device)
    n, m = p1.shape[0], p2.shape[0]
    dists = torch.linalg.vector_norm(p1[:, None, :] - p2[None, :, :], dim=-1)
    k = max(n, m)
    cost = torch.full((k, k), PAD_COST, dtype=torch.float32, device=device)
    cost[:n, :m] = dists
    col4row, _ = solve_lap(cost)
    cols = col4row.cpu().numpy()
    rows = np.arange(k)
    keep = (rows < n) & (cols < m)
    return rows[keep].astype(np.int32), cols[keep].astype(np.int32)
