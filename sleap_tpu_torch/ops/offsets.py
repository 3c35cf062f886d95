"""Offset-regression ground truth (port of :mod:`sleap_tpu.ops.offsets`).

Functions take any leading batch axes: where the JAX package maps a
function over samples or instances, these broadcast.
"""

from __future__ import annotations

import torch


def make_offsets(
    points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """(..., n_points, 2) xy -> (..., grid_h, grid_w, n_points, 2) of
    (dx, dy) from each grid point to each point, divided by ``stride``;
    missing (NaN) points give 0."""
    x = points[..., None, None, :, 0]
    y = points[..., None, None, :, 1]
    dx = (x - xv[:, None]).expand(*x.shape[:-3], len(yv), len(xv), x.shape[-1])
    dy = (y - yv[:, None, None]).expand_as(dx)
    offsets = torch.stack([dx, dy], dim=-1) / float(stride)
    return torch.where(torch.isfinite(offsets), offsets, 0.0)


def mask_offsets(
    offsets: torch.Tensor, confmaps: torch.Tensor, threshold: float = 0.2
) -> torch.Tensor:
    """Zero the offsets wherever the matching confidence map is at or below
    ``threshold``."""
    return torch.where(confmaps[..., None] > threshold, offsets, 0.0)
