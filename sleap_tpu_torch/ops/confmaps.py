"""Confidence-map ground truth (port of :mod:`sleap_tpu.ops.confmaps`).

Points are xy in full-image pixels with NaN for missing ones. Functions take
any leading batch axes: the JAX package maps over samples and instances,
these broadcast, so a batch's maps come from one set of launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sleap_tpu_torch.ops.offsets import make_offsets, mask_offsets


def make_confmaps(
    points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor, sigma: float
) -> torch.Tensor:
    """(..., n_nodes, 2) -> (..., grid_h, grid_w, n_nodes) float32
    Gaussians of stddev ``sigma``; a missing node's map is all 0."""
    x = points[..., None, None, :, 0]
    y = points[..., None, None, :, 1]
    cm = torch.exp(
        -((xv[:, None] - x) ** 2 + (yv[:, None, None] - y) ** 2) / (2 * sigma**2)
    )
    return torch.nan_to_num(cm, nan=0.0)


def _instances_in_image(
    instances: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor
) -> torch.Tensor:
    """(..., n_instances, n_nodes, 2) -> (..., n_instances) bool: some node
    strictly inside (0, last grid value) on both axes."""
    bound = torch.stack([xv[-1], yv[-1]])
    inside = (instances > 0) & (instances < bound)
    return inside.all(dim=-1).any(dim=-1)


def make_multi_confmaps(
    instances: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor, sigma: float
) -> torch.Tensor:
    """(..., n_instances, n_nodes, 2) -> (..., grid_h, grid_w, n_nodes): the
    maximum over the instances with a node in the image."""
    keep = _instances_in_image(instances, xv, yv)
    cms = make_confmaps(instances, xv, yv, sigma)
    cms = torch.where(keep[..., None, None, None], cms, 0.0)
    return cms.amax(dim=-4)


def make_multi_confmaps_with_offsets(
    instances: torch.Tensor,
    xv: torch.Tensor,
    yv: torch.Tensor,
    stride: int,
    sigma: float,
    offsets_threshold: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-instance maps plus offsets: (..., grid_h, grid_w, n_nodes) and
    (..., grid_h, grid_w, n_nodes, 2), each instance's offsets masked to
    where its own map exceeds the threshold, summed over instances."""
    keep = _instances_in_image(instances, xv, yv)
    cms = make_confmaps(instances, xv, yv, sigma)
    offs = mask_offsets(make_offsets(instances, xv, yv, stride), cms, offsets_threshold)
    cms = torch.where(keep[..., None, None, None], cms, 0.0)
    offs = torch.where(keep[..., None, None, None, None], offs, 0.0)
    return cms.amax(dim=-4), offs.sum(dim=-5)
