"""Instance centroids (port of :mod:`sleap_tpu.data.instance_centroids`).

A centroid is the anchor part's location, or the midpoint of the bounding
box of the visible points when the anchor is missing or unset; an instance
with no visible point has a NaN centroid. Works on any leading axes, on
the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import torch


def _nan_extreme(x: torch.Tensor, dim: int, largest: bool) -> torch.Tensor:
    """``nanmax``/``nanmin`` along ``dim``: NaN where every entry is NaN."""
    nan = torch.isnan(x)
    fill = float("-inf") if largest else float("inf")
    filled = torch.where(nan, fill, x)
    out = filled.amax(dim=dim) if largest else filled.amin(dim=dim)
    return torch.where(nan.all(dim=dim), float("nan"), out)


def get_instance_centroids(
    instances: torch.Tensor, anchor_ind: Optional[int] = None
) -> torch.Tensor:
    """(..., n_nodes, 2) -> (..., 2) anchor or bounding-box-midpoint
    centroids."""
    mids = (_nan_extreme(instances, -2, False) + _nan_extreme(instances, -2, True)) / 2.0
    if anchor_ind is None:
        return mids
    anchors = instances[..., anchor_ind, :]
    missing = torch.isnan(anchors).any(dim=-1, keepdim=True)
    return torch.where(missing, mids, anchors)
