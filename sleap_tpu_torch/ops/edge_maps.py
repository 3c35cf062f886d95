"""Part-affinity-field ground truth (port of :mod:`sleap_tpu.ops.edge_maps`).

As in the JAX package (and the reference it follows), the edge confidence
is the unnormalized Gaussian of the *squared* point-to-segment distance,
``exp(-d^4 / (2 sigma^2))``: trained models and grouping thresholds depend
on that shape. Functions take any leading batch axes and broadcast.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from sleap_tpu_torch.ops.grid import gaussian_pdf


def distance_to_edge(
    points: torch.Tensor, edge_source: torch.Tensor, edge_destination: torch.Tensor
) -> torch.Tensor:
    """Squared distance from points (..., 2) to segments (..., n_edges, 2),
    which broadcast against ``points[..., None, :]``: (..., n_edges)."""
    direction = edge_destination - edge_source
    edge_length = torch.clamp(torch.sum(torch.square(direction), dim=-1), min=1.0)
    rel = points[..., None, :] - edge_source
    t = torch.clamp(torch.sum(rel * direction, dim=-1) / edge_length, 0.0, 1.0)
    return torch.sum(torch.square(t[..., None] * direction - rel), dim=-1)


def make_edge_maps(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_source: torch.Tensor,
    edge_destination: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Segments (..., n_edges, 2) -> (..., grid_h, grid_w, n_edges) edge
    confidences."""
    grid = torch.stack(torch.meshgrid(xv, yv, indexing="xy"), dim=-1)  # (H, W, 2)
    distances = distance_to_edge(
        grid, edge_source[..., None, None, :, :], edge_destination[..., None, None, :, :]
    )
    return gaussian_pdf(distances, sigma=sigma)


def make_pafs(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_source: torch.Tensor,
    edge_destination: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """(..., grid_h, grid_w, n_edges, 2): each edge's unit vector times its
    confidence; NaN for a missing or zero-length edge."""
    direction = edge_destination - edge_source
    unit = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    conf = make_edge_maps(xv, yv, edge_source, edge_destination, sigma)
    return conf[..., None] * unit[..., None, None, :, :]


def make_multi_pafs(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_sources: torch.Tensor,
    edge_destinations: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Segments (..., n_instances, n_edges, 2) -> (..., grid_h, grid_w,
    n_edges, 2): the sum over instances, NaN contributions zeroed."""
    pafs = make_pafs(xv, yv, edge_sources, edge_destinations, sigma)
    return torch.nan_to_num(pafs, nan=0.0).sum(dim=-5)


def get_edge_points(
    instances: torch.Tensor, edge_inds: Sequence[Tuple[int, int]]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n_nodes, 2) -> source and destination points (..., n_edges, 2)."""
    inds = torch.as_tensor(edge_inds, dtype=torch.long, device=instances.device).reshape(-1, 2)
    return instances[..., inds[:, 0], :], instances[..., inds[:, 1], :]
