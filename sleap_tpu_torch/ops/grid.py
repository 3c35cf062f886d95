"""Sampling grids (port of :mod:`sleap_tpu.ops.grid`).

Grid vectors hold full-image pixel coordinates sampled every
``output_stride`` pixels, so ``grid_width = image_width // output_stride``
(rounded up) and values span ``[0, image_width)``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def make_grid_vectors(
    image_height: int, image_width: int, output_stride: int = 1, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xv, yv) float32 grid vectors in full-image pixel units."""
    xv = torch.arange(0, image_width, output_stride, dtype=torch.float32, device=device)
    yv = torch.arange(0, image_height, output_stride, dtype=torch.float32, device=device)
    return xv, yv


def gaussian_pdf(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Unnormalized 0-centered Gaussian: 1.0 at x == 0."""
    return torch.exp(-torch.square(x) / (2 * sigma**2))
