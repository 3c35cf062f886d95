"""Peak finding on confidence maps (port of :mod:`sleap_tpu.ops.peak_finding`).

Same contracts as the JAX functions: maps are (samples, H, W, channels);
global peaks are (samples, channels, 2) xy with NaN below threshold; local
peaks are the top-K per sample x channel as (samples, channels, K, 2) xy,
NaN where empty, with values 0 and mask False there.

The argmax, top-K and crop steps go through the kernels' dispatchers in
:mod:`~sleap_tpu_torch.ops.cuda_peaks` and :mod:`~sleap_tpu_torch.ops.cuda_crops`:
a CPU tensor runs their plain PyTorch versions (the oracles the kernels are
held against), a CUDA tensor runs the CUDA kernel, anything else raises. The
small steps around them (learned-offset gathers, the +-0.25 local-direction
refinement) are plain tensor code on either device, as they were XLA code
beside the Pallas kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sleap_tpu_torch.ops.cuda_crops import crop_unit
from sleap_tpu_torch.ops.cuda_peaks import (
    extract_patches,
    global_peaks,
    integral_regression,
    local_peaks,
)

__all__ = [
    "crop_bboxes_unit",
    "find_global_peaks",
    "find_global_peaks_rough",
    "find_global_peaks_with_offsets",
    "find_local_peaks",
    "find_local_peaks_with_offsets",
    "find_offsets_local_direction",
    "integral_regression",
]


def crop_bboxes_unit(
    images: torch.Tensor,
    top_left: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Bilinear crops with unit sample spacing from fractional top-left
    (x1, y1) corners: (B, H, W, C) -> (n_boxes, crop_h, crop_w, C) float32,
    zero outside the image."""
    return crop_unit(images, top_left, box_indices, crop_size)


def find_offsets_local_direction(
    centered_patches: torch.Tensor, delta: float = 0.25
) -> torch.Tensor:
    """+-delta by the sign of the gradient through the centre of (n, 3, 3)
    patches; returns (n, 2) (dx, dy)."""
    dx = centered_patches[:, 1, 2] - centered_patches[:, 1, 0]
    dy = centered_patches[:, 2, 1] - centered_patches[:, 0, 1]
    return torch.sign(torch.stack([dx, dy], dim=1)) * delta


def _integral_half(integral_patch_size: int) -> int:
    if integral_patch_size % 2 != 1:
        raise ValueError(f"integral_patch_size must be odd, got {integral_patch_size}.")
    return (integral_patch_size - 1) // 2


def _local_direction(cms: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Add the local-direction offsets to (S, C, K, 2) integer peaks."""
    S, H, W, C = cms.shape
    K = xy.shape[2]
    maps = cms.permute(0, 3, 1, 2).reshape(S * C, H, W).float()
    map_inds = torch.arange(S * C, device=cms.device).repeat_interleave(K)
    patches = extract_patches(maps, xy.reshape(-1, 2), map_inds, 3)
    return xy + find_offsets_local_direction(patches).reshape(xy.shape)


def find_global_peaks_rough(
    cms: torch.Tensor, threshold: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-aligned global maxima per sample x channel (first occurrence).

    Returns (samples, channels, 2) xy, NaN below threshold, and
    (samples, channels) values.
    """
    return global_peaks(cms, threshold, -1)


def find_global_peaks(
    cms: torch.Tensor,
    threshold: float = 0.2,
    refinement: Optional[str] = None,
    integral_patch_size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global peaks with optional "integral" or "local" subpixel refinement."""
    if refinement == "integral":
        return global_peaks(cms, threshold, _integral_half(integral_patch_size))
    xy, vals = find_global_peaks_rough(cms, threshold)
    if refinement == "local":
        xy = _local_direction(cms, xy[:, :, None])[:, :, 0]
    return xy, vals


def find_global_peaks_with_offsets(
    cms: torch.Tensor, offsets: torch.Tensor, threshold: float = 0.2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global peaks refined by learned offset maps ``(S, H, W, 2 * C)``."""
    rough, vals = find_global_peaks_rough(cms, threshold)
    S, H, W, C = cms.shape
    off = offsets.reshape(S, H, W, C, 2)
    xi = torch.nan_to_num(rough[..., 0]).long()
    yi = torch.nan_to_num(rough[..., 1]).long()
    sm = torch.arange(S, device=cms.device)[:, None]
    ch = torch.arange(C, device=cms.device)[None, :]
    return rough + off[sm, yi, xi, ch], vals


def find_local_peaks(
    cms: torch.Tensor,
    max_peaks: int = 32,
    threshold: float = 0.2,
    refinement: Optional[str] = None,
    integral_patch_size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K local maxima per sample x channel, statically shaped.

    Strict 8-neighbour NMS (out-of-map neighbours count as -inf) above
    ``threshold``, ordered by value descending then row-major index
    ascending.

    Returns:
        peak_points: (samples, channels, K, 2) xy; NaN where invalid.
        peak_vals: (samples, channels, K); 0 where invalid.
        peak_mask: (samples, channels, K) bool validity.
    """
    half = _integral_half(integral_patch_size) if refinement == "integral" else -1
    peaks, vals = local_peaks(cms, max_peaks, threshold, half)
    if refinement == "local":
        peaks = _local_direction(cms, peaks)
    valid = torch.isfinite(vals)
    peaks = torch.where(valid[..., None], peaks, float("nan"))
    return peaks, torch.where(valid, vals, 0.0), valid


def find_local_peaks_with_offsets(
    cms: torch.Tensor,
    offsets: torch.Tensor,
    max_peaks: int = 32,
    threshold: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local peaks refined by learned offset maps ``(S, H, W, 2 * C)``."""
    peaks, vals, mask = find_local_peaks(cms, max_peaks=max_peaks, threshold=threshold)
    S, H, W, C = cms.shape
    off = offsets.reshape(S, H, W, C, 2)
    xi = torch.nan_to_num(peaks[..., 0]).long()
    yi = torch.nan_to_num(peaks[..., 1]).long()
    sm = torch.arange(S, device=cms.device)[:, None, None]
    ch = torch.arange(C, device=cms.device)[None, :, None]
    refined = peaks + off[sm, yi, xi, ch]
    return torch.where(mask[..., None], refined, float("nan")), vals, mask
