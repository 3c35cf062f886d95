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

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sleap_tpu_torch.ops.cuda_crops import crop_unit
from sleap_tpu_torch.ops.cuda_peaks import (
    GLOBAL_DTYPES,
    extract_patches,
    global_peaks,
    hwcs_ok,
    integral_regression,
    local_peaks,
    local_peaks_hwcs,
)

__all__ = [
    "crop_and_resize",
    "crop_bboxes",
    "crop_bboxes_unit",
    "find_global_peaks",
    "find_global_peaks_rough",
    "find_global_peaks_with_offsets",
    "find_local_peaks",
    "find_local_peaks_with_offsets",
    "find_offsets_local_direction",
    "flatten_local_peaks",
    "integral_regression",
    "make_centered_bboxes",
    "make_gaussian_kernel",
    "smooth_imgs",
]


def make_gaussian_kernel(size: int, sigma: float) -> torch.Tensor:
    """(2 * (size // 2) + 1)-square unnormalized float32 Gaussian, 1 at the
    centre."""
    gv = torch.arange(-(size // 2), size // 2 + 1, dtype=torch.float32)
    return torch.exp(-(gv.reshape(1, -1) ** 2 + gv.reshape(-1, 1) ** 2) / (2 * sigma**2))


def smooth_imgs(imgs: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Channelwise Gaussian blur (normalized by ``2 pi sigma^2``) of
    (samples, height, width, channels) maps: a depthwise convolution with
    SAME zero padding, in float32."""
    channels = imgs.shape[-1]
    kernel = make_gaussian_kernel(kernel_size, sigma) / (2 * math.pi * sigma**2)
    k = kernel.shape[0]
    weight = kernel.to(imgs.device).reshape(1, 1, k, k).expand(channels, 1, k, k)
    x = imgs.float().permute(0, 3, 1, 2)
    return F.conv2d(x, weight, padding=k // 2, groups=channels).permute(0, 2, 3, 1)


def make_centered_bboxes(
    centroids: torch.Tensor, box_height: int, box_width: int
) -> torch.Tensor:
    """(..., 2) xy centroids -> (..., 4) (y1, x1, y2, x2) boxes centered on
    them, pixel-centered: a (3, 3) box at (1, 1) is (0, 0, 2, 2)."""
    cx, cy = centroids[..., 0], centroids[..., 1]
    dy = (box_height - 1) / 2.0
    dx = (box_width - 1) / 2.0
    return torch.stack([cy - dy, cx - dx, cy + dy, cx + dx], dim=-1)


def crop_and_resize(
    images: torch.Tensor,
    boxes: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Bilinear crop-and-resize as ``tf.image.crop_and_resize``, the crops
    training cuts (the JAX package's XLA op, not a kernel).

    The trainer's boxes span ``crop - 1`` pixels, so :func:`crop_bboxes_unit`
    computes nearly the same crops, but it samples ``floor(x1) + i +
    frac(x1)`` where this samples ``x1 + (x2 - x1) * i / (n - 1)``: on 1024^2
    frames with 160^2 crops the float32 positions differ by up to ~6e-5 px,
    and the crops by as much, which the ground truth's 1e-6 parity with JAX
    does not allow (``tests/test_torch_gt_codecs.py``).

    ``images`` (B, H, W, C); ``boxes`` (n, 4) unnormalized (y1, x1, y2, x2)
    whose corners map onto the crop's corner pixels; ``box_indices`` (n,)
    the image of each box. Returns (n, crop_h, crop_w, C) float32; taps
    outside the image read 0.
    """
    crop_h, crop_w = crop_size
    H, W = images.shape[1], images.shape[2]
    y1, x1, y2, x2 = boxes.unbind(-1)

    def positions(lo, hi, n):
        if n > 1:
            steps = torch.arange(n, dtype=torch.float32, device=lo.device) / (n - 1)
            return lo[:, None] + (hi - lo)[:, None] * steps
        return ((lo + hi) / 2.0)[:, None]

    ys, xs = positions(y1, y2, crop_h), positions(x1, x2, crop_w)
    imgs = images.float()
    bi = box_indices.long()[:, None, None]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]

    def gather(yi, xi):
        valid = ((yi >= 0) & (yi <= H - 1))[:, :, None] & ((xi >= 0) & (xi <= W - 1))[:, None, :]
        yc = yi.clamp(0, H - 1).long()[:, :, None]
        xc = xi.clamp(0, W - 1).long()[:, None, :]
        return torch.where(valid[..., None], imgs[bi, yc, xc], 0.0)

    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def crop_bboxes(
    images: torch.Tensor,
    bboxes: torch.Tensor,
    sample_inds: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """:func:`crop_and_resize` under the JAX package's older name."""
    return crop_and_resize(images, bboxes, sample_inds, crop_size)


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
    d = torch.stack([dx, dy], dim=1)
    # torch.sign(NaN) is 0; jnp.sign(NaN), which this follows, is NaN.
    return torch.where(torch.isnan(d), d, torch.sign(d)) * delta


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


def _global_maps(cms: torch.Tensor) -> torch.Tensor:
    """Maps as kernel ``global_peaks`` reads them: float32 and bf16 as they
    lie, any other dtype cast to float32."""
    return cms if cms.dtype in GLOBAL_DTYPES else cms.float()


def find_global_peaks_rough(
    cms: torch.Tensor, threshold: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-aligned global maxima per sample x channel (first occurrence).

    Returns (samples, channels, 2) xy, NaN below threshold, and
    (samples, channels) float32 values.
    """
    return global_peaks(_global_maps(cms), threshold, -1)


def find_global_peaks(
    cms: torch.Tensor,
    threshold: float = 0.2,
    refinement: Optional[str] = None,
    integral_patch_size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global peaks with optional "integral" or "local" subpixel refinement."""
    if refinement == "integral":
        return global_peaks(_global_maps(cms), threshold, _integral_half(integral_patch_size))
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
    ascending. bf16 maps that kernel ``local_peaks_hwcs`` takes
    (:func:`~sleap_tpu_torch.ops.cuda_peaks.hwcs_ok`), unrefined or with the
    5x5 integral window, go to it; every other case goes to kernel
    ``local_peaks`` on float32 maps.

    Returns:
        peak_points: (samples, channels, K, 2) xy; NaN where invalid.
        peak_vals: (samples, channels, K); 0 where invalid.
        peak_mask: (samples, channels, K) bool validity.
    """
    half = _integral_half(integral_patch_size) if refinement == "integral" else -1
    if refinement != "local" and hwcs_ok(cms, threshold, half):
        peaks, vals = local_peaks_hwcs(cms, max_peaks, threshold, half)
    else:
        peaks, vals = local_peaks(cms.float(), max_peaks, threshold, half)
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


def flatten_local_peaks(peaks, vals, mask) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Local peaks (S, C, K, ...) with their mask (S, C, K) as flat host
    arrays of the valid ones: points (n, 2), values (n,), and their sample
    and channel indices (n,) as int32."""
    peaks, vals, mask = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t) for t in (peaks, vals, mask))
    S, C, K = mask.shape
    sm = np.broadcast_to(np.arange(S)[:, None, None], (S, C, K))
    ch = np.broadcast_to(np.arange(C)[None, :, None], (S, C, K))
    m = mask.reshape(-1)
    return (
        peaks.reshape(-1, 2)[m],
        vals.reshape(-1)[m],
        sm.reshape(-1)[m].astype(np.int32),
        ch.reshape(-1)[m].astype(np.int32),
    )
