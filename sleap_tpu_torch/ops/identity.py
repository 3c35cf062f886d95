"""Class-identity grouping (port of :mod:`sleap_tpu.ops.identity`).

Peaks arrive in the static (samples, channels, K) layout, so the class
assignment of every group is one batched linear assignment
(:func:`~sleap_tpu_torch.ops.lap.solve_lap`) over padded (N, N) costs, on
the caller's device. Peaks are matched to classes by maximum total class
probability, then a match is dropped where its class is not the peak's most
probable one (exact equality, as in the JAX package), where the peak is
masked, or where the probability is not finite.

Plain tensor code on either device: the JAX functions are XLA, not Pallas.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sleap_tpu_torch.ops.lap import PAD_COST, solve_lap

__all__ = ["classify_peaks_from_maps", "classify_peaks_from_vectors"]


def _assign_classes(
    probs: torch.Tensor, peak_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class assignment for groups of peaks.

    Args:
        probs: (B, K, n_classes) class probabilities per peak.
        peak_mask: (B, K) peak validity.

    Returns:
        peak_for_class: (B, n_classes) index of the peak assigned to each
            class, clipped to [0, K).
        valid: (B, n_classes) bool: the assignment exists, its peak is valid
            and the class is that peak's most probable one.
    """
    B, K, n_classes = probs.shape
    N = max(K, n_classes)
    neg = torch.where(peak_mask[..., None], -probs, PAD_COST)
    neg = torch.nan_to_num(neg, nan=PAD_COST)  # +-inf to the dtype's extremes, as jnp's
    cost = torch.full((B, N, N), PAD_COST, dtype=torch.float32, device=probs.device)
    cost[:, :K, :n_classes] = neg
    _, row4col = solve_lap(cost)  # row = peak, column = class
    peak_for_class = row4col[:, :n_classes]
    pfc = peak_for_class.clamp(0, K - 1)
    # rows[b, c] = probs[b, pfc[b, c]]: the assigned peak's probabilities.
    rows = probs.gather(1, pfc[:, :, None].expand(B, n_classes, n_classes))
    matched = rows.diagonal(dim1=1, dim2=2)
    best = rows.amax(dim=-1)  # NaN if any is NaN, as jnp.max
    valid = (
        (peak_for_class >= 0)
        & (peak_for_class < K)
        & peak_mask.gather(1, pfc)
        & (matched == best)
        & torch.isfinite(matched)
    )
    return pfc, valid


def classify_peaks_from_maps(
    class_maps: torch.Tensor,
    peaks: torch.Tensor,
    peak_vals: torch.Tensor,
    peak_mask: torch.Tensor,
    class_maps_stride: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group peaks into identities by the class maps at the peaks.

    Args:
        class_maps: (S, H', W', n_classes) at stride ``class_maps_stride``.
        peaks: (S, C, K, 2) xy in image scale (NaN-padded).
        peak_vals / peak_mask: (S, C, K).

    Returns:
        points: (S, n_classes, C, 2); point_vals / class_probs:
        (S, n_classes, C); NaN where a class has no peak.
    """
    S, Hs, Ws, n_classes = class_maps.shape
    C, K = peaks.shape[1], peaks.shape[2]
    # torch.round rounds half to even, as jnp.round does.
    cols = torch.round(torch.nan_to_num(peaks[..., 0]) / class_maps_stride).long().clamp(0, Ws - 1)
    rows = torch.round(torch.nan_to_num(peaks[..., 1]) / class_maps_stride).long().clamp(0, Hs - 1)
    flat = (rows * Ws + cols).reshape(S, C * K, 1).expand(S, C * K, n_classes)
    probs = class_maps.reshape(S, Hs * Ws, n_classes).gather(1, flat).reshape(S, C, K, n_classes)

    pfc, valid = _assign_classes(
        probs.reshape(S * C, K, n_classes), peak_mask.reshape(S * C, K)
    )
    pfc = pfc.reshape(S, C, n_classes)
    valid = valid.reshape(S, C, n_classes)

    # points[s, class, c] = peaks[s, c, pfc[s, c, class]]
    pts = peaks.gather(2, pfc[..., None].expand(S, C, n_classes, 2))
    vals = peak_vals.gather(2, pfc)
    matched = probs.gather(2, pfc[..., None].expand(S, C, n_classes, n_classes))
    matched = matched.diagonal(dim1=2, dim2=3)

    nan = float("nan")
    pts = torch.where(valid[..., None], pts, nan)
    vals = torch.where(valid, vals, nan)
    matched = torch.where(valid, matched, nan)
    return pts.permute(0, 2, 1, 3), vals.permute(0, 2, 1), matched.permute(0, 2, 1)


def classify_peaks_from_vectors(
    peaks: torch.Tensor,
    peak_vals: torch.Tensor,
    class_probs: torch.Tensor,
    peak_mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group cropped-instance peaks into identities by their class vectors.

    Args:
        peaks: (S, K, C, 2) per-crop peaks (K crops per sample, C nodes).
        peak_vals: (S, K, C).
        class_probs: (S, K, n_classes) softmax outputs per crop.
        peak_mask: (S, K) crop validity.

    Returns:
        points: (S, n_classes, C, 2); point_vals / probs: (S, n_classes, C);
        NaN where a class has no crop.
    """
    S, K, C, _ = peaks.shape
    n_classes = class_probs.shape[-1]
    pfc, valid = _assign_classes(class_probs, peak_mask)  # (S, n_classes)

    pts = peaks.gather(1, pfc[:, :, None, None].expand(S, n_classes, C, 2))
    vals = peak_vals.gather(1, pfc[:, :, None].expand(S, n_classes, C))
    probs = class_probs.gather(1, pfc[..., None].expand(S, n_classes, n_classes))
    probs = probs.diagonal(dim1=1, dim2=2)

    nan = float("nan")
    pts = torch.where(valid[:, :, None, None], pts, nan)
    vals = torch.where(valid[:, :, None], vals, nan)
    probs = torch.where(valid[:, :, None], probs[:, :, None].expand(S, n_classes, C), nan)
    return pts, vals, probs
