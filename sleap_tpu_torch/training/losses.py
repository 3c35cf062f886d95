"""Training losses (port of :mod:`sleap_tpu.training.losses`): the mean
squared error on maps, online hard keypoint mining on top of it, and the
categorical cross-entropy of class vectors. Every count stays on the
device: nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def mse_loss(y_gt: torch.Tensor, y_pr: torch.Tensor, count: Optional[int] = None) -> torch.Tensor:
    """Mean squared error over all elements; with ``count``, their sum over
    ``count`` (a band's share of a larger batch's mean)."""
    if count is not None:
        return torch.sum(torch.square(y_gt - y_pr)) / count
    return torch.mean(torch.square(y_gt - y_pr))


def compute_ohkm_loss(
    y_gt: torch.Tensor,
    y_pr: torch.Tensor,
    hard_to_easy_ratio: float = 2.0,
    min_hard_keypoints: int = 2,
    max_hard_keypoints: Optional[int] = None,
    loss_scale: float = 5.0,
    channel_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    count: Optional[int] = None,
) -> torch.Tensor:
    """Online hard keypoint mining: the channels whose mean squared error
    exceeds ``hard_to_easy_ratio`` times the easiest channel's are hard
    (at least ``min_hard_keypoints``, at most ``max_hard_keypoints`` and the
    channel count); the mean of the hardest that many losses, times
    ``loss_scale``. ``channel_sum`` maps this shard's per-channel sums of
    squared errors to the whole batch's, which ``count`` elements a channel
    divide (a sharded step's sum over its ranks)."""
    n_channels = y_gt.shape[-1]
    axes = tuple(range(y_gt.ndim - 1))
    if channel_sum is None:
        ch_losses = torch.mean(torch.square(y_gt - y_pr), dim=axes)
    else:
        ch_losses = channel_sum(torch.sum(torch.square(y_gt - y_pr), dim=axes)) / count
    easy = torch.min(ch_losses)
    n_hard = torch.sum(ch_losses > easy * hard_to_easy_ratio)
    k = torch.clamp(n_hard, min=min_hard_keypoints)
    if max_hard_keypoints is not None:
        k = torch.clamp(k, max=max_hard_keypoints)
    k = torch.clamp(k, max=n_channels)
    sorted_losses = torch.sort(ch_losses, descending=True).values
    mask = torch.arange(n_channels, device=ch_losses.device) < k
    hard_loss = torch.sum(torch.where(mask, sorted_losses, 0.0)) / torch.clamp(k.float(), min=1.0)
    return hard_loss * loss_scale


def categorical_crossentropy(y_gt: torch.Tensor, y_pr: torch.Tensor,
                             count: Optional[int] = None) -> torch.Tensor:
    """Mean categorical cross-entropy of softmax outputs, clipped at 1e-7;
    with ``count``, the sum over the samples over ``count``."""
    eps = 1e-7
    per_sample = torch.sum(y_gt * torch.log(torch.clamp(y_pr, eps, 1.0)), dim=-1)
    if count is not None:
        return -torch.sum(per_sample) / count
    return -torch.mean(per_sample)
