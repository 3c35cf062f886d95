"""Image resizing and padding on NHWC tensors (port of
:mod:`sleap_tpu.data.resizing`)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def find_padding_for_stride(
    image_height: int, image_width: int, max_stride: int
) -> Tuple[int, int]:
    """(pad_bottom, pad_right) so both dims are divisible by max_stride."""
    pad_bottom = (max_stride - (image_height % max_stride)) % max_stride
    pad_right = (max_stride - (image_width % max_stride)) % max_stride
    return pad_bottom, pad_right


def pad_to_stride(image: torch.Tensor, max_stride: int) -> torch.Tensor:
    """Zero-pad bottom/right so height and width divide max_stride."""
    pad_bottom, pad_right = find_padding_for_stride(image.shape[-3], image.shape[-2], max_stride)
    if pad_bottom == 0 and pad_right == 0:
        return image
    return F.pad(image, (0, 0, 0, pad_right, 0, pad_bottom))


def resize_image(image: torch.Tensor, scale) -> torch.Tensor:
    """Half-pixel bilinear resize of (N, H, W, C) images by a scale factor.

    As the JAX package: ``scale`` is a float or an ``[scale_x, scale_y]``
    pair, the new size is the truncated ``int(dim * scale)``, there is no
    antialiasing, and integer images are truncated and cast back.
    """
    if isinstance(scale, (tuple, list)):
        scale_x, scale_y = float(scale[0]), float(scale[1])
    else:
        scale_x = scale_y = float(scale)
    if scale_x == 1.0 and scale_y == 1.0:
        return image
    h, w = image.shape[-3], image.shape[-2]
    size = (int(h * scale_y), int(w * scale_x))
    resized = F.interpolate(
        image.float().permute(0, 3, 1, 2), size=size, mode="bilinear",
        align_corners=False, antialias=False,
    ).permute(0, 2, 3, 1)
    if not torch.is_floating_point(image):
        resized = torch.trunc(resized)
    return resized.to(image.dtype)
