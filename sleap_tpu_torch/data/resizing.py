"""Image resizing and padding on NHWC tensors (port of
:mod:`sleap_tpu.data.resizing`), and cv2's uint8 bilinear resize on the
host, which size-matches frames of videos that differ in size."""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


# cv2's fixed-point bilinear resize of uint8 images: 11-bit weights.
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's source taps (i0, i1) and fixed-point weights (w0, w1) of each
    output index along one axis. The scale is the double ``1 / (dst / src)``;
    the half-pixel source position is rounded to float32, as cv2 computes
    it, and the weights are ``rint(weight * 2048)``. Taps past the edges
    clamp; along x their weights become (2048, 0) as well, while along y cv2
    keeps the unclamped fraction on the repeated edge row."""
    scale = 1.0 / (np.float64(dst) / np.float64(src))
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos)
    frac = (pos - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    if clamp_weights:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def resize_linear_uint8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (new_w, new_h))`` (``INTER_LINEAR``), bit for bit,
    for uint8 (H, W) or (H, W, C) frames, on the host without cv2.

    cv2's uint8 route: each row is blended along x in integers with 11-bit
    weights; rows are then blended along y as
    ``((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1 >> 16)`` and rounded by
    ``(v + 2) >> 2``. An exact halving of both sides takes cv2's 2x2 area
    mean, ``(a + b + c + d + 2) >> 2``; the same size is a copy. The output
    keeps the input's rank.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_uint8 takes uint8 frames, not {img.dtype}.")
    new_h, new_w = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return img.copy()
    x = img.reshape(h, w, -1).astype(np.int32)
    if (h, w) == (2 * new_h, 2 * new_w):
        out = (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2
    else:
        x0, x1, a0, a1 = _linear_taps(w, new_w, clamp_weights=True)
        y0, y1, b0, b1 = _linear_taps(h, new_h, clamp_weights=False)
        rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
        out = (((rows[y0] >> 4) * b0[:, None, None] >> 16)
               + ((rows[y1] >> 4) * b1[:, None, None] >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape(new_h, new_w, *img.shape[2:])
