"""Image resizing and padding on NHWC tensors (port of
:mod:`sleap_tpu.data.resizing`), and cv2's uint8 bilinear resize on the
host, which size-matches frames of videos that differ in size."""

from __future__ import annotations

from typing import Optional, Tuple

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


def _linear_taps(src: int, dst: int, clamp_weights: bool, inv_scale: Optional[float] = None):
    """cv2's source taps (i0, i1) and fixed-point weights (w0, w1) of each
    output index along one axis. The scale is the double ``1 / inv_scale``,
    ``inv_scale`` being ``dst / src`` unless the caller gave a factor; the
    half-pixel source position is rounded to float32, as cv2 computes
    it, and the weights are ``rint(weight * 2048)``. Taps past the edges
    clamp; along x their weights become (2048, 0) as well, while along y cv2
    keeps the unclamped fraction on the repeated edge row."""
    if inv_scale is None:
        inv_scale = np.float64(dst) / np.float64(src)
    scale = 1.0 / np.float64(inv_scale)
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(pos)
    frac = (pos - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    if clamp_weights:
        frac[(i0 < 0) | (i0 >= src - 1)] = 0
    w1 = np.rint(frac * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w0, w1


def _halve(x: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """cv2's fast 2x2 area mean of (H, W, C) int32 pixels to (new_h, new_w):
    ``(a + b + c + d + 2) >> 2`` on whole blocks; a block cut by an odd edge
    is the float32 mean of the pixels it has, rounded half to even."""
    h, w = x.shape[:2]
    fh, fw = h // 2, w // 2
    out = np.empty((new_h, new_w, x.shape[2]), np.int32)
    a = x[:2 * fh, :2 * fw]
    out[:fh, :fw] = (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2] + 2) >> 2
    edge = [(dy, dx) for dy in range(new_h) for dx in range(fw, new_w)]
    edge += [(dy, dx) for dy in range(fh, new_h) for dx in range(min(fw, new_w))]
    for dy, dx in edge:
        block = x[2 * dy:2 * dy + 2, 2 * dx:2 * dx + 2]
        mean = block.sum(axis=(0, 1)).astype(np.float32) / np.float32(block.shape[0] * block.shape[1])
        out[dy, dx] = np.rint(mean)
    return out


def resize_linear_uint8(img: np.ndarray, size: Optional[Tuple[int, int]] = None,
                        fx: Optional[float] = None, fy: Optional[float] = None) -> np.ndarray:
    """``cv2.resize(img, (new_w, new_h))`` (``INTER_LINEAR``), bit for bit,
    for uint8 (H, W) or (H, W, C) frames, on the host without cv2; or, with
    no ``size``, ``cv2.resize(img, None, None, fx, fy)``: the new size is
    ``rint(W * fx)`` by ``rint(H * fy)`` and the source step ``1 / fx``.

    cv2's uint8 route: each row is blended along x in integers with 11-bit
    weights; rows are then blended along y as
    ``((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1 >> 16)`` and rounded by
    ``(v + 2) >> 2``. A source step of exactly 2 on both sides takes cv2's
    fast 2x2 area mean (:func:`_halve`); the same size is a copy. The output
    keeps the input's rank.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_uint8 takes uint8 frames, not {img.dtype}.")
    h, w = img.shape[:2]
    if size is None:
        new_h, new_w = int(np.rint(h * fy)), int(np.rint(w * fx))
        inv_y, inv_x = float(fy), float(fx)
    else:
        new_h, new_w = int(size[0]), int(size[1])
        inv_y, inv_x = new_h / h, new_w / w
    if new_h <= 0 or new_w <= 0:
        raise ValueError(f"Cannot resize a {h}x{w} frame to {new_h}x{new_w}.")
    if (inv_y, inv_x) == (1.0, 1.0):
        return img.copy()
    x = img.reshape(h, w, -1).astype(np.int32)
    if 1.0 / inv_y == 2.0 and 1.0 / inv_x == 2.0:
        out = _halve(x, new_h, new_w)
    else:
        x0, x1, a0, a1 = _linear_taps(w, new_w, True, None if size is not None else inv_x)
        y0, y1, b0, b1 = _linear_taps(h, new_h, False, None if size is not None else inv_y)
        rows = x[:, x0] * a0[None, :, None] + x[:, x1] * a1[None, :, None]
        out = (((rows[y0] >> 4) * b0[:, None, None] >> 16)
               + ((rows[y1] >> 4) * b1[:, None, None] >> 16) + 2) >> 2
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape(new_h, new_w, *img.shape[2:])


def resize_and_pad_to_target(image: torch.Tensor, target_height: int,
                             target_width: int) -> Tuple[torch.Tensor, float]:
    """Scale (..., H, W, C) images to fit inside the target (half-pixel
    bilinear, no antialiasing, ``round(dim * scale)``), then zero-pad the
    bottom and right to it. Returns the float32 images and the scale;
    points map back as ``points / scale``."""
    h, w, c = image.shape[-3:]
    scale = min(target_height / h, target_width / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    flat = image.reshape(-1, h, w, c).float().permute(0, 3, 1, 2)
    resized = F.interpolate(flat, size=(new_h, new_w), mode="bilinear", align_corners=False,
                            antialias=False).permute(0, 2, 3, 1)
    padded = F.pad(resized, (0, 0, 0, target_width - new_w, 0, target_height - new_h))
    return padded.reshape(*image.shape[:-3], target_height, target_width, c), scale


class PointsRescaler:
    """A block of example dicts that divides (``invert``) or multiplies the
    points under ``points_key`` by the scale under ``scale_key``: the scale
    gets leading axes to the points' rank."""

    def __init__(self, points_key: str = "predicted_instances", scale_key: str = "scale",
                 invert: bool = True):
        self.points_key = points_key
        self.scale_key = scale_key
        self.invert = invert

    @property
    def input_keys(self):
        return [self.points_key, self.scale_key]

    @property
    def output_keys(self):
        return self.input_keys

    def transform_dataset(self, examples):
        for ex in examples:
            points = np.asarray(ex[self.points_key], dtype=np.float32)
            scale = np.asarray(ex[self.scale_key], dtype=np.float32)
            if scale.ndim < points.ndim:
                scale = scale.reshape((1,) * (points.ndim - scale.ndim) + scale.shape)
            ex = dict(ex)
            ex[self.points_key] = points / scale if self.invert else points * scale
            yield ex
