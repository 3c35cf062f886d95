"""Image normalization on tensors (port of :mod:`sleap_tpu.data.normalization`).

Images are NHWC (or any ``(..., H, W, C)``), as in the JAX package, so raw
uint8 frames can move to the device and be normalized there.
"""

from __future__ import annotations

import torch

# ITU-R 601 luma coefficients (same as tf.image.rgb_to_grayscale).
_RGB_WEIGHTS = (0.2989, 0.5870, 0.1140)
_IMAGENET_MEAN_RGB = (0.485, 0.456, 0.406)
_IMAGENET_STD_RGB = (0.229, 0.224, 0.225)
_CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def ensure_grayscale(image: torch.Tensor) -> torch.Tensor:
    """(..., 3|1) -> (..., 1); RGB by ITU-R 601 luma, rounded for integers."""
    if image.shape[-1] != 3:
        return image
    gray = torch.tensordot(image.float(), _vec(_RGB_WEIGHTS, image), dims=([-1], [0]))[..., None]
    if not torch.is_floating_point(image):
        gray = torch.round(gray)
    return gray.to(image.dtype)


def ensure_rgb(image: torch.Tensor) -> torch.Tensor:
    """(..., 1|3) -> (..., 3) by channel replication."""
    if image.shape[-1] == 1:
        return image.expand(*image.shape[:-1], 3).contiguous()
    return image


def ensure_float(image: torch.Tensor) -> torch.Tensor:
    """Integer images -> float32 in [0, 1] (divide by the dtype max); float
    images -> float32."""
    if not torch.is_floating_point(image):
        return image.float() / float(torch.iinfo(image.dtype).max)
    return image.float()


def ensure_int(image: torch.Tensor) -> torch.Tensor:
    """Float images -> uint8: scaled by 255 first when their maximum is at
    most 1, clipped to [0, 255] and truncated; integer images pass through."""
    if not torch.is_floating_point(image):
        return image
    scaled = image * 255.0 if image.max() <= 1.0 else image
    return scaled.clamp(0, 255).to(torch.uint8)


def convert_rgb_to_bgr(image: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis (a grayscale image is made RGB first)."""
    return ensure_rgb(image).flip(-1)


def ensure_min_image_rank(image: torch.Tensor) -> torch.Tensor:
    """Append a channel axis to a rank-2 (H, W) image."""
    if image.ndim == 2:
        return image[..., None]
    return image


def scale_image_range(image: torch.Tensor, min_val: float, max_val: float) -> torch.Tensor:
    """Rescale a [0, 1] image to [min_val, max_val]."""
    return image * (max_val - min_val) + min_val


def scale_to_imagenet_torch_mode(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float RGB -> standardized by the ImageNet mean and std."""
    return (image - _vec(_IMAGENET_MEAN_RGB, image)) / _vec(_IMAGENET_STD_RGB, image)


def scale_to_imagenet_caffe_mode(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float RGB -> BGR in 0-255, less the ImageNet mean."""
    return image.flip(-1) * 255.0 - _vec(_CAFFE_MEAN_BGR, image)


def scale_to_imagenet_tf_mode(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> [-1, 1]."""
    return image * 2.0 - 1.0


_IMAGENET_MODES = {
    "tf": scale_to_imagenet_tf_mode,
    "caffe": scale_to_imagenet_caffe_mode,
    "torch": scale_to_imagenet_torch_mode,
}


def apply_imagenet_mode(image: torch.Tensor, mode: str) -> torch.Tensor:
    """[0, 1] float RGB -> the "tf", "caffe" or "torch" ImageNet scaling."""
    if mode not in _IMAGENET_MODES:
        raise ValueError(f"Unknown imagenet mode: {mode!r}")
    return _IMAGENET_MODES[mode](image)
