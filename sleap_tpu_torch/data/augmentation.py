"""Data augmentation on the device (port of :mod:`sleap_tpu.data.augmentation`).

Each transform is split into a draw and an apply, so that values drawn
elsewhere (by the JAX package, in the parity tests) can be applied here:

- :func:`draw_augmentation` draws every random value of a batch from an
  explicit ``torch.Generator`` on the batch's device, one per sample (the
  JAX package draws the same quantities per sample from split keys);
- :func:`apply_augmentation` applies them, in the JAX package's order:
  rotation, scale and translation composed into one affine resample
  (bilinear, taps outside the image read 0, points mapped by the forward
  matrix), symmetric-node-aware flip, random crop, uniform and Gaussian
  noise, gamma contrast and brightness.

Images are (B, H, W, C) float32 in [0, 1] and instances (B, I, N, 2) xy,
NaN-padded.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def _affine_matrix(
    angle_rad: torch.Tensor,
    scale: torch.Tensor,
    translate: torch.Tensor,
    center: Tuple[float, float],
) -> torch.Tensor:
    """Forward (B, 3, 3) affines mapping input xy to output xy: rotate by
    ``angle_rad`` and scale about ``center``, then translate."""
    cx, cy = center
    angle_rad = torch.as_tensor(angle_rad, dtype=torch.float32)
    shape = angle_rad.shape
    cos, sin = torch.cos(angle_rad), torch.sin(angle_rad)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=angle_rad.device).expand(shape)
    translate = torch.as_tensor(translate, dtype=torch.float32, device=angle_rad.device)
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    rot = torch.stack([
        torch.stack([cos * scale, -sin * scale, zero], -1),
        torch.stack([sin * scale, cos * scale, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    to_origin = torch.tensor([[1.0, 0, -cx], [0, 1.0, -cy], [0, 0, 1.0]], device=rot.device)
    back = torch.stack([
        torch.stack([one, zero, cx + translate[..., 0]], -1),
        torch.stack([zero, one, cy + translate[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return back @ rot @ to_origin


def _sample_bilinear(images: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images at (B, h, w) fractional coordinates: the four taps
    of ``map_coordinates(order=1, mode="constant")``, each 0 outside the
    image."""
    B, H, W, _ = images.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    b = torch.arange(B, device=images.device)[:, None, None]
    out = 0.0
    for yi, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for xi, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            taps = images[b, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
            out = out + (wy * wx)[..., None] * torch.where(valid[..., None], taps, 0.0)
    return out


def apply_affine(
    images: torch.Tensor, points: torch.Tensor, matrix: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp (B, H, W, C) images and (B, ..., 2) xy points by forward
    (B, 3, 3) affines: each output pixel samples the input at the inverse
    map of its xy."""
    B, H, W, _ = images.shape
    inv = torch.linalg.inv(matrix)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=images.device),
        torch.arange(W, dtype=torch.float32, device=images.device),
        indexing="ij",
    )
    out_coords = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, -1)
    in_coords = inv @ out_coords
    warped = _sample_bilinear(
        images.float(), in_coords[:, 1].reshape(B, H, W), in_coords[:, 0].reshape(B, H, W)
    )
    pts = points.reshape(B, -1, 2)
    pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    new_pts = (matrix @ pts_h.transpose(1, 2)).transpose(1, 2)[..., :2]
    return warped, new_pts.reshape(points.shape)


def flip_instances_lr(
    instances: torch.Tensor, img_width: int, flip_idx: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Horizontal flip of (..., n_nodes, 2) points, swapping symmetric
    nodes by ``flip_idx``."""
    flipped = torch.stack([img_width - 1 - instances[..., 0], instances[..., 1]], dim=-1)
    return flipped if flip_idx is None else flipped[..., list(flip_idx), :]


def flip_instances_ud(
    instances: torch.Tensor, img_height: int, flip_idx: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Vertical flip of (..., n_nodes, 2) points, as :func:`flip_instances_lr`."""
    flipped = torch.stack([instances[..., 0], img_height - 1 - instances[..., 1]], dim=-1)
    return flipped if flip_idx is None else flipped[..., list(flip_idx), :]


def _needs_affine(config) -> bool:
    return bool(config.rotate or config.scale or config.translate)


def _crop_hw(config, H: int, W: int) -> Optional[Tuple[int, int]]:
    ch, cw = int(config.random_crop_height), int(config.random_crop_width)
    if config.random_crop and (ch < H or cw < W):
        return min(ch, H), min(cw, W)
    return None


def draw_augmentation(
    config, batch_size: int, image_shape: Tuple[int, int, int], generator: torch.Generator
) -> Dict[str, torch.Tensor]:
    """Every random value ``config`` asks for, per sample, on the
    generator's device: ``angle`` (radians), ``scale``, ``translate`` (B, 2),
    ``flip`` (bool), ``crop_offset`` (B, 2) as (y, x), ``uniform_noise`` and
    ``gaussian_noise`` (standard normal) of the cropped image's shape,
    ``gamma`` and ``brightness`` (in [0, 1] units)."""
    H, W, C = image_shape
    dev = generator.device

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(batch_size, *shape, generator=generator, device=dev)

    draws: Dict[str, torch.Tensor] = {}
    if _needs_affine(config):
        lo, hi = math.radians(config.rotation_min_angle), math.radians(config.rotation_max_angle)
        draws["angle"] = uniform(lo, hi) if config.rotate else torch.zeros(batch_size, device=dev)
        draws["scale"] = (uniform(config.scale_min, config.scale_max) if config.scale
                          else torch.ones(batch_size, device=dev))
        draws["translate"] = (uniform(config.translate_min, config.translate_max, 2)
                              if config.translate else torch.zeros(batch_size, 2, device=dev))
    if config.random_flip:
        draws["flip"] = torch.rand(batch_size, generator=generator, device=dev) < 0.5
    crop = _crop_hw(config, H, W)
    if crop is not None:
        limits = torch.tensor([max(H - int(config.random_crop_height), 1),
                               max(W - int(config.random_crop_width), 1)], device=dev)
        draws["crop_offset"] = (torch.rand(batch_size, 2, generator=generator, device=dev)
                                * limits).long().clamp_max(limits - 1)
        H, W = crop
    if config.uniform_noise:
        draws["uniform_noise"] = uniform(config.uniform_noise_min_val / 255.0,
                                         config.uniform_noise_max_val / 255.0, H, W, C)
    if config.gaussian_noise:
        draws["gaussian_noise"] = torch.randn(batch_size, H, W, C, generator=generator, device=dev)
    if config.contrast:
        draws["gamma"] = uniform(config.contrast_min_gamma, config.contrast_max_gamma)
    if config.brightness:
        draws["brightness"] = uniform(config.brightness_min_val / 255.0,
                                      config.brightness_max_val / 255.0)
    return draws


def apply_augmentation(
    images: torch.Tensor,
    instances: torch.Tensor,
    draws: Dict[str, torch.Tensor],
    config,
    flip_idx: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply :func:`draw_augmentation`'s values to (B, H, W, C) float images
    and (B, I, N, 2) instances; returns float32 images and instances."""
    B, H, W, _ = images.shape
    images = images.float()

    def per_sample(v):
        return v.reshape(B, 1, 1, 1)

    if _needs_affine(config):
        matrix = _affine_matrix(draws["angle"], draws["scale"], draws["translate"],
                                (W / 2 - 0.5, H / 2 - 0.5))
        images, instances = apply_affine(images, instances, matrix)
    if config.random_flip:
        if config.flip_horizontal:
            flipped_img, flipped_pts = images.flip(2), flip_instances_lr(instances, W, flip_idx)
        else:
            flipped_img, flipped_pts = images.flip(1), flip_instances_ud(instances, H, flip_idx)
        flip = draws["flip"]
        images = torch.where(per_sample(flip), flipped_img, images)
        instances = torch.where(flip.reshape(B, *([1] * (instances.ndim - 1))),
                                flipped_pts, instances)
    crop = _crop_hw(config, H, W)
    if crop is not None:
        off = draws["crop_offset"]
        rows = off[:, 0:1] + torch.arange(crop[0], device=images.device)
        cols = off[:, 1:2] + torch.arange(crop[1], device=images.device)
        b = torch.arange(B, device=images.device)[:, None, None]
        images = images[b, rows[:, :, None], cols[:, None, :]]
        shift = off.flip(-1).to(instances.dtype)  # (x, y)
        instances = instances - shift.reshape(B, *([1] * (instances.ndim - 2)), 2)
    if config.uniform_noise:
        images = torch.clamp(images + draws["uniform_noise"], 0.0, 1.0)
    if config.gaussian_noise:
        noise = (config.gaussian_noise_mean / 255.0
                 + draws["gaussian_noise"] * config.gaussian_noise_stddev / 255.0)
        images = torch.clamp(images + noise, 0.0, 1.0)
    if config.contrast:
        images = torch.clamp(torch.pow(torch.clamp(images, min=1e-8), per_sample(draws["gamma"])),
                             0.0, 1.0)
    if config.brightness:
        images = torch.clamp(images + per_sample(draws["brightness"]), 0.0, 1.0)
    return images, instances


def augment(
    images: torch.Tensor,
    instances: torch.Tensor,
    config,
    generator: torch.Generator,
    flip_idx: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw and apply the configured augmentations on a batch."""
    draws = draw_augmentation(config, images.shape[0], tuple(images.shape[1:]), generator)
    return apply_augmentation(images, instances, draws, config, flip_idx)
