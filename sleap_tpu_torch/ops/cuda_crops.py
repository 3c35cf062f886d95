"""Crop kernel for Hopper: wrapper, plain version, launch count.

The CUDA kernel ``crop_unit`` (``csrc/crops.cu``) replaces the Pallas kernel
``crop_bboxes_unit_pallas`` / ``_crop_kernel`` of
:mod:`sleap_tpu.ops.pallas_crops`: for each box, a (crop_h, crop_w) bilinear
crop with unit sample spacing from a fractional top-left (x1, y1) in frame
``box_indices[i]``, zero outside the image, as float32.

Bound by the float32 it writes: on the top-down main path (64 crops of
160 x 160 from 16 uint8 frames of 1024^2) that is 6.55 MB, 2 us at
3.35 TB/s, and it gathers about a quarter of that in uint8 taps, at 7 FLOPs
per output. Design (``csrc/crops.cu``): one block per box, band of up to 16
output rows and segment of up to 512 flat (column, channel) elements of a
row (640 blocks on the path); the block reads its box once, stages the
band's source window into shared memory as float32 with zeros outside the
image (4 elements per load from contiguous channels-last rows, strided
element loads otherwise), and blends flat channels-last rows, 4 outputs per
thread and one 16-byte store, with 32-bit index math only. The TPU kernel's
gate (C == 1, crop_h % 8, crop_w % 128) was a Mosaic tiling limit: this
kernel takes uint8 or float32 frames with up to :data:`MAX_CHANNELS`
channels, any crop size and any strides.

The blend uses round-to-nearest intrinsics in the plain version's order (no
FMA), so kernel and plain version agree bitwise (tolerance 0); see the note
in ``csrc/crops.cu``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sleap_tpu_torch.ops._build import launch

_DTYPES = {torch.uint8: 0, torch.float32: 1}
MAX_CHANNELS = 4096  # the source window of a band must fit in 48 KB of shared memory
_INT32_MAX = 2**31 - 1


def crop_unit_plain(
    images: torch.Tensor,
    top_left: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Kernel ``crop_unit``'s contract in plain PyTorch.

    Args:
        images: (B, H, W, C).
        top_left: (n, 2) float (x1, y1) of each crop's first sample.
        box_indices: (n,) int frame index per box.
        crop_size: (crop_h, crop_w).

    Returns:
        (n, crop_h, crop_w, C) float32.
    """
    ch, cw = crop_size
    B, H, W, C = images.shape
    x1, y1 = top_left[:, 0].float(), top_left[:, 1].float()
    x0, y0 = torch.floor(x1), torch.floor(y1)
    fx = (x1 - x0)[:, None, None, None]
    fy = (y1 - y0)[:, None, None, None]
    ys = y0.long()[:, None] + torch.arange(ch + 1, device=images.device)
    xs = x0.long()[:, None] + torch.arange(cw + 1, device=images.device)
    valid = ((ys >= 0) & (ys < H))[:, :, None] & ((xs >= 0) & (xs < W))[:, None, :]
    bi = box_indices.long()[:, None, None]
    patches = images[bi, ys.clamp(0, H - 1)[:, :, None], xs.clamp(0, W - 1)[:, None, :]]
    patches = torch.where(valid[..., None], patches.float(), 0.0)  # (n, ch+1, cw+1, C)
    top = patches[:, :-1, :-1] * (1 - fx) + patches[:, :-1, 1:] * fx
    bot = patches[:, 1:, :-1] * (1 - fx) + patches[:, 1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def crop_unit_cuda(
    images: torch.Tensor,
    top_left: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Launch kernel ``crop_unit``; same contract as :func:`crop_unit_plain`.

    A box index outside ``[0, B)`` reads zeros instead of faulting.
    """
    dtype = _DTYPES.get(images.dtype)
    if not images.is_cuda:
        raise ValueError(f"The CUDA crop kernel takes CUDA tensors, got {images.device}.")
    if dtype is None or images.ndim != 4:
        raise ValueError(
            f"Expected (B, H, W, C) uint8 or float32 images, got {images.dtype} {tuple(images.shape)}."
        )
    ch, cw = int(crop_size[0]), int(crop_size[1])
    n = top_left.shape[0]
    if top_left.shape != (n, 2) or box_indices.shape != (n,):
        raise ValueError("Expected top_left (n, 2) and box_indices (n,).")
    B, H, W, C = images.shape
    sB, sH, sW, sC = images.stride()
    if C > MAX_CHANNELS:
        raise ValueError(f"The CUDA crop kernel takes at most {MAX_CHANNELS} channels, got {C}.")
    # The kernel's index math is 32-bit within a frame and within the output.
    if (n * ch * cw * C > _INT32_MAX or (H - 1) * sH + (W - 1) * sW + (C - 1) * sC > _INT32_MAX
            or (W + cw + 2) * C > _INT32_MAX):
        raise ValueError("The CUDA crop kernel takes frames and crop batches of < 2**31 elements.")
    out = images.new_empty((n, ch, cw, C), dtype=torch.float32)
    if n * ch * cw * C == 0:
        return out
    index = images.get_device()
    # Converted only where needed: on the path both are already so.
    if (top_left.dtype != torch.float32 or top_left.get_device() != index
            or not top_left.is_contiguous()):
        top_left = top_left.to(device=images.device, dtype=torch.float32).contiguous()
    if (box_indices.dtype != torch.int64 or box_indices.get_device() != index
            or not box_indices.is_contiguous()):
        box_indices = box_indices.to(device=images.device, dtype=torch.int64).contiguous()
    launch(
        "sleap_crop_unit", index, images.data_ptr(), dtype, sB, sH, sW, sC, B, H, W, C,
        top_left.data_ptr(), box_indices.data_ptr(), n, ch, cw, out.data_ptr(),
    )
    crop_unit_cuda.launches += 1
    return out


crop_unit_cuda.launches = 0


def crop_unit(images, top_left, box_indices, crop_size) -> torch.Tensor:
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if images.device.type == "cpu":
        return crop_unit_plain(images, top_left, box_indices, crop_size)
    return crop_unit_cuda(images, top_left, box_indices, crop_size)
