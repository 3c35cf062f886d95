"""Crop kernel for Hopper: wrapper, plain version, launch count.

The CUDA kernel ``crop_unit`` (``csrc/crops.cu``) replaces the Pallas kernel
``crop_bboxes_unit_pallas`` / ``_crop_kernel`` of
:mod:`sleap_tpu.ops.pallas_crops`: for each box, a (crop_h, crop_w) bilinear
crop with unit sample spacing from a fractional top-left (x1, y1) in frame
``box_indices[i]``, zero outside the image, as float32.

Bound by bytes: on the top-down main path (64 crops of 160 x 160 from 16
uint8 frames of 1024^2) it writes 6.6 MB of float32 and gathers about a
quarter of that in uint8 taps, at 7 FLOPs per output. Design: one thread
per output element (box, row, col, channel), so consecutive threads write
consecutive addresses and read neighbouring pixels of one row; the frame is
read in place through its strides. The TPU kernel's gate (C == 1,
crop_h % 8, crop_w % 128) was a Mosaic tiling limit: this kernel takes any
channel count and crop size, uint8 or float32 frames.

The blend uses round-to-nearest intrinsics in the plain version's order (no
FMA), so kernel and plain version agree bitwise (tolerance 0); see the note
in ``csrc/crops.cu``.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DTYPES = {torch.uint8: 0, torch.float32: 1}


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
    from sleap_tpu_torch.ops._build import load_library

    if images.device.type != "cuda":
        raise ValueError(f"The CUDA crop kernel takes CUDA tensors, got {images.device}.")
    if images.dtype not in _DTYPES or images.ndim != 4:
        raise ValueError(
            f"Expected (B, H, W, C) uint8 or float32 images, got {images.dtype} {tuple(images.shape)}."
        )
    ch, cw = int(crop_size[0]), int(crop_size[1])
    n = top_left.shape[0]
    if top_left.shape != (n, 2) or box_indices.shape != (n,):
        raise ValueError("Expected top_left (n, 2) and box_indices (n,).")
    B, H, W, C = images.shape
    out = torch.empty((n, ch, cw, C), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    tl = top_left.to(device=images.device, dtype=torch.float32).contiguous()
    bi = box_indices.to(device=images.device, dtype=torch.int64).contiguous()
    fn = load_library().sleap_crop_unit
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            images.data_ptr(), _DTYPES[images.dtype], *images.stride(), B, H, W, C,
            tl.data_ptr(), bi.data_ptr(), n, ch, cw, out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"sleap_crop_unit launch failed with CUDA error {err}.")
    crop_unit_cuda.launches += 1
    return out


crop_unit_cuda.launches = 0


def crop_unit(images, top_left, box_indices, crop_size) -> torch.Tensor:
    """CPU tensor -> plain version; otherwise the CUDA kernel (or raise)."""
    if images.device.type == "cpu":
        return crop_unit_plain(images, top_left, box_indices, crop_size)
    return crop_unit_cuda(images, top_left, box_indices, crop_size)
