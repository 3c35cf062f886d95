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

The kernel is the custom op ``torch.ops.sleap_tpu_torch.crop_unit``: the
plain version on a CPU tensor, the kernel on a CUDA tensor, a refusal for
anything else, in eager code and in ``torch.export`` programs alike.

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


def _check_crops(images: torch.Tensor, top_left: torch.Tensor, box_indices: torch.Tensor,
                 ch: int, cw: int) -> None:
    """The wrapper's refusals of inputs the kernel cannot take."""
    if images.dtype not in _DTYPES or images.ndim != 4:
        raise ValueError(
            f"Expected (B, H, W, C) uint8 or float32 images, got {images.dtype} {tuple(images.shape)}."
        )
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


def crop_unit_cuda(
    images: torch.Tensor,
    top_left: torch.Tensor,
    box_indices: torch.Tensor,
    crop_size: Tuple[int, int],
) -> torch.Tensor:
    """Launch kernel ``crop_unit``; same contract as :func:`crop_unit_plain`.

    A box index outside ``[0, B)`` reads zeros instead of faulting.
    """
    if not images.is_cuda:
        raise ValueError(f"The CUDA crop kernel takes CUDA tensors, got {images.device}.")
    ch, cw = int(crop_size[0]), int(crop_size[1])
    _check_crops(images, top_left, box_indices, ch, cw)
    dtype = _DTYPES[images.dtype]
    n = top_left.shape[0]
    B, H, W, C = images.shape
    sB, sH, sW, sC = images.stride()
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


# The kernel as the op ``torch.ops.sleap_tpu_torch.crop_unit``: the plain
# version on the CPU, the wrapper above on the card (counting the launches),
# no kernel for other devices; the fake kernel gives the output's shape and,
# for images on the card, raises the wrapper's errors while ``torch.export``
# traces (see ``cuda_peaks.py``).


@torch.library.custom_op("sleap_tpu_torch::crop_unit", mutates_args=(), device_types="cpu")
def _crop_unit_op(images: torch.Tensor, top_left: torch.Tensor, box_indices: torch.Tensor,
                  crop_h: int, crop_w: int) -> torch.Tensor:
    return crop_unit_plain(images, top_left, box_indices, (crop_h, crop_w)).contiguous()


@_crop_unit_op.register_kernel("cuda")
def _(images, top_left, box_indices, crop_h, crop_w):
    return crop_unit_cuda(images, top_left, box_indices, (crop_h, crop_w))


@_crop_unit_op.register_fake
def _(images, top_left, box_indices, crop_h, crop_w):
    if images.device.type not in ("cpu", "cuda"):  # a meta tensor: no kernel takes it
        raise ValueError(f"The CUDA crop kernel takes CUDA tensors, got {images.device}.")
    if images.device.type == "cuda":
        _check_crops(images, top_left, box_indices, crop_h, crop_w)
    return images.new_empty((top_left.shape[0], crop_h, crop_w, images.shape[3]),
                            dtype=torch.float32)


def crop_unit(images, top_left, box_indices, crop_size) -> torch.Tensor:
    """CPU tensor -> plain version; CUDA tensor -> the kernel; else raise."""
    return torch.ops.sleap_tpu_torch.crop_unit(
        images, top_left, box_indices, int(crop_size[0]), int(crop_size[1]))
