"""Decoded 4:2:0 video (NV12) to the frames OpenCV's FFmpeg backend gives.

OpenCV converts decoded ``yuv420p`` frames to BGR with FFmpeg's swscale:
BT.601 limited range, each chroma sample used for its 2 x 2 luma samples
(nearest), in the 16-bit fixed point of swscale's x86 SIMD converter.
Samples are scaled by 8, multiplied with ``pmulhw`` (the high 16 bits of the
product, rounded down) by coefficients that are swscale's float ones in
units of 2^-13, summed, and saturated to 0-255:

    y' = (8 (Y - 16) * 9539) >> 16
    B = y' + ((8 (U - 128) * 16525) >> 16)
    G = y' + ((8 (U - 128) * -3209) >> 16) + ((8 (V - 128) * -6660) >> 16)
    R = y' + ((8 (V - 128) * 13075) >> 16)

This equals OpenCV 5.0.0's frames (x86-64) bit for bit on every (Y, U) and
(Y, V) pair and on random planes of even sizes from 18 x 16 to 256^2
(``tests/test_torch_media.py``); another build of swscale (other SIMD, or
``SWS_ACCURATE_RND``) may round otherwise. On gray video (U = V = 128) the blue
channel, which a gray ``MediaVideo`` keeps, is ``floor((Y - 16) * 255 / 219)``
clipped to 0-255.

The functions are torch integer arithmetic on whichever device their input
lies on (the card for NVDEC's output, the CPU in the tests), so the two
agree bit for bit. This is the port's own conversion, not a TPU kernel.
"""

from __future__ import annotations

import torch

Y_COEFF, UB_COEFF, UG_COEFF, VG_COEFF, VR_COEFF = 9539, 16525, -3209, -6660, 13075


def split_nv12(nv12: torch.Tensor, height: int):
    """A (H + ceil(H/2), W) NV12 frame -> Y (H, W), U and V (ceil(H/2), W/2)."""
    y = nv12[:height]
    uv = nv12[height:]
    return y, uv[:, 0::2], uv[:, 1::2]


def _mulhi(a: torch.Tensor, coeff: int) -> torch.Tensor:
    return torch.bitwise_right_shift(a * coeff, 16)


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  channels: str = "bgr") -> torch.Tensor:
    """uint8 planes Y (..., H, W), U and V (..., ceil(H/2), ceil(W/2)) ->
    (..., H, W, C) uint8: ``channels`` "bgr" (OpenCV's order), "rgb", or "b"
    (the blue channel alone, what a gray ``MediaVideo`` keeps)."""
    h, w = y.shape[-2:]
    ys = _mulhi(8 * (y.to(torch.int32) - 16), Y_COEFF)
    u8 = 8 * (u.to(torch.int32) - 128)

    def full(c):  # each chroma sample over its 2 x 2 luma samples
        return c.repeat_interleave(2, -2)[..., :h, :].repeat_interleave(2, -1)[..., :w]

    b = (ys + full(_mulhi(u8, UB_COEFF))).clamp_(0, 255)
    if channels == "b":
        return b.to(torch.uint8)[..., None]
    v8 = 8 * (v.to(torch.int32) - 128)
    g = (ys + full(_mulhi(u8, UG_COEFF) + _mulhi(v8, VG_COEFF))).clamp_(0, 255)
    r = (ys + full(_mulhi(v8, VR_COEFF))).clamp_(0, 255)
    order = {"bgr": (b, g, r), "rgb": (r, g, b)}[channels]
    return torch.stack(order, dim=-1).to(torch.uint8)


def nv12_to_frame(nv12: torch.Tensor, height: int, channels: str = "bgr") -> torch.Tensor:
    """An NV12 frame (see :func:`split_nv12`) -> (H, W, C) uint8."""
    return yuv420_to_bgr(*split_nv12(nv12, height), channels=channels)
