"""Decoded video planes (NVDEC's NV12, Motion-JPEG's Y, Cb, Cr) to the frames
OpenCV's FFmpeg backend gives.

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

The same converter with swscale's full-range coefficients (the chroma ones
times 224 / 255, Y unscaled) gives FFmpeg's ``yuvj420p`` and ``yuvj422p``
Motion-JPEG frames bit for bit, and its scaler's full-chroma output stage
the 4:4:4 ones (:func:`to_bgr`).

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


#: swscale's coefficients for full-range (JPEG) input: Y unscaled, the
#: chroma ones times 224 / 255 (``sws_setColorspaceDetails``).
FULL_COEFFS = (8192, 14516, -2819, -5850, 11485)
LIMITED_COEFFS = (Y_COEFF, UB_COEFF, UG_COEFF, VG_COEFF, VR_COEFF)


def _full_chroma(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, full_range: bool,
                 channels: str) -> torch.Tensor:
    """4:4:4 planes through swscale's scaler at full chroma resolution
    (``yuv2rgb_write_full``): samples in units of 2^-9, coefficients of
    2^-13, the sums rounded at bit 22 in wrapping 32-bit arithmetic and
    clipped to 30 bits before the shift."""
    y_c, ub, ug, vg, vr = FULL_COEFFS if full_range else LIMITED_COEFFS
    ys = (y.long() * 512 - (0 if full_range else 16 * 512)) * y_c + (1 << 21)
    u9, v9 = (u.long() - 128) * 512, (v.long() - 128) * 512

    def out(acc):
        acc = ((acc + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        return (acc.clamp(0, (1 << 30) - 1) >> 22).to(torch.uint8)

    b = out(ys + u9 * ub)
    if channels == "b":
        return b[..., None]
    g = out(ys + v9 * vg + u9 * ug)
    r = out(ys + v9 * vr)
    return torch.stack({"bgr": (b, g, r), "rgb": (r, g, b)}[channels], dim=-1)


def to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, sampling: str = "420",
           full_range: bool = False, channels: str = "bgr") -> torch.Tensor:
    """uint8 planes Y (..., H, W) and U, V at ``sampling`` ("420": (ceil(H/2),
    ceil(W/2)); "422": (H, ceil(W/2)); "444": (H, W)), limited or full range
    -> (..., H, W, C) uint8: ``channels`` "bgr" (OpenCV's order), "rgb", or
    "b" (the blue channel alone, what a gray ``MediaVideo`` keeps).

    4:2:0 and 4:2:2 of even height take swscale's unscaled x86 converter:
    each chroma sample over the luma samples it covers. 4:4:4 takes its
    scaler at full chroma resolution (:func:`_full_chroma`). At an odd
    height swscale converts 4:2:0 and 4:2:2 through its scaler instead,
    which this function does not model (callers refuse such frames)."""
    if sampling == "444":
        return _full_chroma(y, u, v, full_range, channels)
    h, w = y.shape[-2:]
    y_c, ub, ug, vg, vr = FULL_COEFFS if full_range else LIMITED_COEFFS
    ys = _mulhi(8 * (y.to(torch.int32) - (0 if full_range else 16)), y_c)
    u8 = 8 * (u.to(torch.int32) - 128)
    rows = 2 if sampling == "420" else 1

    def full(c):  # each chroma sample over its 2 x 2 (4:2:0) or 2 x 1 luma samples
        return c.repeat_interleave(rows, -2)[..., :h, :].repeat_interleave(2, -1)[..., :w]

    b = (ys + full(_mulhi(u8, ub))).clamp_(0, 255)
    if channels == "b":
        return b.to(torch.uint8)[..., None]
    v8 = 8 * (v.to(torch.int32) - 128)
    g = (ys + full(_mulhi(u8, ug) + _mulhi(v8, vg))).clamp_(0, 255)
    r = (ys + full(_mulhi(v8, vr))).clamp_(0, 255)
    order = {"bgr": (b, g, r), "rgb": (r, g, b)}[channels]
    return torch.stack(order, dim=-1).to(torch.uint8)


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  channels: str = "bgr") -> torch.Tensor:
    """Limited-range 4:2:0 planes Y (..., H, W), U and V (..., ceil(H/2),
    ceil(W/2)) -> (..., H, W, C) uint8 (see :func:`to_bgr`)."""
    return to_bgr(y, u, v, "420", False, channels)


def nv12_to_frame(nv12: torch.Tensor, height: int, channels: str = "bgr") -> torch.Tensor:
    """An NV12 frame (see :func:`split_nv12`) -> (H, W, C) uint8."""
    return yuv420_to_bgr(*split_nv12(nv12, height), channels=channels)
