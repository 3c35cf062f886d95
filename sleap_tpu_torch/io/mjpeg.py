"""Decode Motion-JPEG frames as OpenCV's FFmpeg backend decodes them: the
frames of :class:`sleap_tpu_torch.io.video.MediaVideo`'s card route for
Motion-JPEG in AVI, QuickTime/ISO-BMFF and Matroska files
(:class:`MotionJpegReader` over any of their demuxers).

The JAX package reads a video with ``cv2.VideoCapture(filename)``, which
picks OpenCV's FFmpeg backend. FFmpeg's Motion-JPEG decoder (``mjpegdec``)
does not give libjpeg-turbo's pixels, which :mod:`~sleap_tpu_torch.io.jpeg`
reproduces for stills: it has its own inverse DCT and leaves the chroma
planes at their sampling, for swscale to convert (:mod:`~sleap_tpu_torch.io.yuv`).
A frame goes through four stages:

1. :func:`sleap_tpu_torch.io.jpeg.parse` and Huffman decoding into
   coefficients: the host C decoder on the card's route, the plain Python
   one on the CPU (a frame without DHT takes the Annex K.3 tables, as
   ``mjpegdec`` does too);
2. dequantisation and FFmpeg's IDCT (:func:`idct_plain`; on the card the
   kernel J5, ``jpeg_idct_ffmpeg_kernel`` in ``csrc/jpeg.cu``), into planes
   at ``mjpegdec``'s pixel format: gray, or Y, Cb, Cr sampled 4:2:0, 4:2:2
   or 4:4:4;
3. the range: ``mjpegdec`` reads the frame as limited range (``yuv420p``)
   when a ``COM`` segment before the frame header says ``CS=ITU601``, else
   as full range (``yuvj420p``); JFIF and AVI1 APP0 segments leave it full;
4. swscale's conversion to BGR (:func:`sleap_tpu_torch.io.yuv.to_bgr`).

The IDCT was fitted to recorded decodes of OpenCV 5.0.0 (FFmpeg's avcodec
62.28.101, x86-64), not taken from FFmpeg's source: frames whose blocks each
hold one coefficient, at each of the 64 positions, 12 amplitudes and 9
quantiser values, and frames of random sparse blocks
(``scripts/make_torch_avi_fixtures.py``'s probe clip). It is libavcodec's
"simple" IDCT (``simple_idct_template.c``'s constants and shifts) with the
rounding of its SIMD form: rows first, saturated to 16 bits; a row of DC
alone is the DC times 8; columns with their rounding added in 16 bits. The
plain version and J5 do the same integer arithmetic, so they agree bit for
bit.

What ``mjpegdec`` reads and this module does not (12-bit samples, lossless
and arithmetic-coded frames, interlaced frames of two fields, the comments
that flip or re-field a frame), and 4:2:0 or 4:2:2 frames of odd height,
which swscale converts through its scaler rather than its unscaled
converter, raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from sleap_tpu_torch.io import jpeg, yuv

ROADMAP_ITEM = "ROADMAP.md item 3g"
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
#: ``mjpegdec``'s comments that change the frame's geometry (flip it or
#: mark Avid's fields), which this module does not follow.
_FLAGGED_COMMENTS = (b"AVID", b"Intel(R) JPEG Library, version 1", b"Metasoft MJPEG Codec",
                     b"MULTISCOPE II")


def unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not decoded on the card (device='cuda'); read the video "
                               f"with device='cpu' (cv2), or see {ROADMAP_ITEM}.")


@dataclass
class Frame:
    """A parsed Motion-JPEG frame: its markers and its range."""

    header: jpeg.Header
    full_range: bool

    @property
    def sampling(self) -> str:
        """"gray", "420", "422" or "444", else ""."""
        comps = self.header.components
        if len(comps) == 1:
            return "gray"
        if (comps[0].h, comps[0].v) != (self.header.hmax, self.header.vmax):
            return ""
        return {(2, 2): "420", (2, 1): "422", (1, 1): "444"}.get(
            (self.header.hmax // comps[1].h, self.header.vmax // comps[1].v), "")


def _comments(data: bytes) -> List[bytes]:
    """The text of each COM segment before the frame header, as ``mjpegdec``
    reads it: up to the first NUL, a last newline dropped."""
    out, pos = [], 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) or marker == 0xDA:
            break
        (length,) = struct.unpack_from(">H", data, pos + 2)
        if marker == 0xFE:
            text = data[pos + 4:pos + 2 + length].split(b"\0")[0]
            out.append(text[:-1] if text.endswith(b"\n") else text)
        pos += 2 + length
    return out


def parse_frame(data: bytes, container_height: Optional[int] = None) -> Frame:
    """Markers, sampling and range of one frame; raise ``NotImplementedError``
    for what the card's route does not decode. ``container_height`` is the
    AVI's (``strf``): a frame under three quarters of it is one field of an
    interlaced pair, as ``mjpegdec`` decides."""
    try:
        header = jpeg.parse(data)
    except jpeg.UnsupportedJpeg as e:
        raise unsupported(f"This Motion-JPEG frame ({e})") from e
    comments = _comments(data)
    for text in comments:
        if any(text.startswith(flag) for flag in _FLAGGED_COMMENTS):
            raise unsupported(f"A Motion-JPEG frame with the comment {text[:40]!r}")
    if container_height and header.height < container_height * 3 // 4:
        raise unsupported(f"Interlaced Motion-JPEG (a {header.height}-row field of a "
                          f"{container_height}-row frame)")
    frame = Frame(header, full_range=b"CS=ITU601" not in comments)
    if header.color not in ("gray", "ycc") or not frame.sampling:
        samplings = "x".join(f"{c.h}{c.v}" for c in header.components)
        raise unsupported(f"A Motion-JPEG frame in colour space {header.color}, sampled {samplings}")
    if frame.sampling in ("420", "422") and header.height % 2:
        raise unsupported(f"Motion-JPEG of odd height ({header.height}) sampled "
                          f"{frame.sampling[0]}:{frame.sampling[1]}:{frame.sampling[2]} (swscale "
                          "converts it through its scaler, which the port does not model)")
    return frame


def _i16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _i32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _simple_1d(a0: torch.Tensor, x) -> List[torch.Tensor]:
    """One 1-D pass of the simple IDCT: outputs 0-7 before their shift;
    ``a0`` holds W4 times the DC term plus the rounding."""
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x[2] + W4 * x[4] + W6 * x[6]
    a1 = a1 + W6 * x[2] - W4 * x[4] - W2 * x[6]
    a2 = a2 - W6 * x[2] - W4 * x[4] + W2 * x[6]
    a3 = a3 - W2 * x[2] + W4 * x[4] - W6 * x[6]
    b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
    b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
    b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
    b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
    return [_i32(v) for v in (a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0)]


def simple_idct(z: torch.Tensor) -> torch.Tensor:
    """FFmpeg's simple IDCT as fitted above, of (blocks, 64) int64 terms in
    int16 range, raster order: (blocks, 8, 8) int64 samples before
    saturation (J5's and MPEG-4's M1 and M2's arithmetic)."""
    rows = z.view(-1, 8, 8)
    x = [rows[:, :, k] for k in range(8)]  # pass 1: each row, (blocks, 8) a term
    out = torch.stack([(v >> 11).clamp(-32768, 32767) for v in _simple_1d(W4 * x[0] + 1024, x)], 2)
    dc_only = (rows[:, :, 1:] == 0).all(2)
    out = torch.where(dc_only[..., None], _i16(x[0] << 3)[..., None], out)
    x = [out[:, k, :] for k in range(8)]  # pass 2: each column
    return torch.stack([v >> 20 for v in _simple_1d(W4 * _i16(x[0] + 32), x)], 1)


def idct_plain(coefs: torch.Tensor, quant: torch.Tensor, block_comp: torch.Tensor) -> torch.Tensor:
    """Stage 2, J5's plain version: (blocks, 64) int16 coefficients, (components,
    64) quant tables and each block's component -> (blocks, 8, 8) uint8."""
    z = coefs.long() * quant.long()[block_comp]
    dc = (z[:, 0] + 1024).clamp(-32768, 32767)
    z = _i16(z)
    z[:, 0] = dc
    return simple_idct(z).clamp(0, 255).to(torch.uint8)


def idct_cuda(coefs: torch.Tensor, quant: torch.Tensor, header: jpeg.Header) -> torch.Tensor:
    """J5 (``jpeg_idct_ffmpeg_kernel``): :func:`idct_plain` on the card, (blocks,
    64) int16 coefficients and (components, 64) int32 quant tables ->
    (blocks, 8, 8) uint8 samples."""
    from sleap_tpu_torch.ops import _build

    jpeg._check_card(coefs, torch.int16, "coefficients")
    jpeg._check_card(quant, torch.int32, "quantisation tables")
    comps = header.components
    if coefs.shape != (header.blocks, 64) or quant.shape != (len(comps), 64):
        raise ValueError(f"coefficients {tuple(coefs.shape)} and tables {tuple(quant.shape)} do not "
                         f"fit a frame of {header.blocks} blocks and {len(comps)} components.")
    out = torch.empty((header.blocks, 8, 8), dtype=torch.uint8, device=coefs.device)
    ends = [c.offset + c.blocks_w * c.blocks_h for c in comps] + [header.blocks] * (3 - len(comps))
    _build.launch("sleap_jpeg_idct_ffmpeg", coefs.device.index, coefs.data_ptr(), header.blocks,
                  quant.data_ptr(), ends[0], ends[1], out.data_ptr())
    idct_cuda.launches += 1
    return out


idct_cuda.launches = 0


def samples(data: bytes, frame: Frame, device) -> torch.Tensor:
    """Stages 1 and 2: the frame's (blocks, 8, 8) uint8 samples on
    ``device``, by its route."""
    header = frame.header
    quant = torch.from_numpy(header.quant.astype(np.int32))
    if torch.device(device).type == "cuda":
        coefs = jpeg.coefficients_host(data, header, jpeg._staging(header.blocks)).to(device)
        return idct_cuda(coefs, quant.to(device), header)
    coefs = torch.from_numpy(jpeg.coefficients_plain(data, header))
    return idct_plain(coefs, quant, jpeg.block_components(header))


def planes(data: bytes, frame: Frame, device) -> List[torch.Tensor]:
    """Each component's plane, cropped to its sampled size, on ``device``."""
    out = jpeg.planes_of(samples(data, frame, device), frame.header)
    return [p[:c.height, :c.width] for p, c in zip(out, frame.header.components)]


def decode(data: bytes, device="cuda", channels: str = "bgr",
           container_height: Optional[int] = None) -> torch.Tensor:
    """One frame as OpenCV's FFmpeg backend gives it, (H, W, C) uint8 on
    ``device``: ``channels`` "bgr", "rgb" or "b" (the blue channel alone,
    what a gray ``MediaVideo`` keeps)."""
    data = bytes(data)
    frame = parse_frame(data, container_height)
    ps = planes(data, frame, device)
    if frame.sampling == "gray":  # swscale copies gray to each channel
        y = ps[0][..., None]
        return y if channels == "b" else y.expand(*y.shape[:2], 3).contiguous()
    return yuv.to_bgr(*ps, sampling=frame.sampling, full_range=frame.full_range,
                      channels=channels)


class MotionJpegReader:
    """Frames of a demuxer whose packets are Motion-JPEG frames, as OpenCV's
    FFmpeg backend gives them, on ``device``: an AVI
    (:class:`~sleap_tpu_torch.io.avi.AviVideo`), ISO-BMFF
    (:class:`~sleap_tpu_torch.io.mp4.Mp4Video`) or Matroska
    (:class:`~sleap_tpu_torch.io.mkv.MkvVideo`) track, whose ``read(f, i)``
    gives presentation frame ``i``'s bytes. ``height`` is the container's
    (``strf``, the sample entry, ``PixelHeight``): ``mjpegdec`` takes a frame
    under three quarters of it for one field of an interlaced pair. Every
    frame is a key frame, so a read never decodes another frame."""

    def __init__(self, demux, height: int, device="cuda"):
        self.demux, self.height, self.device = demux, int(height), torch.device(device)
        self._f = open(demux.filename, "rb")

    def frame(self, i: int, channels: str = "bgr") -> torch.Tensor:
        """Frame ``i``, (H, W, C) uint8 on the device: ``channels`` "bgr",
        "rgb" or "b" (the blue channel alone)."""
        return decode(self.demux.read(self._f, i), self.device, channels, self.height)

    def close(self) -> None:
        self._f.close()
