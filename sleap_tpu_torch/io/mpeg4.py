"""Decode MPEG-4 Part 2 video as OpenCV's FFmpeg backend decodes it, bit for
bit: the frames of :class:`sleap_tpu_torch.io.video.MediaVideo`'s card route
for what ``cv2.VideoWriter`` writes with ``mp4v``, ``FMP4``, ``XVID`` or
``DIVX`` (and Bonsai's ``FMP4``) in AVI, ISO-BMFF (``.mp4``, ``.mov``) and
Matroska files, and for Xvid's and DivX's AVIs (:class:`Mpeg4Reader` over any
of their demuxers).

A stream is a VOL header (in-band before each I-VOP in AVI, or in ``strf``'s
extradata; in ``esds``'s DecoderSpecificInfo in ISO-BMFF; in
``CodecPrivate`` in Matroska), then one VOP a packet (two in DivX's packed
bitstream). A VOP goes through four stages:

1. the headers (VOS, VO, VOL, user data, GOV and VOP: :meth:`Stream.headers`)
   on the host in Python, then the macroblock layer's entropy decoding
   (:func:`decode_macroblocks`): modes, motion vectors (median prediction,
   ``f_code`` wrap; a B-VOP's forward and backward predictors and direct
   mode's scaling of the future reference's co-located vectors) and
   dequantised coefficient blocks with DC and AC prediction applied, as
   FFmpeg's ``mpeg4videodec.c`` and ``h263.c`` do. On the card's route that
   is ``sleap_mpeg4_decode_vop`` in host C (``csrc/mpeg4.cu``); on the CPU
   the plain Python decoder here;
2. intra blocks: the IDCT "put" (:func:`intra_plain`; kernel M1,
   ``mpeg4_intra_kernel``);
3. inter and skipped blocks of a P-VOP: half-pel prediction from the
   previous reference (:func:`inter_plain`; kernel M2,
   ``mpeg4_inter_kernel``): ``(a + b + 1 - r) >> 1`` and ``(a + b + c + d + 2
   - r) >> 2`` with ``vop_rounding_type`` r (the 8-wide blocks rounding as
   FFmpeg's MMXEXT ``no_rnd`` forms do, :data:`NARROW`), every sample
   position clamped to the plane's edge (FFmpeg's ``emulated_edge_mc`` at
   ``h_edge_pos`` and ``v_edge_pos``, which are the macroblock-padded
   sizes), the chroma vector as FFmpeg's H.263 path derives it; then the
   IDCT residual added with saturation. A B-VOP's blocks (:func:`bidir_plain`;
   kernel M3, ``mpeg4_bidir_kernel``): forward from the past reference,
   backward from the future one, or both averaged as ``(f + b + 1) >> 1``
   (interpolated and direct macroblocks), rounding 0, then the residual;
4. the padded planes cropped to the VOL's size and converted by swscale's
   unscaled ``yuv420p`` rule (:func:`sleap_tpu_torch.io.yuv.to_bgr`,
   limited range).

The IDCT is the stream's: FFmpeg's simple IDCT (:func:`idct_values`, the one
:mod:`~sleap_tpu_torch.io.mjpeg` fitted for J5, without JPEG's level shift),
or, where the user data names an Xvid build or the fourcc is Xvid's and no
encoder is named, Xvid's as FFmpeg's x86-64 SSE2 form computes it
(:func:`xvid_idct_values`, fitted to cv2's decodes of crafted intra VOPs).
M1, M2 and M3 each have an instantiation of either.

What is decoded: rectangular 8-bit 4:2:0 VOLs of even size; I-, P- and
B-VOPs (every MB_TYPE, direct mode over one- and four-vector, skipped and
intra co-located macroblocks, DBQUANT, FFmpeg's timing rules and one-VOP
delay, :class:`Schedule`); H.263 and MPEG quantisation (default and loaded
matrices, dequantised as FFmpeg's x86 code does in 16-bit lanes); one or
four motion vectors a macroblock (half-pel, unrestricted); intra DC and AC
prediction with the alternate scans; ``intra_dc_vlc_thr``; DQUANT; skipped
macroblocks and intra macroblocks in P-VOPs; the three TCOEF escapes; video
packets (resync markers, as FFmpeg's slices: no prediction from outside a
packet's first row, its AC predictors cleared around its start); not-coded
VOPs, which give no frame; Xvid's IDCT (builds 33 on); DivX's packed
bitstream (a packet's second VOP decoded at the next packet). What FFmpeg
decodes and this module does not raises ``NotImplementedError`` naming it
(ROADMAP.md item 3g(7)): S(GMC)-VOPs and sprites, quarter-pel, interlaced
VOLs, data partitioning and reversible VLC, NEWPRED, reduced resolution,
scalability, complexity estimation headers, other shapes, chroma formats and
bit depths, full-range video, odd sizes, B-VOPs in ISO-BMFF and Matroska
tracks, the old encoders FFmpeg works around with ``FF_BUG_EDGE`` (DivX 4,
libavcodec before build 4670, Xvid to build 12) and Xvid's builds to 32
(``FF_BUG_DC_CLIP``).

:class:`Mpeg4Reader` keeps its two references on its device: a read of frame
``i`` (the ``i``-th of cv2's sequential read) decodes from the I-VOP at or
before the reference it needs, and sequential reads carry the decoder on, so
a GOP is decoded once when read in order.
"""
from __future__ import annotations

import functools
import re
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sleap_tpu_torch.io import mjpeg, yuv

unsupported = mjpeg.unsupported

# --------------------------------------------------------------------------- #
# Tables (ISO/IEC 14496-2 Annex B; H.263's for MCBPC, CBPY and MVD)
# --------------------------------------------------------------------------- #

#: TCOEF codes (code, length), the escape last, and each code's run and level:
#: intra (table B-16; codes 67 on are "last") and inter (B-17; 58 on).
INTRA_VLC = (
    (2, 2), (6, 3), (15, 4), (13, 5), (12, 5), (21, 6), (19, 6), (18, 6), (23, 7), (31, 8),
    (30, 8), (29, 8), (37, 9), (36, 9), (35, 9), (33, 9), (33, 10), (32, 10), (15, 10), (14, 10),
    (7, 11), (6, 11), (32, 11), (33, 11), (80, 12), (81, 12), (82, 12), (14, 4), (20, 6), (22, 7),
    (28, 8), (32, 9), (31, 9), (13, 10), (34, 11), (83, 12), (85, 12), (11, 5), (21, 7), (30, 9),
    (12, 10), (86, 12), (17, 6), (27, 8), (29, 9), (11, 10), (16, 6), (34, 9), (10, 10), (13, 6),
    (28, 9), (8, 10), (18, 7), (27, 9), (84, 12), (20, 7), (26, 9), (87, 12), (25, 8), (9, 10),
    (24, 8), (35, 11), (23, 8), (25, 9), (24, 9), (7, 10), (88, 12), (7, 4), (12, 6), (22, 8),
    (23, 9), (6, 10), (5, 11), (4, 11), (89, 12), (15, 6), (22, 9), (5, 10), (14, 6), (4, 10),
    (17, 7), (36, 11), (16, 7), (37, 11), (19, 7), (90, 12), (21, 8), (91, 12), (20, 8), (19, 8),
    (26, 8), (21, 9), (20, 9), (19, 9), (18, 9), (17, 9), (38, 11), (39, 11), (92, 12), (93, 12),
    (94, 12), (95, 12), (3, 7))
INTRA_RUN = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10,
    11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 20)
INTRA_LEVEL = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1)
INTER_VLC = (
    (2, 2), (15, 4), (21, 6), (23, 7), (31, 8), (37, 9), (36, 9), (33, 10), (32, 10), (7, 11),
    (6, 11), (32, 11), (6, 3), (20, 6), (30, 8), (15, 10), (33, 11), (80, 12), (14, 4), (29, 8),
    (14, 10), (81, 12), (13, 5), (35, 9), (13, 10), (12, 5), (34, 9), (82, 12), (11, 5), (12, 10),
    (83, 12), (19, 6), (11, 10), (84, 12), (18, 6), (10, 10), (17, 6), (9, 10), (16, 6), (8, 10),
    (22, 7), (85, 12), (21, 7), (20, 7), (28, 8), (27, 8), (33, 9), (32, 9), (31, 9), (30, 9),
    (29, 9), (28, 9), (27, 9), (26, 9), (34, 11), (35, 11), (86, 12), (87, 12), (7, 4), (25, 9),
    (5, 11), (15, 6), (4, 11), (14, 6), (13, 6), (12, 6), (19, 7), (18, 7), (17, 7), (16, 7),
    (26, 8), (25, 8), (24, 8), (23, 8), (22, 8), (21, 8), (20, 8), (19, 8), (24, 9), (23, 9),
    (22, 9), (21, 9), (20, 9), (19, 9), (18, 9), (17, 9), (7, 10), (6, 10), (5, 10), (4, 10),
    (36, 11), (37, 11), (38, 11), (39, 11), (88, 12), (89, 12), (90, 12), (91, 12), (92, 12),
    (93, 12), (94, 12), (95, 12), (3, 7))
INTER_RUN = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6,
    6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
    0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40)
INTER_LEVEL = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1)
INTRA_LAST, INTER_LAST, ESCAPE = 67, 58, 102
#: MCBPC of I-VOPs: index = chroma cbp | 4 with DQUANT; 8 is stuffing.
INTRA_MCBPC = ((1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9))
#: MCBPC of P-VOPs: index = chroma cbp | 4 intra | 8 DQUANT | 16 4MV; 20 is
#: stuffing; 24-27 (4MV with DQUANT) are H.263's, which FFmpeg's shared
#: table reads in MPEG-4 too.
INTER_MCBPC = ((1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7), (3, 3), (7, 7),
               (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8),
               (1, 9), (0, 0), (0, 0), (0, 0), (2, 11), (12, 13), (14, 13), (15, 13))
#: ``ff_h263_round_chroma``'s table: a 4MV macroblock's chroma vector from
#: the sum of its four luma vectors, by the sum's sixteenths.
CHROMA_ROUND = (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)
#: A job's flag (in its first word, above ``mb * 6 + block``): the block
#: goes through FFmpeg's 8-wide half-pel functions (chroma, and a 4MV
#: macroblock's luma), whose MMXEXT no_rnd forms round otherwise.
NARROW = 1 << 24
CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4),
        (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
MVD = ((1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9),
       (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10),
       (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11),
       (2, 11), (3, 12), (2, 12))
DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
          (1, 10), (1, 11))
DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
            (1, 10), (1, 11), (1, 12))
Y_DC_SCALE = (0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
              30, 31, 32, 34, 36, 38, 40, 42, 44, 46)
C_DC_SCALE = (0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17,
              18, 18, 19, 20, 21, 22, 23, 24, 25)
DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)
#: MPEG quantisation's default matrices, raster order (Annex B's, FFmpeg's
#: ``ff_mpeg4_default_intra_matrix`` and ``_non_intra_matrix``).
DEFAULT_INTRA_MATRIX = (
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26, 28, 30,
    21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45)
DEFAULT_INTER_MATRIX = (
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23, 24, 25,
    19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33)
DQUANT = (-1, -2, 1, 2)
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
          51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
ALT_HORIZONTAL = (0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24, 25, 32,
                  33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36,
                  37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62,
                  63)
ALT_VERTICAL = (0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3, 11,
                4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36,
                44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63)
#: FFmpeg's ``mpeg4_resync_prefix``: the stuffing before a resync marker, by
#: the bit position in its byte.
RESYNC_PREFIX = (0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000)
#: AVI fourccs FFmpeg's ``riff.c`` maps to ``AV_CODEC_ID_MPEG4`` (matched
#: upper-cased, as ``ff_codec_get_id`` falls back to).
FOURCCS = frozenset({
    "FMP4", "DIVX", "DX50", "XVID", "MP4S", "M4S2", "\x04\0\0\0", "ZMP4", "DIV1", "BLZ0", "MP4V",
    "UMP4", "WV1F", "SEDG", "RMP4", "3IV2", "WAWV", "FFDS", "FVFW", "DCOD", "MVXM", "PM4V",
    "SMP4", "DXGM", "VIDM", "M4T3", "GEOX", "HDX4", "DM4V", "DMK2", "DYM4", "DIGI", "EPHV",
    "EM4A", "M4CC", "SN40", "VSPX", "ULDX", "GEOV", "SIPP", "SM4V", "XVIX", "DREX", "QMP4",
    "PLV1", "GLV4", "GMP4", "MNM4", "GTM4"})
#: Fourccs FFmpeg takes for Xvid when the stream names no encoder.
XVID_TAGS = frozenset({"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"})
#: The last Xvid build FFmpeg decodes with workarounds that change pixels
#: (``ff_mpeg4_workaround_bugs``: FF_BUG_EDGE to build 12, FF_BUG_DC_CLIP
#: to 32), refused here.
OLD_XVID = 32


def _max_tables(run, level, last_from):
    """ff_rl_init's max_level[last][run] and max_run[last][level]."""
    max_level = [[0] * 64, [0] * 64]
    max_run = [[0] * 64, [0] * 64]
    for k, (r, l) in enumerate(zip(run, level)):
        last = int(k >= last_from)
        max_level[last][r] = max(max_level[last][r], l)
        max_run[last][l] = max(max_run[last][l], r)
    return max_level, max_run


INTRA_MAX_LEVEL, INTRA_MAX_RUN = _max_tables(INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
INTER_MAX_LEVEL, INTER_MAX_RUN = _max_tables(INTER_RUN, INTER_LEVEL, INTER_LAST)


def _lut(codes: Sequence[Tuple[int, int]]):
    """A lookup of the next ``bits`` bits: (symbol list, length list, bits)."""
    bits = max(n for _, n in codes)
    sym, length = [-1] * (1 << bits), [0] * (1 << bits)
    for s, (code, n) in enumerate(codes):
        if not n:
            continue
        lo = code << (bits - n)
        for k in range(lo, lo + (1 << (bits - n))):
            sym[k], length[k] = s, n
    return sym, length, bits


_LUTS = {name: _lut(codes) for name, codes in (
    ("intra_tcoef", INTRA_VLC), ("inter_tcoef", INTER_VLC), ("intra_mcbpc", INTRA_MCBPC),
    ("inter_mcbpc", INTER_MCBPC), ("cbpy", CBPY), ("mvd", MVD), ("dc_lum", DC_LUM),
    ("dc_chrom", DC_CHROM))}


# --------------------------------------------------------------------------- #
# Headers
# --------------------------------------------------------------------------- #


class BitReader:
    """MSB-first bits of ``data`` from bit ``pos``; reads past the end give
    zeros (the caller checks :attr:`left`)."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = bytes(data) + bytes(8)
        self.pos = pos
        self.end = 8 * len(data)

    def peek(self, n: int) -> int:
        p = self.pos
        w = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "big")
        return (w >> (64 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def vlc(self, name: str) -> int:
        sym, length, bits = _LUTS[name]
        k = self.peek(bits)
        if not length[k]:
            raise ValueError(f"MPEG-4: an invalid {name} code at bit {self.pos}")
        self.pos += length[k]
        return sym[k]

    def marker(self, what: str) -> None:
        if not self.read(1):
            raise ValueError(f"MPEG-4: a marker bit missing {what}")

    @property
    def left(self) -> int:
        return self.end - self.pos


@dataclass
class Vol:
    """What a VOL header sets for the VOPs after it."""

    vo_type: int
    width: int
    height: int
    time_bits: int
    quant_precision: int
    resync: bool
    control_parameters: bool
    #: MPEG quantisation's matrices (raster order); None: H.263 quantisation.
    intra_matrix: Optional[Tuple[int, ...]] = None
    inter_matrix: Optional[Tuple[int, ...]] = None
    #: The control parameters' ``low_delay`` bit (None without them).
    low_delay: Optional[int] = None
    #: ``vop_time_increment_resolution``: ticks a second.
    resolution: int = 1

    @property
    def mb_size(self) -> Tuple[int, int]:
        """Macroblocks a row and a column."""
        return (self.width + 15) // 16, (self.height + 15) // 16


def parse_vol(r: BitReader) -> Vol:
    """A VOL header from after its start code, as FFmpeg's
    ``decode_vol_header`` reads it; what this module does not decode raises."""
    r.read(1)  # random_accessible_vol
    vo_type = r.read(8)
    if vo_type in (14, 15):
        raise unsupported(f"MPEG-4 Studio Profile (video_object_type_indication {vo_type})")
    ver_id = 1
    if r.read(1):  # is_object_layer_identifier
        ver_id = r.read(4)
        r.read(3)
    if r.read(4) == 15:  # aspect_ratio_info: extended PAR
        r.read(16)
    control = bool(r.read(1))
    low_delay = None
    if control:
        chroma_format = r.read(2)
        if chroma_format != 1:
            raise unsupported(f"MPEG-4 video of chroma_format {chroma_format} (not 4:2:0)")
        low_delay = r.read(1)
        if r.read(1):  # vbv_parameters
            r.read(15), r.marker("after first_half_bit_rate"), r.read(15)
            r.marker("after latter_half_bit_rate"), r.read(15)
            r.marker("after first_half_vbv_buffer_size"), r.read(3), r.read(11)
            r.marker("after first_half_vbv_occupancy"), r.read(15)
            r.marker("after latter_half_vbv_occupancy")
    shape = r.read(2)
    if shape:
        raise unsupported(f"MPEG-4 video of {('', 'binary', 'binary-only', 'grayscale')[shape]} "
                          f"shape (not rectangular)")
    r.marker("before vop_time_increment_resolution")
    resolution = r.read(16)
    if not resolution:
        raise ValueError("MPEG-4: a VOL of vop_time_increment_resolution 0")
    time_bits = max(1, (resolution - 1).bit_length())
    r.marker("before fixed_vop_rate")
    if r.read(1):  # fixed_vop_rate
        r.read(time_bits)
    r.marker("before video_object_layer_width")
    width = r.read(13)
    r.marker("before video_object_layer_height")
    height = r.read(13)
    r.marker("after video_object_layer_height")
    if r.read(1):
        raise unsupported("Interlaced MPEG-4 video (an interlaced VOL)")
    r.read(1)  # obmc_disable
    sprite = r.read(1 if ver_id == 1 else 2)
    if sprite:
        raise unsupported(f"MPEG-4 {('', 'static sprites', 'GMC sprites (S-VOPs)')[min(sprite, 2)]}")
    quant_precision = 5
    if r.read(1):  # not_8_bit
        quant_precision = r.read(4)
        bits = r.read(4)
        if bits != 8:
            raise unsupported(f"MPEG-4 video of {bits}-bit samples")
        if not 3 <= quant_precision <= 9:
            quant_precision = 5
    matrices = (None, None)
    if r.read(1):  # quant_type: MPEG, default or loaded matrices
        matrices = tuple(_matrix(r, default) for default in (DEFAULT_INTRA_MATRIX,
                                                             DEFAULT_INTER_MATRIX))
    if ver_id != 1 and r.read(1):
        raise unsupported("Quarter-pel MPEG-4 video (quarter_sample)")
    if not r.read(1):
        raise unsupported("MPEG-4 video with complexity estimation headers")
    resync = not r.read(1)
    if r.read(1):
        raise unsupported("MPEG-4 data partitioning (and reversible VLC)")
    if ver_id != 1:
        if r.read(1):
            raise unsupported("MPEG-4 NEWPRED")
        if r.read(1):
            raise unsupported("MPEG-4 reduced-resolution VOPs")
    if r.read(1):
        raise unsupported("Scalable MPEG-4 video (scalability)")
    if not width or not height:
        raise ValueError(f"MPEG-4: a VOL of {width} x {height}")
    if width % 2 or height % 2:
        raise unsupported(f"MPEG-4 video of odd size ({width} x {height}) in 4:2:0 (swscale "
                          f"converts it through its scaler, which the port does not model)")
    return Vol(vo_type, width, height, time_bits, quant_precision, resync, control, *matrices,
               low_delay, resolution)


def _matrix(r: BitReader, default: Sequence[int]) -> Tuple[int, ...]:
    """A VOL's quantisation matrix: the default, or (load flag set) up to 64
    values in zigzag order, a 0 ending them early and the last one
    repeated."""
    out = list(default)
    if r.read(1):
        last, i = 0, 0
        while i < 64:
            if r.left < 8:
                raise ValueError("MPEG-4: a VOL's quantisation matrix runs past its data")
            v = r.read(8)
            if not v:
                break
            last = out[ZIGZAG[i]] = v
            i += 1
        for k in range(i, 64):
            out[ZIGZAG[k]] = last
    return tuple(out)


@dataclass
class Encoder:
    """The encoder a stream's user data names, as FFmpeg's
    ``decode_user_data`` reads it (-1: not named)."""

    lavc_build: int = -1
    divx_version: int = -1
    divx_packed: bool = False
    xvid_build: int = -1

    def read(self, text: bytes) -> None:
        m = re.match(rb"DivX(\d+)(?:Build|b)(\d+)(.?)", text)
        if m:
            self.divx_version = int(m.group(1))
            self.divx_packed = m.group(3) == b"p"
        m = (re.match(rb"FFmpe[^b]*b(\d+)", text)
             or re.match(rb"FFmpeg v\d+\.\d+\.\d+ / libavcodec build: (\d+)", text))
        if m:
            self.lavc_build = int(m.group(1))
        else:
            m = re.match(rb"Lavc(\d+)\.(\d+)\.(\d+)", text)
            if m and all(int(g) <= 255 for g in m.groups()):
                a, b, c = (int(g) for g in m.groups())
                self.lavc_build = (a << 16) + (b << 8) + c
            elif text == b"ffmpeg":
                self.lavc_build = 4600
        m = re.match(rb"XviD(\d+)", text)
        if m:
            self.xvid_build = int(m.group(1))

    def check(self, fourcc: str, vol: Vol) -> str:
        """The IDCT FFmpeg decodes the stream with, "simple" or "xvid" (an
        Xvid build in the user data, or an Xvid fourcc where no encoder is
        named, as ``ff_mpeg4_workaround_bugs`` decides); raise for what makes
        FFmpeg decode otherwise than this module."""
        xvid, divx = self.xvid_build, self.divx_version
        if xvid < 0 and divx < 0 and self.lavc_build < 0 and fourcc.upper() in XVID_TAGS:
            xvid = 0  # FFmpeg's guess from the fourcc
        if xvid >= 0:
            divx = -1  # FFmpeg forgets a DivX version where Xvid is named too
        elif divx < 0 and self.lavc_build < 0 and not vol.vo_type \
                and not vol.control_parameters and fourcc.upper() == "DIVX":
            divx = 400
        if 0 <= xvid <= OLD_XVID:
            raise unsupported(f"An MPEG-4 stream of Xvid build {xvid} (an old build, or one "
                              f"guessed from the fourcc), which FFmpeg decodes with its "
                              f"FF_BUG_EDGE and FF_BUG_DC_CLIP workarounds")
        if 0 <= divx < 500 or 0 <= self.lavc_build < 4670:
            raise unsupported("An MPEG-4 stream of an old encoder that FFmpeg decodes with its "
                              "FF_BUG_EDGE workaround (DivX 4, libavcodec before build 4670)")
        return "xvid" if xvid >= 0 else "simple"


@dataclass
class Vop:
    """A VOP's header: ``kind`` "I", "P", "B" or "N" (not coded: it leaves
    the references as they were and gives no frame; ``coding`` is its
    ``vop_coding_type`` all the same), where its macroblocks start (``bit``,
    from the start of the packet), its time (``modulo`` seconds of
    ``modulo_time_base`` and ``time`` ticks), and, for a B-VOP,
    the times FFmpeg's direct mode scales by (``pp_time`` between its
    references, ``pb_time`` from the past one; set by the reader's
    schedule)."""

    kind: str
    rounding: int
    dc_threshold: int
    quant: int
    f_code: int
    bit: int
    b_code: int = 1
    modulo: int = 0
    time: int = 0
    pp_time: int = 0
    pb_time: int = 0
    coding: str = ""

    def __post_init__(self):
        self.coding = self.coding or self.kind


def _start_codes(data: bytes) -> List[int]:
    """The positions of the bytes after each ``00 00 01``."""
    return [m.start() + 3 for m in re.finditer(b"\x00\x00\x01", data)]


def parse_vop(r: BitReader, vol: Vol) -> Vop:
    """A VOP header from after its start code (``decode_vop_header``)."""
    kind = r.read(2)
    if kind == 3:
        raise unsupported("MPEG-4 S(GMC)-VOPs")
    modulo = 0
    while r.read(1):  # modulo_time_base
        modulo += 1
        if r.left <= 0:
            raise ValueError("MPEG-4: a VOP header runs past its packet")
    r.marker("before vop_time_increment")
    time = r.read(vol.time_bits)
    r.marker("before vop_coded")
    if not r.read(1):  # not coded: FFmpeg outputs no frame for it
        return Vop("N", 0, 0, 0, 0, r.pos, modulo=modulo, time=time, coding="IPB"[kind])
    rounding = r.read(1) if kind == 1 else 0
    dc_threshold = DC_THRESHOLD[r.read(3)]
    quant = r.read(vol.quant_precision)
    if not quant:
        raise ValueError("MPEG-4: a VOP of quantiser 0")
    f_code = r.read(3) if kind else 1
    b_code = r.read(3) if kind == 2 else 1
    if not f_code or not b_code:
        raise ValueError("MPEG-4: a VOP of f_code or b_code 0")
    if r.left < 0:
        raise ValueError("MPEG-4: a VOP header runs past its packet")
    return Vop("IPB"[kind], rounding, dc_threshold, quant, f_code, r.pos, b_code, modulo, time)


class Stream:
    """What a stream's headers set: its VOL, its encoder, its fourcc (the
    AVI or ``V_MS/VFW/FOURCC`` tag, "" elsewhere), the IDCT FFmpeg decodes
    it with (``idct``), and, of the last :meth:`headers` call, the time code
    of a GOV header (``gov_seconds``, None without one) and where its VOP
    starts (``vop_at``, the byte after its start code)."""

    def __init__(self, fourcc: str = "", config: bytes = b""):
        self.fourcc = fourcc
        self.vol: Optional[Vol] = None
        self.encoder = Encoder()
        self.idct = "simple"
        self.gov_seconds: Optional[int] = None
        self.vop_at = -1
        if config:
            self.headers(config)

    def headers(self, data: bytes) -> Optional[Vop]:
        """Read the headers in ``data`` (a packet, or a container's
        configuration record) up to its first VOP, as FFmpeg's
        ``ff_mpeg4_decode_picture_header`` does; that VOP's header, where
        there is one (what follows it, a packed bitstream's second VOP, is
        the reader's)."""
        self.gov_seconds, self.vop_at = None, -1
        for at in _start_codes(data):
            code = data[at]
            r = BitReader(data, 8 * (at + 1))
            if 0x20 <= code <= 0x2F:
                self.vol = parse_vol(r)
            elif code == 0xB2:
                end = data.find(b"\x00\x00\x01", at + 1)
                self.encoder.read(data[at + 1:end if end >= 0 else len(data)][:255])
            elif code == 0xB3:  # GOV: FFmpeg takes its time code, not its flags
                hours, minutes = r.read(5), r.read(6)
                r.read(1)
                self.gov_seconds = r.read(6) + 60 * (minutes + 60 * hours)
            elif code == 0xB5:
                _visual_object(r)
            elif code == 0xB6:
                if self.vol is None:
                    raise ValueError("MPEG-4: a VOP before any VOL header")
                self.idct = self.encoder.check(self.fourcc, self.vol)
                self.vop_at = at + 1
                return parse_vop(r, self.vol)
        return None


def _visual_object(r: BitReader) -> None:
    """A visual object header: full-range video raises (swscale's rule here
    is limited range)."""
    if r.read(1):  # is_visual_object_identifier
        r.read(7)
    if r.read(4) in (1, 2) and r.read(1):  # video ID with video_signal_type
        r.read(3)
        if r.read(1):
            raise unsupported("Full-range MPEG-4 video (video_range 1)")


# --------------------------------------------------------------------------- #
# The macroblock layer (the plain entropy decoder)
# --------------------------------------------------------------------------- #


@dataclass
class Macroblocks:
    """A VOP's decoded macroblock layer, what M1, M2 and M3 take:

    - ``coefs`` (n, 64) int16: dequantised blocks in raster order, DC and AC
      prediction applied;
    - ``intra`` (i, 4) int32 jobs of M1 and ``inter`` (j, 4) int32 jobs of
      M2, one an 8x8 block: ``mb * 6 + block`` (blocks 0-3 luma, 4 Cb, 5
      Cr), the block's row of ``coefs`` (-1: no residual), and its motion
      vector in half samples of its own plane (0 for intra blocks);
    - ``bidir`` (k, 8) int32 jobs of M3 (a B-VOP's blocks): ``mb * 6 +
      block``, the row of ``coefs``, the forward and the backward vector,
      the directions (1 forward, 2 backward, 3 both), 0;
    - ``modes`` (macroblocks,) int8: 0 intra, 1 inter, 2 skipped; a
      B-VOP's :data:`B_MODES`;
    - ``colocated`` (macroblocks, 9) int32 of an I- or P-VOP, what the
      B-VOPs after it read of it: :data:`COLOCATED_SKIPPED`,
      :data:`COLOCATED_8X8` and :data:`COLOCATED_INTRA` flags, then the four
      luma blocks' vectors as FFmpeg's ``motion_val`` holds them once the
      VOP is decoded."""

    coefs: np.ndarray
    intra: np.ndarray
    inter: np.ndarray
    modes: np.ndarray
    bidir: np.ndarray = None
    colocated: np.ndarray = None


#: :attr:`Macroblocks.colocated`'s flags.
COLOCATED_SKIPPED, COLOCATED_8X8, COLOCATED_INTRA = 1, 2, 4
#: MB_TYPE of B-VOPs (``mb_type_b_map``): code length - 1 -> type.
B_DIRECT, B_INTERPOLATE, B_BACKWARD, B_FORWARD = range(4)
#: A B-VOP's :attr:`Macroblocks.modes`.
B_MODES = ("skipped", "forward", "backward", "interpolated", "direct", "direct 8x8")


def _rounded_div(a: int, b: int) -> int:
    h = b >> 1
    return (a + h) // b if a > 0 else -((h - a) // b)


def _i16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def chroma_vector(mx: int, my: int) -> Tuple[int, int]:
    """A 16x16 luma vector's chroma vector (half samples), as FFmpeg's H.263
    path derives it: the integer part of half the luma position, half-pel
    where either low bit of the luma vector is set."""
    return (2 * ((mx >> 1) >> 1) + ((mx & 1) | ((mx >> 1) & 1)),
            2 * ((my >> 1) >> 1) + ((my & 1) | ((my >> 1) & 1)))


def four_vectors(vectors, mb_x: int, mb_y: int, width: int, height: int):
    """A 4MV macroblock's six jobs' vectors and flags, as FFmpeg's
    ``apply_8x8`` moves them: each luma block by ``hpel_motion``, its source
    clipped to -16 .. the VOL's width and height (a half sample dropped at
    that far edge), and one chroma vector from the four's sum
    (``chroma_4mv_motion``: ``ff_h263_round_chroma``, clipped to -8 .. half
    the size). Each vector is relative to its block, in half samples."""
    out = []
    for n, (mx, my) in enumerate(vectors):
        x0, y0 = 16 * mb_x + 8 * (n & 1), 16 * mb_y + 8 * (n >> 1)
        sx = min(max(x0 + (mx >> 1), -16), width)
        sy = min(max(y0 + (my >> 1), -16), height)
        out.append((2 * (sx - x0) + (mx & 1 if sx != width else 0),
                    2 * (sy - y0) + (my & 1 if sy != height else 0), NARROW))
    chroma = []
    for total, origin, size in ((sum(v[0] for v in vectors), 8 * mb_x, width >> 1),
                                (sum(v[1] for v in vectors), 8 * mb_y, height >> 1)):
        c = CHROMA_ROUND[total & 15] + ((total >> 3) & ~1)
        src = min(max(origin + (c >> 1), -8), size)
        chroma.append(2 * (src - origin) + (c & 1 if src != size else 0))
    return out + [(*chroma, NARROW)] * 2


def _motion(r: BitReader, pred: int, f_code: int) -> int:
    """``ff_h263_decode_motion``: one component, wrapped to 5 + f_code bits."""
    code = r.vlc("mvd")
    if code == 0:
        return pred
    sign = r.read(1)
    val = code
    if f_code > 1:
        val = (((val - 1) << (f_code - 1)) | r.read(f_code - 1)) + 1
    val = pred + (-val if sign else val)
    bits = 5 + f_code
    return ((val + (1 << (bits - 1))) & ((1 << bits) - 1)) - (1 << (bits - 1))


def _tcoef(r: BitReader, block: List[int], i: int, intra: bool, scan, qmul: int,
           qadd: int) -> None:
    """The TCOEF run-levels of one block into ``block`` (raster order), from
    scan position ``i + 1``, each level times ``qmul`` plus ``qadd`` (H.263's
    inter dequantisation; 1 and 0 keep the level)."""
    name = "intra_tcoef" if intra else "inter_tcoef"
    run_of, level_of, last_from = ((INTRA_RUN, INTRA_LEVEL, INTRA_LAST) if intra else
                                   (INTER_RUN, INTER_LEVEL, INTER_LAST))
    max_level, max_run = ((INTRA_MAX_LEVEL, INTRA_MAX_RUN) if intra else
                          (INTER_MAX_LEVEL, INTER_MAX_RUN))
    while True:
        s = r.vlc(name)
        fixed = False
        if s == ESCAPE:
            if not r.read(1):  # type 1: level + LMAX
                s = r.vlc(name)
                if s == ESCAPE:
                    raise ValueError("MPEG-4: an escape after a first escape")
                last, run, level = s >= last_from, run_of[s], level_of[s]
                level += max_level[last][run]
            elif not r.read(1):  # type 2: run + RMAX + 1
                s = r.vlc(name)
                if s == ESCAPE:
                    raise ValueError("MPEG-4: an escape after a second escape")
                last, run, level = s >= last_from, run_of[s], level_of[s]
                run += max_run[last][level] + 1
            else:  # type 3: fixed-length last, run, level
                last, run = r.read(1), r.read(6)
                r.marker("before a third escape's level")
                level = r.read(12)
                level -= (level & 0x800) << 1
                r.marker("after a third escape's level")
                fixed = True
        else:
            last, run, level = s >= last_from, run_of[s], level_of[s]
        if fixed:
            level = level * qmul + qadd if level > 0 else level * qmul - qadd
            level = min(max(level, -2048), 2047)
        else:
            level = level * qmul + qadd
            if r.read(1):
                level = -level
        i += run + 1
        if i > 63 or (i == 63 and not last):
            raise ValueError("MPEG-4: a block of more than 64 coefficients")
        block[scan[i]] = level
        if last:
            return


def _dequantise_mpeg_intra(block: List[int], qscale: int, matrix: Sequence[int]) -> None:
    """MPEG dequantisation of an intra block's AC levels as FFmpeg's x86
    ``dct_unquantize_mpeg2_intra`` (the MMX form it installs without
    AV_CODEC_FLAG_BITEXACT) computes it, in 16-bit lanes: the linear
    quantiser scale (twice the quantiser) times the matrix entry, times the
    level's magnitude, each product's low 16 bits, shifted right by 4 as a
    signed word, the sign put back; no mismatch control."""
    for j in range(1, 64):
        v = block[j]
        if v:
            q = (2 * qscale * matrix[j]) & 0xFFFF
            level = _i16((abs(_i16(v)) * q) & 0xFFFF) >> 4
            block[j] = _i16(level if v > 0 else -level)


def _dequantise_mpeg_inter(block: List[int], qscale: int, matrix: Sequence[int]) -> None:
    """MPEG dequantisation of an inter block as FFmpeg's x86
    ``dct_unquantize_mpeg2_inter`` computes it, in 16-bit lanes: ((2 |level|
    + 1) times the linear quantiser scale times the matrix entry), its low
    16 bits shifted right by 5 as an unsigned word, the sign put back; then
    the mismatch control: the last coefficient's lowest bit flipped where
    the sum of the block is even."""
    parity = 1
    for j in range(64):
        v = block[j]
        if v:
            q = (2 * qscale * matrix[j]) & 0xFFFF
            level = ((2 * (abs(_i16(v)) & 0xFFFF) * q + q) & 0xFFFF) >> 5
            block[j] = _i16(level if v > 0 else -level)
            parity ^= block[j] & 1
    block[63] ^= parity


def decode_macroblocks(data: bytes, vol: Vol, vop: Vop,
                       colocated: Optional[np.ndarray] = None) -> Macroblocks:
    """The plain entropy decoder: every macroblock of the VOP in ``data``
    (its packet), as FFmpeg's ``mpeg4_decode_mb`` and ``mpeg4_decode_block``
    decode them, with ``ff_mpeg4_pred_dc``, ``ff_mpeg4_pred_ac``,
    ``ff_h263_pred_motion`` and H.263 dequantisation. A B-VOP reads the
    future reference's ``colocated`` (:attr:`Macroblocks.colocated`)."""
    if vop.kind == "B":
        return _decode_b(data, vol, vop, colocated)
    r = BitReader(data, vop.bit)
    mb_w, mb_h = vol.mb_size
    P = vop.kind == "P"
    qscale = vop.quant
    lw, cw, vw = 2 * mb_w + 1, mb_w + 1, 2 * mb_w + 2
    dc = [[1024] * ((2 * mb_h + 1) * lw), [1024] * ((mb_h + 1) * cw), [1024] * ((mb_h + 1) * cw)]
    zero = (0,) * 16
    ac = [[zero] * len(d) for d in dc]
    mv = [(0, 0)] * ((2 * mb_h + 1) * vw)
    qtab = [0] * (mb_w * mb_h)
    coefs: List[List[int]] = []
    intra_jobs: List[Tuple[int, int, int, int]] = []
    inter_jobs: List[Tuple[int, int, int, int]] = []
    modes = np.zeros(mb_w * mb_h, np.int8)
    four = np.zeros(mb_w * mb_h, bool)

    def cell(n, x, y):  # (grid, index) of block n of macroblock (x, y)
        if n < 4:
            return 0, (2 * y + (n >> 1) + 1) * lw + 2 * x + (n & 1) + 1
        return n - 3, (y + 1) * cw + x + 1

    # A video packet's first macroblock, and whether the macroblock being
    # decoded is in its first row (decode_slice's first_slice_line, which
    # lasts up to the macroblock below the packet's first).
    resync_x, resync_y, first_line = 0, 0, True
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            mb = mb_y * mb_w + mb_x
            if (mb_x, mb_y) == (resync_x, resync_y + 1):
                first_line = False
            intra, skipped, cbpc, dquant = not P, False, 0, False
            if P:
                while True:
                    if r.read(1):
                        skipped = True
                        break
                    cbpc = r.vlc("inter_mcbpc")
                    if cbpc != 20:
                        break
                if not skipped:
                    intra, dquant = bool(cbpc & 4), bool(cbpc & 8)
            else:
                while True:
                    cbpc = r.vlc("intra_mcbpc")
                    if cbpc != 8:
                        break
                dquant = bool(cbpc & 4)
            base = 2 * mb_y * vw + 2 * mb_x + 1  # the b8 row above block 0
            if skipped or not intra:
                if skipped:
                    mx = my = 0
                    modes[mb] = 2
                    blocks = [None] * 6
                else:
                    modes[mb] = 1
                    cbpy = r.vlc("cbpy") ^ 15
                    cbp = (cbpc & 3) | (cbpy << 2)
                    if dquant:
                        qscale = min(max(qscale + DQUANT[r.read(2)], 1), 31)
                    vectors = []
                    for n in range(4 if cbpc & 16 else 1):  # ff_h263_pred_motion
                        at = base + vw * (1 + (n >> 1)) + (n & 1)
                        a, b, c = mv[at - 1], mv[at - vw], mv[at - vw + (2, 1, 1, -1)[n]]
                        if first_line and n < 2:
                            if n == 0 and mb_x == resync_x:
                                a = b = c = (0, 0)
                            elif mb_x + 1 == resync_x:  # left of the packet's first
                                a, b = ((c, c) if n == 0 and mb_x == 0 else (a, (0, 0)))
                            else:
                                b = c = a
                        elif first_line and n == 2 and mb_x == resync_x:
                            a = mv[at - 1] = (0, 0)  # FFmpeg zeroes the stored vector too
                        px = sorted((a[0], b[0], c[0]))[1]
                        py = sorted((a[1], b[1], c[1]))[1]
                        vector = (_motion(r, px, vop.f_code), _motion(r, py, vop.f_code))
                        mv[at] = vector
                        vectors.append(vector)
                    qmul, qadd = (1, 0) if vol.inter_matrix else (qscale << 1, (qscale - 1) | 1)
                    blocks = []
                    for n in range(6):
                        if cbp & (32 >> n):
                            block = [0] * 64
                            _tcoef(r, block, -1, False, ZIGZAG, qmul, qadd)
                            if vol.inter_matrix:
                                _dequantise_mpeg_inter(block, qscale, vol.inter_matrix)
                            blocks.append(block)
                        else:
                            blocks.append(None)
                if skipped or len(vectors) == 1:
                    mx, my = (0, 0) if skipped else vectors[0]
                    moved = [(mx, my, 0)] * 4 + [(*chroma_vector(mx, my), NARROW)] * 2
                    for o in (vw, vw + 1, 2 * vw, 2 * vw + 1):
                        mv[base + o] = (mx, my)
                else:
                    moved = four_vectors(vectors, mb_x, mb_y, vol.width, vol.height)
                    four[mb] = True
                for n, block in enumerate(blocks):
                    k = -1
                    if block is not None:
                        k = len(coefs)
                        coefs.append(block)
                    vx, vy, flag = moved[n]
                    inter_jobs.append((mb * 6 + n | flag, k, vx, vy))
                for n in range(6):  # ff_clean_intra_table_entries
                    g, k = cell(n, mb_x, mb_y)
                    dc[g][k], ac[g][k] = 1024, zero
            else:
                modes[mb] = 0
                ac_pred = r.read(1)
                cbpy = r.vlc("cbpy")
                cbp = (cbpc & 3) | (cbpy << 2)
                use_dc_vlc = qscale < vop.dc_threshold
                if dquant:
                    qscale = min(max(qscale + DQUANT[r.read(2)], 1), 31)
                for n in range(6):
                    block = [0] * 64
                    g, k = cell(n, mb_x, mb_y)
                    grid, step = dc[g], (lw if g == 0 else cw)
                    scale = Y_DC_SCALE[qscale] if n < 4 else C_DC_SCALE[qscale]
                    a, b, c = grid[k - 1], grid[k - 1 - step], grid[k - step]
                    if first_line and n != 3:  # neighbours outside the packet
                        if n != 2:
                            b = c = 1024
                        if n != 1 and mb_x == resync_x:
                            b = a = 1024
                    if (mb_x, mb_y) == (resync_x, resync_y + 1) and n in (0, 4, 5):
                        b = 1024
                    top = abs(a - b) < abs(b - c)
                    pred = ((c if top else a) + (scale >> 1)) // scale
                    i = -1
                    if use_dc_vlc:
                        size = r.vlc("dc_lum" if n < 4 else "dc_chrom")
                        level = 0
                        if size:
                            level = r.read(size)
                            if not level >> (size - 1):
                                level -= (1 << size) - 1
                            if size > 8:
                                r.read(1)  # marker
                        block[0] = level
                        i = 0
                    if cbp & (32 >> n):
                        scan = (ALT_HORIZONTAL if top else ALT_VERTICAL) if ac_pred else ZIGZAG
                        _tcoef(r, block, i, True, scan, 1, 0)
                    block[0] = _i16(block[0] + pred)
                    stored = block[0] * scale
                    if stored & ~2047:
                        stored = 0 if stored < 0 else 2047
                    grid[k] = stored
                    # AC prediction on the quantised levels, then the copies.
                    if ac_pred:
                        if top:
                            nq = qtab[mb - mb_w] if mb_y else qscale
                            pv = ac[g][k - step]
                            same = mb_y == 0 or nq == qscale or n in (2, 3)
                            for j in range(1, 8):
                                p = pv[8 + j] if same else _rounded_div(pv[8 + j] * nq, qscale)
                                block[j] = _i16(block[j] + p)
                        else:
                            nq = qtab[mb - 1] if mb_x else qscale
                            pv = ac[g][k - 1]
                            same = mb_x == 0 or nq == qscale or n in (1, 3)
                            for j in range(1, 8):
                                p = pv[j] if same else _rounded_div(pv[j] * nq, qscale)
                                block[8 * j] = _i16(block[8 * j] + p)
                    ac[g][k] = (0, *(block[8 * j] for j in range(1, 8)), 0,
                                *(block[j] for j in range(1, 8)))
                    # Intra dequantisation, H.263's or MPEG's.
                    qmul, qadd = qscale << 1, (qscale - 1) | 1
                    block[0] = block[0] * scale
                    if vol.intra_matrix:
                        _dequantise_mpeg_intra(block, qscale, vol.intra_matrix)
                    else:
                        for j in range(1, 64):
                            v = block[j]
                            if v:
                                block[j] = v * qmul + qadd if v > 0 else v * qmul - qadd
                    intra_jobs.append((mb * 6 + n, len(coefs), 0, 0))
                    coefs.append(block)
                for o in (vw, vw + 1, 2 * vw, 2 * vw + 1):
                    mv[base + o] = (0, 0)
            qtab[mb] = qscale
            if r.left < 0:
                raise ValueError(f"MPEG-4: the VOP's data ends inside macroblock {mb}")
            packet_quant = (_video_packet(r, vol, vop, mb + 1)
                            if vol.resync and mb + 1 < mb_w * mb_h else None)
            if packet_quant is not None:
                resync_x, resync_y, first_line = (mb + 1) % mb_w, (mb + 1) // mb_w, True
                qscale = packet_quant or qscale
                # ff_mpeg4_clean_buffers: the AC predictors from the top-left
                # neighbour's last block on, through the left neighbour's.
                at = 2 * resync_y * lw + 2 * resync_x
                ac[0][at:at + 2 * lw + 1] = [zero] * (2 * lw + 1)
                at = resync_y * cw + resync_x
                for g in (1, 2):
                    ac[g][at:at + cw + 1] = [zero] * (cw + 1)
    out = np.zeros((len(coefs), 64), np.int64)
    if coefs:
        out[:] = coefs
    colocated = np.zeros((mb_w * mb_h, 9), np.int32)
    colocated[:, 0] = np.select([modes == 0, modes == 2, four],
                                [COLOCATED_INTRA, COLOCATED_SKIPPED, COLOCATED_8X8], 0)
    for mb in range(mb_w * mb_h):
        base = 2 * (mb // mb_w) * vw + 2 * (mb % mb_w) + 1
        colocated[mb, 1:] = [c for o in (vw, vw + 1, 2 * vw, 2 * vw + 1) for c in mv[base + o]]
    return Macroblocks(out.astype(np.int16), np.array(intra_jobs, np.int32).reshape(-1, 4),
                       np.array(inter_jobs, np.int32).reshape(-1, 4), modes,
                       np.zeros((0, 8), np.int32), colocated)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero), ``b`` > 0."""
    return -(-a // b) if a < 0 else a // b


def direct_vectors(col: Sequence[int], dx: int, dy: int, pp: int, pb: int):
    """``ff_mpeg4_set_direct_mv``: a direct macroblock's forward and
    backward vectors from the co-located ones (``col``, a row of
    :attr:`Macroblocks.colocated`) and the delta: four of each where the
    co-located macroblock had four, else one. Each component of the
    co-located vector p gives ``p * pb / pp + d`` forward and, backward,
    the forward one less p where its delta d is not 0, else ``p * (pb -
    pp) / pp`` (C's division)."""
    n = 4 if col[0] & COLOCATED_8X8 else 1
    fwd, bwd = [], []
    for i in range(n):
        f, b = [], []
        for p, d in ((col[1 + 2 * i], dx), (col[2 + 2 * i], dy)):
            f.append(_cdiv(p * pb, pp) + d)
            b.append(f[-1] - p if d else _cdiv(p * (pb - pp), pp))
        fwd.append(tuple(f))
        bwd.append(tuple(b))
    return fwd, bwd


def _block_vectors(vectors, mb_x: int, mb_y: int, vol: Vol):
    """Six blocks' vectors from one (a 16x16 prediction: the chroma one as
    FFmpeg's H.263 path derives it) or four (:func:`four_vectors`)."""
    if len(vectors) == 1:
        mx, my = vectors[0]
        return [(mx, my)] * 4 + [chroma_vector(mx, my)] * 2
    return [v[:2] for v in four_vectors(vectors, mb_x, mb_y, vol.width, vol.height)]


def _decode_b(data: bytes, vol: Vol, vop: Vop, colocated: np.ndarray) -> Macroblocks:
    """A B-VOP's macroblocks (``mpeg4_decode_mb``'s B branch): a macroblock
    whose co-located one the future reference skipped is skipped unread
    (forward, zero vector, no residual); else MODB, MB_TYPE, CBPB, DBQUANT,
    the forward and backward vectors (predicted from the last of their
    direction, both reset at each row and video packet), direct mode's
    delta (:func:`direct_vectors`), then the blocks as a P-VOP's."""
    r = BitReader(data, vop.bit)
    mb_w, mb_h = vol.mb_size
    qscale = vop.quant
    coefs: List[List[int]] = []
    jobs: List[Tuple[int, ...]] = []
    modes = np.zeros(mb_w * mb_h, np.int8)
    last = [(0, 0), (0, 0)]
    for mb in range(mb_w * mb_h):
        mb_x, mb_y = mb % mb_w, mb // mb_w
        if mb_x == 0:
            last = [(0, 0), (0, 0)]
        col = colocated[mb]
        cbp, blocks = 0, [None] * 6
        if col[0] & COLOCATED_SKIPPED:
            dirs, fwd, bwd = 1, [(0, 0)], [(0, 0)]
        else:
            delta = (0, 0)
            if r.read(1):  # MODB '1': direct, nothing more
                mb_type = B_DIRECT
            else:
                no_cbp = r.read(1)
                mb_type = 0
                while not r.read(1):
                    mb_type += 1
                    if mb_type > 3:
                        raise ValueError(f"MPEG-4: an invalid B-VOP MB_TYPE at bit {r.pos}")
                cbp = 0 if no_cbp else r.read(6)
                if mb_type != B_DIRECT and cbp and r.read(1):
                    qscale = min(max(qscale + 4 * r.read(1) - 2, 1), 31)
                if mb_type in (B_INTERPOLATE, B_FORWARD):
                    last[0] = (_motion(r, last[0][0], vop.f_code), _motion(r, last[0][1], vop.f_code))
                if mb_type in (B_INTERPOLATE, B_BACKWARD):
                    last[1] = (_motion(r, last[1][0], vop.b_code), _motion(r, last[1][1], vop.b_code))
                if mb_type == B_DIRECT:
                    delta = (_motion(r, 0, 1), _motion(r, 0, 1))
            if mb_type == B_DIRECT:
                dirs = 3
                fwd, bwd = direct_vectors(col, *delta, vop.pp_time, vop.pb_time)
                modes[mb] = 4 + (len(fwd) == 4)
            else:
                dirs = {B_INTERPOLATE: 3, B_BACKWARD: 2, B_FORWARD: 1}[mb_type]
                fwd, bwd = [last[0]], [last[1]]
                modes[mb] = {B_INTERPOLATE: 3, B_BACKWARD: 2, B_FORWARD: 1}[mb_type]
            qmul, qadd = (1, 0) if vol.inter_matrix else (qscale << 1, (qscale - 1) | 1)
            for n in range(6):
                if cbp & (32 >> n):
                    block = [0] * 64
                    _tcoef(r, block, -1, False, ZIGZAG, qmul, qadd)
                    if vol.inter_matrix:
                        _dequantise_mpeg_inter(block, qscale, vol.inter_matrix)
                    blocks[n] = block
        fv, bv = _block_vectors(fwd, mb_x, mb_y, vol), _block_vectors(bwd, mb_x, mb_y, vol)
        for n in range(6):
            k = -1
            if blocks[n] is not None:
                k = len(coefs)
                coefs.append(blocks[n])
            jobs.append((mb * 6 + n, k, *fv[n], *bv[n], dirs, 0))
        if r.left < 0:
            raise ValueError(f"MPEG-4: the VOP's data ends inside macroblock {mb}")
        if vol.resync and mb + 1 < mb_w * mb_h:
            # A marker of a later macroblock waits while the next is skipped.
            later = bool(colocated[mb + 1, 0] & COLOCATED_SKIPPED)
            packet_quant = _video_packet(r, vol, vop, mb + 1, later)
            if packet_quant is not None:
                qscale = packet_quant or qscale
                last = [(0, 0), (0, 0)]  # ff_mpeg4_clean_buffers
    out = np.zeros((len(coefs), 64), np.int64)
    if coefs:
        out[:] = coefs
    return Macroblocks(out.astype(np.int16), np.zeros((0, 4), np.int32), np.zeros((0, 4), np.int32),
                       modes, np.array(jobs, np.int32).reshape(-1, 8))


def _video_packet(r: BitReader, vol: Vol, vop: Vop, next_mb: int,
                  later: bool = False) -> Optional[int]:
    """Where a resync marker follows (``mpeg4_is_resync``, MCBPC stuffing
    before it passed over), read the video packet header after it
    (``ff_mpeg4_decode_video_packet_header``: its macroblock number, which
    must be ``next_mb``, and the header extension, read and passed over as
    FFmpeg does) and return its quantiser (0: keep the running one); else
    None, ``r`` where it was, past any stuffing. With ``later`` (a B-VOP
    whose next macroblock is skipped unread) a marker of a later
    macroblock is left for then, as FFmpeg's ``SLICE_OK`` leaves it."""
    v = r.peek(16)
    pict = 1 if vop.kind == "I" else 2
    while vop.kind != "B" and v <= 0xFF and (v >> (8 - pict)) == 1:  # MCBPC stuffing
        r.pos += 8 + pict
        v = r.peek(16)
    if r.pos + 8 >= r.end or v != RESYNC_PREFIX[r.pos & 7]:
        return None
    start = r.pos
    r.pos = ((r.pos + 1) + 7) & ~7
    prefix = {"I": 16, "P": 15 + vop.f_code, "B": 15 + max(vop.f_code, vop.b_code, 2)}[vop.kind]
    zeros = 0
    while zeros < 32 and not r.read(1):
        zeros += 1
    if zeros < prefix:
        r.pos = start
        return None
    if zeros != prefix:
        raise ValueError(f"MPEG-4: a resync marker of {zeros} zeros, not {prefix}")
    mb_w, mb_h = vol.mb_size
    mb = r.read(max(1, (mb_w * mb_h - 1).bit_length()))
    if later and mb > next_mb:
        r.pos = start
        return None
    if mb != next_mb:
        raise ValueError(f"MPEG-4: a video packet starts at macroblock {mb}, not {next_mb}")
    quant = r.read(vol.quant_precision)
    if r.read(1):  # header_extension_code
        while r.read(1):  # modulo_time_base
            if r.left <= 0:
                raise ValueError("MPEG-4: a video packet header runs past its VOP")
        r.marker("before a video packet's time increment")
        r.read(vol.time_bits)
        r.marker("before a video packet's vop_coding_type")
        r.read(2 + 3 + {"I": 0, "P": 3, "B": 6}[vop.kind])  # type, intra_dc_vlc_thr, f/b_code
    return quant


# --------------------------------------------------------------------------- #
# M1 and M2's plain versions, and the frame
# --------------------------------------------------------------------------- #


def idct_values(coefs: torch.Tensor) -> torch.Tensor:
    """J5's IDCT (:func:`sleap_tpu_torch.io.mjpeg.simple_idct`) of (blocks,
    64) int16 coefficients in raster order, without JPEG's dequantisation
    and level shift: (blocks, 8, 8) int64 values before saturation."""
    return mjpeg.simple_idct(coefs.long())


def _xvid_row_table() -> List[List[int]]:
    """The row pass's constants: for each row, 2^14 sqrt(2) cos(k pi / 16)
    (k = 1..7; k = 0 takes cos(pi / 4)) of the column index, times the same
    factor of the row's own index folded into 0..4 (rows 5, 6, 7 share the
    tables of rows 3, 2, 1), rounded (the AP-922 tables)."""
    f = [1.0] + [np.sqrt(2) * np.cos(k * np.pi / 16) for k in range(1, 8)]
    f[4] = 1.0
    return [[int(np.floor(16384 * f[min(r, 8 - r) % 8] * f[k] + 0.5)) for k in range(8)]
            for r in range(8)]


XVID_ROW = _xvid_row_table()
#: The row pass's rounding, by row (Walken's rounders).
XVID_ROUNDERS = (65536, 3597, 2260, 1203, 0, 120, 512, 512)
#: The column pass's constants: tan(pi/16), tan(pi/8) and tan(3pi/16) - 1 in
#: Q16, cos(pi/4) / 2 in Q16.
XVID_T1, XVID_T2, XVID_T3, XVID_C4 = 13036, 27146, -21746, 23170


def _sat16(v: torch.Tensor) -> torch.Tensor:
    return v.clamp(-32768, 32767)


def _mulhi(a: torch.Tensor, c: int) -> torch.Tensor:
    return (a * c) >> 16


def xvid_idct_values(coefs: torch.Tensor) -> torch.Tensor:
    """Xvid's IDCT as FFmpeg's x86-64 SSE2 form (``ff_xvid_idct_sse2``)
    computes it, of (blocks, 64) int16 coefficients in raster order: (blocks,
    8, 8) int64 values before saturation to 8 bits. Rows: AP-922's matrix
    product in 32 bits with Walken's rounders, shifted right by 11 and
    saturated to 16 bits; columns: Loeffler's butterflies in saturating
    16-bit arithmetic with ``pmulhw`` products, shifted right by 6."""
    z = coefs.long().view(-1, 8, 8)
    rows = []
    for r in range(8):
        c = XVID_ROW[r]
        x = [z[:, r, k] for k in range(8)]
        rnd = XVID_ROUNDERS[r]
        a = (c[0] * x[0] + c[2] * x[2] + c[4] * x[4] + c[6] * x[6] + rnd,
             c[0] * x[0] + c[6] * x[2] - c[4] * x[4] - c[2] * x[6] + rnd,
             c[0] * x[0] - c[6] * x[2] - c[4] * x[4] + c[2] * x[6] + rnd,
             c[0] * x[0] - c[2] * x[2] + c[4] * x[4] - c[6] * x[6] + rnd)
        b = (c[1] * x[1] + c[3] * x[3] + c[5] * x[5] + c[7] * x[7],
             c[3] * x[1] - c[7] * x[3] - c[1] * x[5] - c[5] * x[7],
             c[5] * x[1] - c[1] * x[3] + c[7] * x[5] + c[3] * x[7],
             c[7] * x[1] - c[5] * x[3] + c[3] * x[5] - c[1] * x[7])
        out = [0] * 8
        for k in range(4):
            out[k] = _sat16(_i32(a[k] + b[k]) >> 11)
            out[7 - k] = _sat16(_i32(a[k] - b[k]) >> 11)
        rows.append(torch.stack(out, 1))
    w = torch.stack(rows, 1)  # (blocks, row, column)
    x = [w[:, k, :] for k in range(8)]
    s = _sat16
    tm35 = s(s(_mulhi(x[3], XVID_T3) + x[3]) - x[5])
    tp35 = s(s(_mulhi(x[5], XVID_T3) + x[5]) + x[3])
    tp17 = s(_mulhi(x[7], XVID_T1) + x[1])
    tm17 = s(_mulhi(x[1], XVID_T1) - x[7])
    b0, b3 = s(tp17 + tp35), s(tm17 - tm35)
    t1, t2 = s(tp17 - tp35), s(tm17 + tm35)
    b1, b2 = s(2 * _mulhi(s(t1 + t2), XVID_C4)), s(2 * _mulhi(s(t1 - t2), XVID_C4))
    tm26 = s(_mulhi(x[2], XVID_T2) - x[6])
    tp26 = s(_mulhi(x[6], XVID_T2) + x[2])
    tp04, tm04 = s(x[0] + x[4]), s(x[0] - x[4])
    a0, a1, a2, a3 = s(tp04 + tp26), s(tm04 + tm26), s(tm04 - tm26), s(tp04 - tp26)
    out = [s(a0 + b0), s(a1 + b1), s(a2 + b2), s(a3 + b3),
           s(a3 - b3), s(a2 - b2), s(a1 - b1), s(a0 - b0)]
    return torch.stack([v >> 6 for v in out], 1)


def _i32(v: torch.Tensor) -> torch.Tensor:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


#: The IDCTs FFmpeg runs, by name: its simple IDCT, and Xvid's (for streams
#: whose user data or fourcc names Xvid).
IDCTS = {"simple": idct_values, "xvid": xvid_idct_values}


@dataclass
class Layout:
    """The padded planes' geometry: macroblocks a row and a column."""

    mb_w: int
    mb_h: int

    def origins(self, pos: torch.Tensor):
        """Each job's plane (0 Y, 1 Cb, 2 Cr) and its block's top-left sample."""
        pos = pos & (NARROW - 1)
        mb, n = pos // 6, pos % 6
        mx, my = mb % self.mb_w, mb // self.mb_w
        luma = n < 4
        x = torch.where(luma, 16 * mx + 8 * (n & 1), 8 * mx)
        y = torch.where(luma, 16 * my + 8 * (n >> 1), 8 * my)
        plane = torch.where(luma, torch.zeros_like(n), n - 3)
        return plane, x, y

    def planes(self, device) -> List[torch.Tensor]:
        return [torch.zeros((16 * self.mb_h, 16 * self.mb_w), dtype=torch.uint8, device=device)]\
            + [torch.zeros((8 * self.mb_h, 8 * self.mb_w), dtype=torch.uint8, device=device)
               for _ in range(2)]


def _blocks_of(plane: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Flat indices of the 8x8 blocks at (x, y) of ``plane``: (n, 8, 8)."""
    k = torch.arange(8, device=plane.device)
    return (y[:, None, None] + k[None, :, None]) * plane.shape[1] + x[:, None, None] + k[None, None, :]


def intra_plain(planes: List[torch.Tensor], coefs: torch.Tensor, jobs: torch.Tensor,
                layout: Layout, idct: str = "simple") -> None:
    """M1's plain version: each intra job's block, IDCT'd (``idct`` "simple"
    or "xvid") and saturated, put into ``planes`` (Y, Cb, Cr uint8, padded)
    in place."""
    if not len(jobs):
        return
    jobs = jobs.long()
    plane, x, y = layout.origins(jobs[:, 0])
    px = IDCTS[idct](coefs[jobs[:, 1]]).clamp(0, 255).to(torch.uint8)
    for p in range(3):
        sel = plane == p
        planes[p].view(-1)[_blocks_of(planes[p], x[sel], y[sel])] = px[sel]


def predict(ref: torch.Tensor, x: torch.Tensor, y: torch.Tensor, mvx: torch.Tensor,
            mvy: torch.Tensor, rounding: int, approx=False) -> torch.Tensor:
    """Half-pel prediction of 8x8 blocks at (x, y) moved by (mvx, mvy) half
    samples from ``ref`` (a padded plane), each position clamped to its
    edge: (n, 8, 8) int64. ``approx`` (a bool, or one a block broadcast to
    (n, 1, 1)) marks the blocks of FFmpeg's 8-wide functions."""
    h, w = ref.shape
    k = torch.arange(9, device=ref.device)
    rows = (y + (mvy >> 1))[:, None] + k
    cols = (x + (mvx >> 1))[:, None] + k
    patch = ref.long()[rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    a, b, c, d = patch[:, :8, :8], patch[:, :8, 1:], patch[:, 1:, :8], patch[:, 1:, 1:]
    hx, hy = (mvx & 1)[:, None, None].bool(), (mvy & 1)[:, None, None].bool()
    xy = (a + b + c + d + 2 - rounding) >> 2
    only_x = (a + b + 1 - rounding) >> 1
    only_y = (a + c + 1 - rounding) >> 1
    if rounding:  # MMXEXT's non-bitexact 8-wide no_rnd x2 and y2, where ``approx``
        odd = (torch.arange(8, device=ref.device) & 1).bool()[None, :, None]
        approx = torch.as_tensor(approx, device=ref.device)
        only_x = torch.where(approx, ((a - 1).clamp_min(0) + b + 1) >> 1, only_x)
        only_y = torch.where(approx, torch.where(odd, (a - 1).clamp_min(0) + c + 1,
                                                 a + (c - 1).clamp_min(0) + 1) >> 1, only_y)
    return torch.where(hx & hy, xy, torch.where(hx, only_x, torch.where(hy, only_y, a)))


def inter_plain(planes: List[torch.Tensor], ref: List[torch.Tensor], coefs: torch.Tensor,
                jobs: torch.Tensor, layout: Layout, rounding: int, idct: str = "simple") -> None:
    """M2's plain version: each inter job's prediction from ``ref`` plus its
    IDCT residual (where it has one), saturated, put into ``planes``."""
    if not len(jobs):
        return
    jobs = jobs.long()
    plane, x, y = layout.origins(jobs[:, 0])
    for p in range(3):
        sel = plane == p
        if not sel.any():
            continue
        j = jobs[sel]
        px = predict(ref[p], x[sel], y[sel], j[:, 2], j[:, 3], rounding,
                     approx=(j[:, 0] & NARROW).bool()[:, None, None])
        has = j[:, 1] >= 0
        if has.any():
            px[has] = px[has] + IDCTS[idct](coefs[j[has, 1]])
        planes[p].view(-1)[_blocks_of(planes[p], x[sel], y[sel])] = px.clamp(0, 255).to(torch.uint8)


def bidir_plain(planes: List[torch.Tensor], past: List[torch.Tensor], future: List[torch.Tensor],
                coefs: torch.Tensor, jobs: torch.Tensor, layout: Layout,
                idct: str = "simple") -> None:
    """M3's plain version: each B-VOP job's half-pel prediction (rounding 0)
    from ``past`` (forward), ``future`` (backward) or both, averaged as
    ``(f + b + 1) >> 1``, plus its IDCT residual (where it has one),
    saturated, put into ``planes``."""
    if not len(jobs):
        return
    jobs = jobs.long()
    plane, x, y = layout.origins(jobs[:, 0])
    for p in range(3):
        sel = plane == p
        if not sel.any():
            continue
        j = jobs[sel]
        f = predict(past[p], x[sel], y[sel], j[:, 2], j[:, 3], 0)
        b = predict(future[p], x[sel], y[sel], j[:, 4], j[:, 5], 0)
        dirs = j[:, 6][:, None, None]
        px = torch.where(dirs == 3, (f + b + 1) >> 1, torch.where(dirs == 1, f, b))
        has = j[:, 1] >= 0
        if has.any():
            px[has] = px[has] + IDCTS[idct](coefs[j[has, 1]])
        planes[p].view(-1)[_blocks_of(planes[p], x[sel], y[sel])] = px.clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------- #
# The card's route: the host C decoder, M1, M2 and M3
# --------------------------------------------------------------------------- #

#: ``sleap_mpeg4_decode_vop``'s error codes.
_HOST_ERRORS = {1: "an invalid code", 2: "the VOP's data ends inside a macroblock",
                3: "a block of more than 64 coefficients", 4: "a marker bit missing",
                5: "an escape after an escape",
                6: "a video packet header of another prefix or macroblock"}


class Staging:
    """Host buffers of the host decoder's output for ``macroblocks``
    macroblocks, reused across frames; pinned where ``pin``, and their
    copies to the card are synchronous. ``jobs`` holds M1's then M2's jobs
    of an I- or P-VOP, or (as (6 macroblocks, 8)) M3's of a B-VOP."""

    def __init__(self, macroblocks: int, pin: bool):
        n = 6 * macroblocks
        self.coefs = torch.empty((n, 64), dtype=torch.int16, pin_memory=pin)
        self.jobs = torch.empty((2, n, 4), dtype=torch.int32, pin_memory=pin)
        self.colocated = np.zeros((macroblocks, 9), np.int32)
        self.counts = np.zeros(4, np.int64)


def decode_macroblocks_host(data: bytes, vol: Vol, vop: Vop, staging: Staging,
                            colocated: Optional[np.ndarray] = None):
    """:func:`decode_macroblocks` in host C (``sleap_mpeg4_decode_vop``):
    (coefs, intra jobs, inter jobs) of an I- or P-VOP as views of
    ``staging``, with its co-located array (a copy); (coefs, M3 jobs) of a
    B-VOP, which reads the future reference's ``colocated``, with None."""
    from sleap_tpu_torch.ops import _build

    mb_w, mb_h = vol.mb_size
    n_mb = mb_w * mb_h
    if staging.coefs.shape[0] < 6 * n_mb:
        raise ValueError(f"MPEG-4: staging for {staging.coefs.shape[0] // 6} macroblocks, "
                         f"the VOP has {n_mb}")
    B = vop.kind == "B"
    if B and (colocated is None or colocated.shape != (n_mb, 9)):
        raise ValueError("MPEG-4: a B-VOP needs its future reference's co-located macroblocks")
    src = np.frombuffer(bytes(data) + bytes(8), np.uint8)
    mpeg_quant = vol.intra_matrix is not None
    params = np.array([mb_w, mb_h, "IPB".index(vop.kind), vop.quant, vop.f_code, vop.dc_threshold,
                       int(vol.resync), vop.bit, vol.width, vol.height, mpeg_quant,
                       *(vol.intra_matrix or (0,) * 64), *(vol.inter_matrix or (0,) * 64),
                       vol.quant_precision, vol.time_bits, vop.b_code, vop.pp_time,
                       vop.pb_time], np.int64)
    col_in = np.ascontiguousarray(colocated if B else staging.colocated, np.int32)
    err = _build.entry("sleap_mpeg4_decode_vop")(
        src.ctypes.data, len(data), params.ctypes.data, staging.coefs.data_ptr(),
        staging.jobs.data_ptr(), staging.counts.ctypes.data, col_in.ctypes.data,
        staging.colocated.ctypes.data)
    if err:
        raise ValueError(f"MPEG-4: {_HOST_ERRORS.get(err, err)} (sleap_mpeg4_decode_vop, "
                         f"macroblock {int(staging.counts[3])})")
    n_coefs, n_intra, n_inter = (int(c) for c in staging.counts[:3])
    if B:
        jobs = staging.jobs.view(-1)[:8 * 6 * n_mb].view(6 * n_mb, 8)
        return (staging.coefs[:n_coefs], jobs[:n_inter]), None
    return ((staging.coefs[:n_coefs], staging.jobs[0, :n_intra], staging.jobs[1, :n_inter]),
            staging.colocated[:n_mb].copy())


def _check_inputs(planes, refs, coefs, jobs, what):
    from sleap_tpu_torch.io import jpeg

    jpeg._check_card(coefs, torch.int16, "coefficients")
    jpeg._check_card(jobs, torch.int32, f"{what} jobs")
    for p in (*planes, *refs):
        jpeg._check_card(p, torch.uint8, "planes")


def _m1(xvid: int):
    def m1(planes: List[torch.Tensor], coefs: torch.Tensor, jobs: torch.Tensor,
           layout: Layout) -> None:
        from sleap_tpu_torch.ops import _build

        _check_inputs(planes, (), coefs, jobs, "M1")
        if not len(jobs):
            return
        _build.launch("sleap_mpeg4_intra", coefs.device.index, coefs.data_ptr(), jobs.data_ptr(),
                      len(jobs), layout.mb_w, xvid, *(p.data_ptr() for p in planes))
        m1.launches += 1

    m1.launches = 0
    return m1


def _m2(xvid: int):
    def m2(planes: List[torch.Tensor], ref: List[torch.Tensor], coefs: torch.Tensor,
           jobs: torch.Tensor, layout: Layout, rounding: int) -> None:
        from sleap_tpu_torch.ops import _build

        _check_inputs(planes, ref, coefs, jobs, "M2")
        if not len(jobs):
            return
        _build.launch("sleap_mpeg4_inter", coefs.device.index, coefs.data_ptr(), jobs.data_ptr(),
                      len(jobs), layout.mb_w, layout.mb_h, rounding, xvid,
                      *(p.data_ptr() for p in (*ref, *planes)))
        m2.launches += 1

    m2.launches = 0
    return m2


def _m3(xvid: int):
    def m3(planes: List[torch.Tensor], past: List[torch.Tensor], future: List[torch.Tensor],
           coefs: torch.Tensor, jobs: torch.Tensor, layout: Layout) -> None:
        from sleap_tpu_torch.ops import _build

        _check_inputs(planes, (*past, *future), coefs, jobs, "M3")
        if not len(jobs):
            return
        _build.launch("sleap_mpeg4_bidir", coefs.device.index, coefs.data_ptr(), jobs.data_ptr(),
                      len(jobs), layout.mb_w, layout.mb_h, xvid,
                      *(p.data_ptr() for p in (*past, *future, *planes)))
        m3.launches += 1

    m3.launches = 0
    return m3


#: M1 (``mpeg4_intra_kernel``), M2 (``mpeg4_inter_kernel``) and M3
#: (``mpeg4_bidir_kernel``) on the card, each in its simple-IDCT and its
#: Xvid-IDCT instantiation: :func:`intra_plain`, :func:`inter_plain` and
#: :func:`bidir_plain` on CUDA tensors. Each counts its launches.
intra_cuda, intra_xvid_cuda = _m1(0), _m1(1)
inter_cuda, inter_xvid_cuda = _m2(0), _m2(1)
bidir_cuda, bidir_xvid_cuda = _m3(0), _m3(1)
for _fn, _name in ((intra_cuda, "intra_cuda"), (intra_xvid_cuda, "intra_xvid_cuda"),
                   (inter_cuda, "inter_cuda"), (inter_xvid_cuda, "inter_xvid_cuda"),
                   (bidir_cuda, "bidir_cuda"), (bidir_xvid_cuda, "bidir_xvid_cuda")):
    _fn.__name__ = _fn.__qualname__ = _name

#: (M2, M1, M3) by IDCT, as :func:`reconstruct` takes them: the card's
#: wrappers and their plain versions.
CARD = {"simple": (inter_cuda, intra_cuda, bidir_cuda),
        "xvid": (inter_xvid_cuda, intra_xvid_cuda, bidir_xvid_cuda)}
PLAIN = {idct: (functools.partial(inter_plain, idct=idct), functools.partial(intra_plain, idct=idct),
                functools.partial(bidir_plain, idct=idct)) for idct in IDCTS}


def _no_lap(stage: str) -> None:
    pass


def entropy_decode(data: bytes, vol: Vol, vop: Vop, device: torch.device,
                   staging: Optional[Staging] = None, lap: Callable[[str], None] = _no_lap,
                   colocated: Optional[np.ndarray] = None):
    """A coded VOP's macroblocks (``vop`` the headers a :class:`Stream`
    parsed from ``data``; a B-VOP's ``colocated`` its future reference's)
    on ``device``: (inputs, colocated), the inputs (coefficients, intra
    jobs, inter jobs) of an I- or P-VOP with its co-located array, or
    (coefficients, M3 jobs) of a B-VOP with None. On the card the host C
    decoder fills ``staging`` (sized to the VOP's macroblocks) and the
    arrays are copied up; on the CPU the plain decoder runs. ``lap(stage)``
    is called as "entropy" and "upload" end."""
    if device.type != "cuda":
        mbs = decode_macroblocks(data, vol, vop, colocated)
        lap("entropy")
        arrays = (mbs.coefs, mbs.bidir) if vop.kind == "B" else (mbs.coefs, mbs.intra, mbs.inter)
        return tuple(torch.from_numpy(a) for a in arrays), mbs.colocated
    host, colocated = decode_macroblocks_host(data, vol, vop, staging, colocated)
    lap("entropy")
    inputs = tuple(t.to(device) for t in host)
    lap("upload")
    return inputs, colocated


def reconstruct(inputs, layout: Layout, ref, rounding: int, kernels=None,
                lap: Callable[[str], None] = _no_lap, idct: str = "simple") -> List[torch.Tensor]:
    """A VOP's planes (Y, Cb, Cr, padded) from :func:`entropy_decode`'s
    ``inputs``: an I- or P-VOP's from the previous reference's planes
    ``ref`` (None where there is none of this size), M2 then M1 over M2's
    output; a B-VOP's (two inputs) from ``ref`` = (past, future) planes,
    M3. ``kernels`` is an (M2, M1, M3) triple, by default ``CARD[idct]``
    for tensors on the card and ``PLAIN[idct]`` on the CPU. ``lap(stage)``
    is called as "M2", "M1" or "M3" end."""
    coefs = inputs[0]
    planes = layout.planes(coefs.device)
    m2, m1, m3 = kernels or (CARD if coefs.device.type == "cuda" else PLAIN)[idct]
    if len(inputs) == 2:
        m3(planes, *ref, coefs, inputs[1], layout)
        lap("M3")
        return planes
    if ref is None or [p.shape for p in ref] != [p.shape for p in planes]:
        ref = planes
    m2(planes, ref, coefs, inputs[2], layout, rounding)
    lap("M2")
    m1(planes, coefs, inputs[1], layout)
    lap("M1")
    return planes


# --------------------------------------------------------------------------- #
# The reader
# --------------------------------------------------------------------------- #


def first_difference(got: np.ndarray, want: np.ndarray) -> Optional[Tuple[int, int]]:
    """The first macroblock (column, row) where two frames (H, W[, C])
    differ, in decoding order; None where they are equal. An error drifts
    through a GOP, so its first macroblock is where to look."""
    diff = np.asarray(got) != np.asarray(want)
    if diff.ndim == 3:
        diff = diff.any(2)
    if not diff.any():
        return None
    h, w = diff.shape
    mbs = np.zeros(((h + 15) // 16, (w + 15) // 16), bool)
    ys, xs = np.nonzero(diff)
    mbs[ys // 16, xs // 16] = True
    row, col = np.argwhere(mbs)[0]
    return int(col), int(row)


#: FFmpeg's ``MAX_NVOP_SIZE``: a packet this short after a packed VOP is a
#: placeholder.
MAX_NVOP_SIZE = 19


@dataclass
class Unit:
    """A VOP the decoder decodes, in decoding order: its bytes start at
    ``offset`` of packet ``packet`` (a packed bitstream's second VOP: past
    the first one), its kind, VOL and IDCT, and the units of its
    references (a B-VOP's past and future; an I- or P-VOP's previous
    reference, -1 where none), with a B-VOP's ``pp_time`` and ``pb_time``."""

    packet: int
    offset: int
    kind: str
    vol: Vol
    idct: str
    past: int = -1
    future: int = -1
    pp_time: int = 0
    pb_time: int = 0


class Schedule:
    """FFmpeg's MPEG-4 decode loop (``ff_h263_decode_frame`` with
    ``decode_vop_header``'s timing and ``ff_mpeg4_frame_end``'s packed
    bitstream) run on the headers alone: which VOPs are decoded
    (:attr:`units`) and which of them each frame cv2 reads in order is
    (:attr:`frames`). Per packet: a packed VOP kept from the last packet
    is decoded in its place (dropped where the packet starts a visual
    object sequence); a not-coded VOP, or a B-VOP out of time order
    (``pb_time`` not inside ``pp_time``), is skipped, a B-VOP without a past
    reference dropped; an I- or P-VOP makes the future reference the past
    one. The frame out: a B-VOP's own, or every VOP's while ``low_delay``,
    else the past reference. ``low_delay`` is the VOL's control-parameter
    bit, else set for Simple and Advanced Simple VOLs before the first
    picture (and for an unnamed encoder's object type 0), cleared at the
    first B-VOP of a VOL without control parameters. At the end the future
    reference comes out where ``low_delay`` is clear or the stream ended in
    a skipped VOP (then once more, where it came out already).
    ``packet(k)`` gives packet ``k`` of ``count``."""

    def __init__(self, packet: Callable[[int], bytes], count: int, fourcc: str = "",
                 config: bytes = b""):
        self._packet, self.count = packet, count
        self.stream = Stream(fourcc)
        self.units: List[Unit] = []
        self.frames: List[int] = []
        self._next = 0  # the next packet
        self._done = False
        self._saved: Optional[Tuple[int, int]] = None  # a packed VOP: (packet, offset)
        self._last = self._future = -1
        self._low_delay = 1
        self._pictures = 0
        self._time_base = self._last_time_base = self._last_non_b = self._pp = 0
        self._skipped_last = False
        if config:
            self._headers(config)

    def _headers(self, data: bytes) -> Optional[Vop]:
        stream, vol = self.stream, self.stream.vol
        vop = stream.headers(data)
        if stream.vol is not vol:  # a VOL header
            v = stream.vol
            if v.control_parameters:
                self._low_delay = v.low_delay
            elif not self._pictures:
                self._low_delay = int(v.vo_type in (1, 17))
        if stream.gov_seconds is not None:
            self._time_base = stream.gov_seconds
        return vop

    def until(self, frames: int) -> None:
        """Run until ``frames`` frames are out or the stream ends."""
        while len(self.frames) < frames and not self._done:
            if self._next < self.count:
                self._step(self._next)
                self._next += 1
            else:
                self._flush()

    def _flush(self) -> None:
        if (not self._low_delay or self._skipped_last) and self._future >= 0:
            self.frames.append(self._future)
        self._done = True

    def _step(self, k: int) -> None:
        data = self._packet(k)
        enc = self.stream.encoder
        if self._saved is not None and enc.divx_packed:
            first = _start_codes(data)
            if first and data[first[0]] == 0xB0:
                self._saved = None  # FFmpeg: "Discarding excessive bitstream in packed xvid"
        src, self._saved = (self._saved or (k, 0)), None
        buf = self._packet(src[0])[src[1]:] if src[0] != k else data[src[1]:]
        vop = self._headers(buf)
        if vop is None:
            return
        vol = self.stream.vol
        B = vop.coding == "B"
        if B and self._low_delay and not vol.control_parameters:
            self._low_delay = 0
        # decode_vop_header's clock: a B-VOP's from the past reference's base.
        res = vol.resolution
        if not B:
            self._last_time_base = self._time_base
            self._time_base += vop.modulo
            time = self._time_base * res + vop.time
            self._pp = time - self._last_non_b
            self._last_non_b = time
        else:
            time = (self._last_time_base + vop.modulo) * res + vop.time
            pb = self._pp - (self._last_non_b - time)
            if self._pp <= pb or self._pp <= self._pp - pb or self._pp <= 0:
                self._skipped_last = True  # FRAME_SKIPPED
                return
            vop.pp_time, vop.pb_time = self._pp, pb
        if vop.kind == "N":
            self._skipped_last = True
            return
        if not vol.vo_type and not vol.control_parameters and enc.divx_version < 0 \
                and not self._pictures:
            self._low_delay = 1  # FFmpeg's guess: DivX 4, old Xvid or OpenDivX
        self._pictures += 1
        self._skipped_last = False
        if B and self._last < 0:
            return  # no past reference: FFmpeg skips the B-VOP
        u = len(self.units)
        unit = Unit(src[0], src[1], vop.kind, vol, self.stream.idct)
        if B:
            unit.past, unit.future = self._last, self._future
            unit.pp_time, unit.pb_time = vop.pp_time, vop.pb_time
        else:
            self._last, self._future = self._future, u
            unit.past = self._last
        self.units.append(unit)
        if enc.divx_packed:  # ff_mpeg4_frame_end: keep a packed I- or B-VOP
            at = data.find(b"\x00\x00\x01\xb6", 0 if src[0] != k else src[1] + self.stream.vop_at)
            if at >= 0 and at + 4 < len(data) and not data[at + 4] & 0x40:
                self._saved = (k, at)
        if B or self._low_delay:
            self.frames.append(u)
        elif self._last >= 0:
            self.frames.append(self._last)


def unit_header(stream: Stream, unit: Unit, data: bytes) -> Vop:
    """The VOP header of ``unit`` from its bytes ``data`` (the packet from
    its offset), read by ``stream`` under the VOL the schedule saw before
    it, with a B-VOP's times."""
    stream.vol = unit.vol
    vop = stream.headers(data)
    if vop is None or vop.kind != unit.kind:
        raise ValueError(f"MPEG-4: packet {unit.packet} holds no {unit.kind}-VOP")
    vop.pp_time, vop.pb_time = unit.pp_time, unit.pb_time
    return vop


def scheduled_vops(packets: Sequence[bytes], fourcc: str = ""):
    """Every VOP FFmpeg decodes of a stream's ``packets`` (decoding order):
    (its unit index, :class:`Unit`, bytes, :func:`unit_header`) each."""
    schedule = Schedule(lambda k: packets[k], len(packets), fourcc)
    schedule.until(len(packets) + 2)
    stream = Stream(fourcc)
    for u, unit in enumerate(schedule.units):
        data = packets[unit.packet][unit.offset:]
        yield u, unit, data, unit_header(stream, unit, data)


class Mpeg4Reader:
    """Frames of a demuxer whose packets are MPEG-4 Part 2 VOPs, as OpenCV's
    FFmpeg backend gives them, on ``device``: an AVI
    (:class:`~sleap_tpu_torch.io.avi.AviVideo`), ISO-BMFF
    (:class:`~sleap_tpu_torch.io.mp4.Mp4Video`) or Matroska
    (:class:`~sleap_tpu_torch.io.mkv.MkvVideo`) track (packets in decoding
    order, presentation frame ``i`` its packet ``order[i]``; B-VOPs there
    raise). ``config`` is the container's VOL bytes (``esds``,
    ``CodecPrivate``); ``fourcc`` the AVI's tag. On the card the host C
    decoder, M1, M2 and M3 run; on the CPU the plain versions. Frame ``i``
    is the ``i``-th frame of cv2's sequential read, as :class:`Schedule`
    finds it, scanning the packets' headers as far as a read reaches. The
    two references stay on the device: a read decodes on from the last one
    where no I-VOP lies between, else from the I-VOP at or before the
    reference it needs (a B-VOP: its past one), through its future one.
    Thread-safe."""

    def __init__(self, demux, device="cuda", config: bytes = b"", fourcc: str = ""):
        self.demux = demux
        self.device = torch.device(device)
        self._config, self._fourcc = config, fourcc
        self._f = open(demux.filename, "rb")
        self._lock = threading.RLock()
        self._sequence = demux.order if hasattr(demux, "order") else range(len(demux.offsets))
        self._peeked: Tuple[int, bytes] = (-1, b"")
        self.schedule = Schedule(self._ordered_packet, len(self._sequence), fourcc, config)
        self._stream = Stream(fourcc, config)
        # The references decoded: chain position -> (planes, co-located), the
        # last two; the last B-VOP decoded: (unit, planes).
        self._chain: List[int] = []  # the I- and P-VOP units, in decoding order
        self._chain_pos: Dict[int, int] = {}
        self._refs: Dict[int, Tuple[List[torch.Tensor], np.ndarray]] = {}
        self._pos: Optional[int] = None  # the chain position of the last reference decoded
        self._b: Tuple[int, Optional[List[torch.Tensor]]] = (-1, None)
        self._staging: Optional[Staging] = None
        self._t0 = 0.0
        #: Seconds a stage (host clock; the card's stages synchronised) and
        #: VOPs decoded, where ``timing`` is a dict.
        self.timing: Optional[Dict[str, float]] = None
        self.schedule.until(1)
        vol = self.schedule.stream.vol
        if vol is None:
            raise ValueError(f"{demux.filename}: no MPEG-4 VOL header before the first VOP")
        self.width, self.height = vol.width, vol.height

    @property
    def _track(self) -> bool:
        return hasattr(self.demux, "order")

    def _packet(self, k: int) -> bytes:
        if self._peeked[0] == k:
            return self._peeked[1]
        data = self.demux.read_packet(self._f, k) if self._track else self.demux.read(self._f, k)
        self._peeked = (k, data)
        return data

    def _ordered_packet(self, k: int) -> bytes:
        return self._packet(int(self._sequence[k]))

    def _frame_unit(self, i: int) -> int:
        """The unit of frame ``i``, the packets scanned as far as it."""
        self.schedule.until(i + 1)
        if not 0 <= i < len(self.schedule.frames):
            raise KeyError(f"Unable to load frame {i} from {self.demux.filename}.")
        return self.schedule.frames[i]

    def _frame_packet(self, i: int) -> int:
        """The packet frame ``i`` is decoded from."""
        return self.schedule.units[self._frame_unit(i)].packet

    def frame(self, i: int, channels: str = "bgr") -> torch.Tensor:
        """Frame ``i``, (H, W, C) uint8 on the device: ``channels`` "bgr",
        "rgb" or "b" (the blue channel alone)."""
        with self._lock:
            u = self._frame_unit(i)
            unit = self.schedule.units[u]
            if unit.kind == "B":
                if self._track:
                    raise unsupported("MPEG-4 B-VOPs in an ISO-BMFF or Matroska track")
                if self._b[0] != u:
                    self._to_reference(unit.future, unit.past)
                    self._b = (u, self._decode(u))
                y, v, w = self._b[1]
            else:
                self._to_reference(u, -1)
                y, v, w = self._refs[self._pos][0]
            return self._convert(y, v, w, channels)

    def _chain_of(self, u: int) -> int:
        units = self.schedule.units
        while len(self._chain) < len(units) and (not self._chain or self._chain[-1] < u):
            k = self._chain[-1] + 1 if self._chain else 0
            while k < len(units) and units[k].kind == "B":
                k += 1
            if k >= len(units):
                break
            self._chain_pos[k] = len(self._chain)
            self._chain.append(k)
        return self._chain_pos[u]

    def _to_reference(self, u: int, past: int) -> None:
        """Decode the references on to unit ``u``, keeping the one before it
        (``past``, where not -1)."""
        target = self._chain_of(u)
        need = self._chain_of(past) if past >= 0 else target
        units = self.schedule.units
        key = next(c for c in range(need, -1, -1) if units[self._chain[c]].kind == "I")
        have = self._pos is not None and key <= self._pos <= target and \
            (self._pos < target or need == target or need in self._refs)
        for c in range(self._pos + 1 if have else key, target + 1):
            prev = self._refs.get(c - 1)
            planes, colocated = self._decode(self._chain[c], prev[0] if prev else None)
            self._refs = {k: v for k, v in self._refs.items() if k == c - 1}
            self._refs[c] = (planes, colocated)
            self._pos = c

    def _convert(self, y, u, v, channels: str) -> torch.Tensor:
        h, w = self.height, self.width
        self._start()
        out = yuv.to_bgr(y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2], "420", False,
                         channels)
        self._lap("to_bgr")
        return out

    def _clock(self) -> float:
        import time

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _start(self) -> None:
        if self.timing is not None:
            self._t0 = self._clock()

    def _lap(self, stage: str) -> None:
        """Ends ``stage``: its seconds since the last start or lap (host
        clock, the card synchronised), where ``timing`` is kept."""
        if self.timing is not None:
            now = self._clock()
            self.timing[stage] = self.timing.get(stage, 0.0) + now - self._t0
            self._t0 = now

    def _decode(self, u: int, ref: Optional[List[torch.Tensor]] = None):
        """Decode unit ``u``: a B-VOP's planes from the references held, or
        an I- or P-VOP's (planes, co-located) from ``ref``."""
        unit = self.schedule.units[u]
        self._start()
        data = self._ordered_packet(unit.packet)[unit.offset:]
        self._lap("demux")
        vop = unit_header(self._stream, unit, data)
        vol = self._stream.vol
        layout = Layout(*vol.mb_size)
        n = layout.mb_w * layout.mb_h
        if self.device.type == "cuda" and (self._staging is None or self._staging.coefs.shape[0] != 6 * n):
            self._staging = Staging(n, pin=True)
        if unit.kind == "B":
            past, future = (self._refs[self._pos - 1][0], self._refs[self._pos][0])
            inputs, _ = entropy_decode(data, vol, vop, self.device, self._staging, self._lap,
                                       self._refs[self._pos][1])
            out = reconstruct(inputs, layout, (past, future), 0, lap=self._lap, idct=unit.idct)
        else:
            if vop.kind == "P" and ref is None:
                raise ValueError(f"{self.demux.filename}: a P-VOP (packet {unit.packet}) without "
                                 f"its reference")
            inputs, colocated = entropy_decode(data, vol, vop, self.device, self._staging, self._lap)
            out = (reconstruct(inputs, layout, ref, vop.rounding, lap=self._lap, idct=unit.idct),
                   colocated)
        if self.timing is not None:
            self.timing["vops"] = self.timing.get("vops", 0) + 1
        return out

    def close(self) -> None:
        self._f.close()
