#!/usr/bin/env python3
"""Write MPEG-4 Part 2 streams that exercise every syntax path the port's
decoder (``sleap_tpu_torch/io/mpeg4.py``) takes, with no encoder: test
support for its CPU tests and ``chip_smoke.py`` phase 26.

OpenCV's encoder (libavcodec) never writes some of what the decoder must
read: ``intra_dc_vlc_thr`` above 0 (intra DC coded as a TCOEF), every TCOEF
escape type, DQUANT on every kind of macroblock, AC prediction across
macroblocks of different quantisers, motion vectors at every ``f_code`` and
their wrap, MCBPC stuffing, 4MV macroblocks (with the odds ``mv4``; with
DQUANT they take H.263's MCBPC codes 24-27, which FFmpeg reads), MPEG
quantisation (``quant_type`` 1, default or loaded matrices), video packets
(resync markers, with the odds ``packet``; header extensions and new
quantisers among them), not-coded VOPs (a packet of their own before a
P-VOP, with the odds ``nvop``). This writer draws the syntax elements themselves
from a seed: macroblock modes, coded block patterns, DC differentials,
run-levels (table codes and the three escapes), vector differences. Nothing
is predicted or reconstructed here: the stream is valid by construction
(the writer tracks the quantiser as a decoder does, since it decides how the
intra DC is coded, and keeps every block's coefficients inside 64
positions), and what it decodes to is whatever FFmpeg decodes, which the
tests record with cv2. The pictures are noise, saturated in places; that is
a test too.

The stream is rectangular 8-bit 4:2:0, Simple Profile, one VOL in-band
before each I-VOP (as libavcodec writes it into AVI), no user data unless
``--user-data`` is given, in an AVI of one video stream whose ``idx1`` flags
the I-VOPs as key frames (so cv2's seeks land on them).

With ``--bframes N`` the stream holds B-VOPs (:func:`bstream`): every
MB_TYPE, direct mode over one- and four-vector, skipped and intra
co-located macroblocks with and without deltas, DBQUANT, GOV headers
(``--gov``), the VOL's ``low_delay`` bit (``--low-delay``), and DivX's
packed bitstream (``--packed``); :func:`coefficient_vop` writes intra VOPs
of chosen coefficients, the fixtures that hold an IDCT to FFmpeg's.

    python3 scripts/write_mpeg4_fixture.py OUT.avi [--width 64] [--height 48]
        [--frames 16] [--gop 6] [--seed 0] [--fourcc FMP4] [--user-data TEXT ...]
        [--bframes N] [--packed] [--gov open|closed|broken] [--low-delay 0|1]
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
from typing import List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from sleap_tpu_torch.io import mpeg4  # noqa: E402  (its tables)


class BitWriter:
    """Big-endian bits."""

    def __init__(self):
        self.bits: List[str] = []

    def u(self, n: int, value: int) -> None:
        if n:
            self.bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def code(self, table: Sequence, index: int) -> None:
        code, n = table[index]
        self.u(n, code)

    def start(self, code: int) -> None:
        """Stuffing to the next byte ('0' then '1's) after what came before,
        then a start code."""
        if self.bits:
            self.stuff()
        self.u(32, 0x100 | code)

    def stuff(self) -> None:
        n = len("".join(self.bits))
        self.u(1, 0)
        self.u((-(n + 1)) % 8, 0xFF)

    def bytes(self) -> bytes:
        bits = "".join(self.bits)
        assert len(bits) % 8 == 0
        return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def vol_headers(w: BitWriter, width: int, height: int, resolution: int, **vol) -> None:
    """VOS, VO, video object and VOL headers: Simple Profile, version 1,
    rectangular, 8-bit, H.263 quantisation, no resync markers. ``vol``
    sets what the decoder must refuse, for its tests: ``vo_type``,
    ``ver_id`` (2 adds quarter_sample, NEWPRED and reduced-resolution bits),
    ``chroma_format`` and ``low_delay`` (with VOL control parameters), ``shape``,
    ``interlaced``, ``sprite``, ``bits`` (not_8_bit), ``quant_type`` (1:
    MPEG quantisation, with ``intra_matrix`` and ``inter_matrix`` loaded
    where given: up to 64 values in zigzag order, a 0 ending them early),
    ``quarter_sample``, ``complexity`` (estimation headers on), ``resync``,
    ``data_partitioned``, ``newpred``, ``reduced_res``, ``scalability``,
    ``video_range``."""
    ver_id = vol.get("ver_id", 1)
    w.start(0xB0)
    w.u(8, 0x03)  # simple profile, level 3
    w.start(0xB5)
    w.u(1, 0)  # is_visual_object_identifier
    w.u(4, 1)  # video
    if "video_range" in vol:
        w.u(1, 1)  # video_signal_type
        w.u(3, 5)  # video_format: unspecified
        w.u(1, vol["video_range"])
        w.u(1, 0)  # colour_description
    else:
        w.u(1, 0)
    w.start(0x00)
    w.start(0x20)
    w.u(1, 0)  # random_accessible_vol
    w.u(8, vol.get("vo_type", 1))
    if ver_id != 1:
        w.u(1, 1)  # is_object_layer_identifier
        w.u(4, ver_id)
        w.u(3, 1)  # priority
    else:
        w.u(1, 0)
    w.u(4, 1)  # square pixels
    if "chroma_format" in vol or "low_delay" in vol:
        w.u(1, 1)  # vol_control_parameters
        w.u(2, vol.get("chroma_format", 1))
        w.u(1, vol.get("low_delay", 1))
        w.u(1, 0)  # vbv_parameters
    else:
        w.u(1, 0)
    w.u(2, vol.get("shape", 0))
    w.u(1, 1)
    w.u(16, resolution)
    w.u(1, 1)
    w.u(1, 0)  # fixed_vop_rate
    w.u(1, 1)
    w.u(13, width)
    w.u(1, 1)
    w.u(13, height)
    w.u(1, 1)
    w.u(1, vol.get("interlaced", 0))
    w.u(1, 1)  # obmc_disable
    w.u(1 if ver_id == 1 else 2, vol.get("sprite", 0))
    if "bits" in vol:
        w.u(1, 1)  # not_8_bit
        w.u(4, 5)  # quant_precision
        w.u(4, vol["bits"])
    else:
        w.u(1, 0)
    w.u(1, vol.get("quant_type", 0))
    if vol.get("quant_type"):
        for matrix in (vol.get("intra_matrix"), vol.get("inter_matrix")):
            w.u(1, matrix is not None)  # load_*_quant_mat
            for v in matrix or ():
                w.u(8, v)
    if ver_id != 1:
        w.u(1, vol.get("quarter_sample", 0))
    w.u(1, 0 if vol.get("complexity") else 1)  # complexity_estimation_disable
    w.u(1, 0 if vol.get("resync") else 1)  # resync_marker_disable
    w.u(1, vol.get("data_partitioned", 0))
    if vol.get("data_partitioned"):
        w.u(1, 0)  # reversible_vlc
    if ver_id != 1:
        w.u(1, vol.get("newpred", 0))
        w.u(1, vol.get("reduced_res", 0))
    w.u(1, vol.get("scalability", 0))


#: How often each syntax path is drawn.
ODDS = {"gray": False, "mv4": 0.0, "packet": 0.0, "nvop": 0.0, "residual": 0.8, "stuffing": 0.02, "dquant": 0.2, "skip": 0.2, "intra": 0.12, "last": 0.3,
        "modb1": 0.15, "btypes": (0.3, 0.3, 0.2, 0.2), "bad_time": 0.0, "dc_overflow": 0.0,
        "escapes": (0.8, 0.07, 0.07, 0.06), "thresholds": tuple(range(8)),
        "dc_sizes": (0.2, 0.15, 0.15, 0.12, 0.1, 0.08, 0.07, 0.05, 0.04, 0.02, 0.02)}


class Writer:
    """Random syntax elements, drawn from ``rng`` at ``odds``."""

    def __init__(self, rng: np.random.Generator, mb_w: int, mb_h: int, odds=None):
        self.rng, self.mb_w, self.mb_h = rng, mb_w, mb_h
        self.odds = {**ODDS, **(odds or {})}
        tables = {}
        for intra in (True, False):
            run, level, last_from = ((mpeg4.INTRA_RUN, mpeg4.INTRA_LEVEL, mpeg4.INTRA_LAST) if intra
                                     else (mpeg4.INTER_RUN, mpeg4.INTER_LEVEL, mpeg4.INTER_LAST))
            tables[intra] = [(k, int(k >= last_from), run[k], level[k]) for k in range(len(run))]
        self.entries = tables

    def chance(self, p: float) -> bool:
        return bool(self.rng.random() < p)

    def tcoef(self, w: BitWriter, i: int, intra: bool, q: int, first: int = 0,
              skip: bool = False) -> None:
        """At least one run-level from scan position ``i + 1``, the last one
        flagged, none past position 63; ``first``, where not 0, is the level
        of the first (at run 0); with ``skip`` the first has a run of 1 or
        more. Third escapes keep their dequantised level inside 12 bits, as
        the standard's saturation leaves it."""
        vlc = mpeg4.INTRA_VLC if intra else mpeg4.INTER_VLC
        max_level, max_run = ((mpeg4.INTRA_MAX_LEVEL, mpeg4.INTRA_MAX_RUN) if intra else
                              (mpeg4.INTER_MAX_LEVEL, mpeg4.INTER_MAX_RUN))
        cap = (2047 - ((q - 1) | 1)) // (2 * q)
        while True:
            room_more = 61 - i  # the largest run of a coefficient that is not last
            last = int(room_more < 0 or self.chance(self.odds["last"]))
            room = 62 - i if last else room_more
            kind = int(self.rng.choice(4, p=self.odds["escapes"]))
            if first:
                table = [e for e in self.entries[intra]
                         if (e[1], e[2], e[3]) == (last, 0, abs(first))]
                kind = 0 if table else 3
            if kind == 3:  # escape 3: fixed length
                run = 0 if first else int(self.rng.integers(int(skip), min(room, 63) + 1))
                level = first or int(self.rng.choice((self.rng.integers(-40, 41),
                                                      self.rng.integers(-cap, cap + 1))))
                level = max(min(level or 1, cap), -cap) if not first else level
                w.code(vlc, mpeg4.ESCAPE)
                w.u(2, 3)
                w.u(1, last), w.u(6, run), w.u(1, 1), w.u(12, level), w.u(1, 1)
            else:
                def fits(e):
                    _, elast, erun, elevel = e
                    if elast != last or (skip and not erun):
                        return False
                    if kind == 2:
                        erun += max_run[elast][elevel] + 1
                    return erun <= room
                choices = table if first else [e for e in self.entries[intra] if fits(e)]
                if not choices:  # no escape 2 fits: a table code of run 0 (1) always does
                    kind, choices = 0, [e for e in self.entries[intra]
                                        if e[1] == last and e[2] == int(skip)]
                k, _, run, lev = choices[int(self.rng.integers(len(choices)))]
                if kind == 1:
                    w.code(vlc, mpeg4.ESCAPE)
                    w.u(1, 0)
                elif kind == 2:
                    w.code(vlc, mpeg4.ESCAPE)
                    w.u(2, 2)
                    run += max_run[last][lev] + 1
                w.code(vlc, k)
                w.u(1, int(first < 0) if first else int(self.chance(0.5)))
            first, skip = 0, False
            i += run + 1
            if last:
                return

    def dc_diff(self, pred: int, scale: int) -> int:
        """A DC difference drawn at the odds of its size, kept where the DC
        stays inside 0-2047 (FFmpeg refuses it below), or, at the odds
        ``dc_overflow``, up to 40 levels above (the stored DC FFmpeg clips
        to 2047, but for old Xvid builds)."""
        sizes = self.odds["dc_sizes"]
        size = int(self.rng.choice(len(sizes), p=sizes))
        diff = 0 if not size else int(self.rng.integers(1 << (size - 1), 1 << size)) * \
            (1 if self.chance(0.5) else -1)
        if self.odds["dc_overflow"] and self.chance(self.odds["dc_overflow"]):
            return 2047 // scale - pred + int(self.rng.integers(1, 41))
        return min(max(diff, -pred), 2047 // scale - pred)

    def intra_mb(self, w: BitWriter, cbpc: int, dquant: bool, q: int, threshold: int,
                 mb_x: int, mb_y: int) -> int:
        """The rest of an intra macroblock after its MCBPC; the new quantiser."""
        ac_pred = int(self.chance(0.5))
        w.u(1, ac_pred)
        cbpy = int(self.rng.integers(16))
        w.code(mpeg4.CBPY, cbpy)
        use_dc_vlc = q < mpeg4.DC_THRESHOLD[threshold]
        if dquant:
            d = int(self.rng.integers(4))
            w.u(2, d)
            q = min(max(q + mpeg4.DQUANT[d], 1), 31)
        cbp = (cbpc & 3) | (cbpy << 2)
        gray = self.odds["gray"]
        for n in range(6):
            coded = cbp & (32 >> n)
            grid, k, step = self.cell(n, mb_x, mb_y)
            scale = (mpeg4.Y_DC_SCALE if n < 4 else mpeg4.C_DC_SCALE)[q]
            a, b, c = grid[k - 1], grid[k - 1 - step], grid[k - step]
            if self.first_line and n != 3:  # neighbours outside the video packet
                if n != 2:
                    b = c = 1024
                if n != 1 and mb_x == self.resync[0]:
                    b = a = 1024
            if (mb_x, mb_y) == (self.resync[0], self.resync[1] + 1) and n in (0, 4, 5):
                b = 1024
            pred = ((c if abs(a - b) < abs(b - c) else a) + (scale >> 1)) // scale
            diff = self.dc_diff(pred, scale) if (use_dc_vlc or coded) and not (gray and n > 3) else 0
            grid[k] = min((pred + diff) * scale, 2047)
            if use_dc_vlc:
                size = abs(diff).bit_length()
                w.code(mpeg4.DC_LUM if n < 4 else mpeg4.DC_CHROM, size)
                if size:
                    w.u(size, diff if diff > 0 else diff + (1 << size) - 1)
                    if size > 8:
                        w.u(1, 1)
                if coded:
                    self.tcoef(w, 0, True, q)
            elif coded:
                self.tcoef(w, -1, True, q, diff, skip=not diff)
        return q

    def cell(self, n: int, mb_x: int, mb_y: int):
        """The DC grid, index and row step of block ``n`` of a macroblock."""
        if n < 4:
            lw = 2 * self.mb_w + 1
            return self.dc[0], (2 * mb_y + (n >> 1) + 1) * lw + 2 * mb_x + (n & 1) + 1, lw
        cw = self.mb_w + 1
        return self.dc[n - 3], (mb_y + 1) * cw + mb_x + 1, cw

    def motion(self, w: BitWriter, f_code: int) -> None:
        code = int(self.rng.choice((self.rng.integers(0, 4), self.rng.integers(0, 33))))
        w.code(mpeg4.MVD, code)
        if code:
            w.u(1, int(self.chance(0.5)))
            w.u(f_code - 1, int(self.rng.integers(1 << (f_code - 1))))

    def vop(self, w: BitWriter, kind: str, time_bits: int, t: int, rounding: int,
            modulo: int = 0) -> None:
        """A VOP: its header (``modulo`` seconds of ``modulo_time_base``),
        each macroblock, a video packet header (at the odds ``packet``, where
        the VOL enables resync markers) between macroblocks. A P-VOP's
        skipped macroblocks are kept in :attr:`skipped` (an I-VOP's none),
        for the B-VOPs that follow it."""
        threshold = int(self.rng.choice(self.odds["thresholds"]))
        q = int(self.rng.integers(1, 5 if self.odds["gray"] else 32))
        f_code = int(self.rng.integers(1, 8)) if kind == "P" else 1
        self.skipped = [False] * (self.mb_w * self.mb_h)
        w.start(0xB6)
        w.u(2, kind == "P")
        w.u(modulo + 1, (1 << (modulo + 1)) - 2)  # modulo_time_base
        w.u(1, 1)
        w.u(time_bits, t)
        w.u(1, 1)
        w.u(1, 1)  # vop_coded
        if kind == "P":
            w.u(1, rounding)
        w.u(3, threshold)
        w.u(5, q)
        if kind == "P":
            w.u(3, f_code)
        lw, cw = 2 * self.mb_w + 1, self.mb_w + 1
        self.dc = [[1024] * ((2 * self.mb_h + 1) * lw), [1024] * ((self.mb_h + 1) * cw),
                   [1024] * ((self.mb_h + 1) * cw)]
        self.resync, self.first_line = (0, 0), True
        n_mb = self.mb_w * self.mb_h
        for mb in range(n_mb):
            mb_x, mb_y = mb % self.mb_w, mb // self.mb_w
            if (mb_x, mb_y) == (self.resync[0], self.resync[1] + 1):
                self.first_line = False
            q = self.macroblock(w, kind, q, threshold, f_code, mb_x, mb_y)
            if mb + 1 < n_mb and self.chance(self.odds["packet"]):
                w.stuff()
                w.u(16 if kind == "I" else 15 + f_code, 0)  # the resync marker
                w.u(1, 1)
                w.u(max(1, (n_mb - 1).bit_length()), mb + 1)
                packet_q = int(self.rng.choice((0, self.rng.integers(1, 5 if self.odds["gray"] else 32))))
                w.u(5, packet_q)
                q = packet_q or q
                hec = self.chance(0.5)
                w.u(1, hec)
                if hec:
                    w.u(1, 0), w.u(1, 1), w.u(time_bits, t), w.u(1, 1)
                    w.u(2, kind == "P"), w.u(3, threshold)
                    if kind == "P":
                        w.u(3, f_code)
                self.resync, self.first_line = ((mb + 1) % self.mb_w, (mb + 1) // self.mb_w), True
        w.stuff()

    def macroblock(self, w: BitWriter, kind: str, q: int, threshold: int, f_code: int, mb_x: int,
                   mb_y: int) -> int:
        """One macroblock; the new quantiser."""
        if kind == "I":
            while self.chance(self.odds["stuffing"]):
                w.code(mpeg4.INTRA_MCBPC, 8)
            dquant = self.chance(self.odds["dquant"]) and not self.odds["gray"]
            cbpc = 0 if self.odds["gray"] else int(self.rng.integers(4))
            w.code(mpeg4.INTRA_MCBPC, cbpc | (4 if dquant else 0))
            return self.intra_mb(w, cbpc, dquant, q, threshold, mb_x, mb_y)
        while self.chance(self.odds["stuffing"]):
            w.u(1, 0)
            w.code(mpeg4.INTER_MCBPC, 20)
        skipped = self.chance(self.odds["skip"])
        intra = not skipped and self.chance(self.odds["intra"])
        if not intra:
            for n in range(6):  # a macroblock that is not intra resets its DC
                grid, k, _ = self.cell(n, mb_x, mb_y)
                grid[k] = 1024
        if skipped:
            w.u(1, 1)  # not coded
            self.skipped[mb_y * self.mb_w + mb_x] = True
            return q
        w.u(1, 0)
        dquant = self.chance(self.odds["dquant"]) and not self.odds["gray"]
        cbpc = 0 if self.odds["gray"] else int(self.rng.integers(4))
        residual = intra or self.chance(self.odds["residual"])
        if not residual:
            cbpc = 0
        mv4 = not intra and self.chance(self.odds["mv4"])
        w.code(mpeg4.INTER_MCBPC, cbpc | (4 if intra else 0) | (8 if dquant else 0)
               | (16 if mv4 else 0))
        if intra:
            return self.intra_mb(w, cbpc, dquant, q, threshold, mb_x, mb_y)
        cbpy = int(self.rng.choice((0, self.rng.integers(16)))) if residual else 0
        w.code(mpeg4.CBPY, cbpy ^ 15)
        if dquant:
            d = int(self.rng.integers(4))
            w.u(2, d)
            q = min(max(q + mpeg4.DQUANT[d], 1), 31)
        for _ in range(8 if mv4 else 2):
            self.motion(w, f_code)
        cbp = (cbpc & 3) | (cbpy << 2)
        for n in range(6):
            if cbp & (32 >> n):
                self.tcoef(w, -1, False, q)
        return q


    def bvop(self, w: BitWriter, time_bits: int, t: int, modulo: int, future_skipped,
             backward_only: bool = False) -> None:
        """A B-VOP: its header (``fcode_forward`` and ``fcode_backward``,
        ``modulo`` seconds of ``modulo_time_base`` after the past
        reference's), then each macroblock but those whose co-located
        macroblock ``future_skipped`` says the future reference skipped
        (FFmpeg skips them unread): MODB (direct with nothing more; a type
        without CBPB; a type with CBPB), MB_TYPE at the odds ``btypes``
        (direct, interpolated, backward, forward; ``backward_only`` for a
        closed GOV's B-VOPs after its I-VOP), DBQUANT, the forward and
        backward vectors (each predicted from the last of its direction in
        the row), direct mode's delta; video packet headers between
        macroblocks at the odds ``packet``."""
        threshold = int(self.rng.choice(self.odds["thresholds"]))
        q = int(self.rng.integers(1, 5 if self.odds["gray"] else 32))
        f_code, b_code = (int(v) for v in self.rng.integers(1, 8, 2))
        w.start(0xB6)
        w.u(2, 2)
        w.u(modulo + 1, (1 << (modulo + 1)) - 2)
        w.u(1, 1)
        w.u(time_bits, t)
        w.u(1, 1)
        w.u(1, 1)  # vop_coded
        w.u(3, threshold)
        w.u(5, q)
        w.u(3, f_code)
        w.u(3, b_code)
        n_mb = self.mb_w * self.mb_h
        for mb in range(n_mb):
            if not future_skipped[mb]:
                q = self.bmacroblock(w, q, f_code, b_code, backward_only)
            if mb + 1 < n_mb and self.chance(self.odds["packet"]):
                w.stuff()
                w.u(max(f_code, b_code, 2) + 15, 0)  # the resync marker
                w.u(1, 1)
                w.u(max(1, (n_mb - 1).bit_length()), mb + 1)
                packet_q = int(self.rng.choice((0, self.rng.integers(1, 32))))
                w.u(5, packet_q)
                q = packet_q or q
                hec = self.chance(0.5)
                w.u(1, hec)
                if hec:
                    w.u(modulo + 1, (1 << (modulo + 1)) - 2), w.u(1, 1), w.u(time_bits, t)
                    w.u(1, 1), w.u(2, 2), w.u(3, threshold), w.u(3, f_code), w.u(3, b_code)
        w.stuff()

    def bmacroblock(self, w: BitWriter, q: int, f_code: int, b_code: int,
                    backward_only: bool) -> int:
        """One coded macroblock of a B-VOP; the new quantiser."""
        if not backward_only and self.chance(self.odds["modb1"]):
            w.u(1, 1)  # direct, no vectors, no CBPB
            return q
        w.u(1, 0)
        with_cbp = self.chance(self.odds["residual"])
        w.u(1, int(not with_cbp))
        mb_type = 2 if backward_only else int(self.rng.choice(4, p=self.odds["btypes"]))
        w.u(mb_type + 1, 1)  # 1 direct, 01 interpolated, 001 backward, 0001 forward
        cbp = int(self.rng.integers(64)) if with_cbp else 0
        if with_cbp:
            w.u(6, cbp)
        if mb_type and cbp:
            d = int(self.rng.choice(3, p=(0.6, 0.2, 0.2)))
            w.u((1, 2, 2)[d], (0, 2, 3)[d])  # DBQUANT: 0, 10 (-2), 11 (+2)
            q = min(max(q + (0, -2, 2)[d], 1), 31)
        if mb_type in (1, 3):
            self.motion(w, f_code), self.motion(w, f_code)
        if mb_type in (1, 2):
            self.motion(w, b_code), self.motion(w, b_code)
        if mb_type == 0:
            self.motion(w, 1), self.motion(w, 1)
        for n in range(6):
            if cbp & (32 >> n):
                self.tcoef(w, -1, False, q)
        return q


def user_data_headers(w: BitWriter, user_data) -> None:
    """User data headers: one of ``user_data`` (bytes), or one a string of
    it (a sequence: Xvid's packed mode names both Xvid and DivX)."""
    for text in ([user_data] if isinstance(user_data, bytes) else user_data or ()):
        w.start(0xB2)
        w.bits.append("".join(format(b, "08b") for b in text))


def bstream(width: int, height: int, frames: int, gop: int, bframes: int, seed: int,
            user_data=None, odds=None, resolution: int = 5, gov: str = "",
            leading: int = 0, packed: bool = False, **vol) -> List[bytes]:
    """A stream with B-VOPs: in display order ``leading`` B-VOPs, then GOPs
    of ``gop`` frames, an I-VOP and P-VOPs every ``bframes + 1`` frames with
    B-VOPs between (the last frame a reference), coded in decoding order:
    each reference, then the B-VOPs displayed before it. Times count one
    tick of ``resolution`` a frame, ``modulo_time_base`` a second (a
    B-VOP's from its past reference's, or from the GOV's time code after
    a GOV). ``gov`` writes a GOV header before each I-VOP, its time code
    the second of the first frame the GOV displays: "open" (the B-VOPs
    after the I-VOP predicted from the last GOP too), "closed" (those
    predicted backward only) or "broken" (open, ``broken_link`` set). At
    the odds ``bad_time`` a B-VOP's time lies outside its references'
    (FFmpeg skips it). ``packed`` writes DivX's packed bitstream: each
    reference shares its packet with the first B-VOP after it, and a
    not-coded VOP fills the packet its last B-VOP leaves. VOL headers and
    user data (:func:`user_data_headers`) before each I-VOP; ``vol`` as
    :func:`vol_headers` takes it."""
    rng = np.random.default_rng(seed)
    if not vol.get("resync"):
        odds = {**(odds or {}), "packet": 0.0}
    writer = Writer(rng, (width + 15) // 16, (height + 15) // 16, odds)
    time_bits = max(1, (resolution - 1).bit_length())
    refs = [k for k in range(leading, frames) if (k - leading) % gop % (bframes + 1) == 0]
    if refs[-1] != frames - 1:
        refs.append(frames - 1)
    order, prev = [], -1  # (display index, kind, past ref display index)
    for r in refs:
        kind = "I" if (r - leading) % gop == 0 else "P"
        order.append((r, kind, prev))
        order += [(b, "B", prev) for b in range(prev + 1 if prev >= 0 else 0, r)]
        prev = r
    vops, time_base, gov_open = [], 0, False
    for k, kind, past in order:
        w = BitWriter()
        if kind == "I":
            vol_headers(w, width, height, resolution, **vol)
            user_data_headers(w, user_data)
            first = min([k] + [b for b, kd, p in order if kd == "B" and p == past and b < k])
            if gov:
                sec = first // resolution
                w.start(0xB3)
                w.u(5, sec // 3600), w.u(6, sec // 60 % 60), w.u(1, 1), w.u(6, sec % 60)
                w.u(1, gov == "closed"), w.u(1, gov == "broken")
                time_base = sec
            gov_open = gov != "closed"
        if kind == "B":
            sec = k // resolution
            t = k % resolution
            if writer.chance(writer.odds["bad_time"]):
                t, sec = (resolution - 1, sec + 1) if rng.random() < 0.5 else (0, last_base)
            writer.bvop(w, time_bits, t, max(sec - last_base, 0), skipped,
                        backward_only=past < last_key and not gov_open)
        else:
            last_base, sec = time_base, k // resolution
            writer.vop(w, kind, time_bits, k % resolution, len(vops) % 2, max(sec - time_base, 0))
            time_base = max(sec, time_base)
            skipped = writer.skipped
            if kind == "I":
                last_key = k
        vops.append((kind, w.bytes()))
    if not packed:
        return [v for _, v in vops]
    packets, k = [], 0
    while k < len(vops):
        group = [vops[k][1]]
        k += 1
        while k < len(vops) and vops[k][0] == "B":
            group.append(vops[k][1])
            k += 1
        if len(group) == 1:
            packets.append(group[0])
            continue
        packets.append(group[0] + group[1])
        packets += group[2:]
        n = BitWriter()
        n.start(0xB6)
        n.u(2, 1), n.u(1, 0), n.u(1, 1), n.u(time_bits, 0), n.u(1, 1), n.u(1, 0)
        n.stuff()
        packets.append(n.bytes())
    return packets


def stream(width: int, height: int, frames: int, gop: int, seed: int,
           user_data: Optional[bytes] = None, odds=None, **vol) -> List[bytes]:
    """One packet a VOP: the VOL headers (``vol``, as :func:`vol_headers`
    takes them) and user data before each I-VOP."""
    rng = np.random.default_rng(seed)
    if not vol.get("resync"):  # video packets need resync markers in the VOL
        odds = {**(odds or {}), "packet": 0.0}
    writer = Writer(rng, (width + 15) // 16, (height + 15) // 16, odds)
    resolution, packets = 25, []
    time_bits = max(1, (resolution - 1).bit_length())
    for k in range(frames):
        w = BitWriter()
        kind = "I" if k % gop == 0 else "P"
        if kind == "I":
            vol_headers(w, width, height, resolution, **vol)
            if user_data:
                w.start(0xB2)
                w.bits.append("".join(format(b, "08b") for b in user_data))
        if kind == "P" and writer.chance(writer.odds["nvop"]):
            n = BitWriter()  # a not-coded VOP before it, a packet of its own
            n.start(0xB6)
            n.u(2, 1), n.u(1, 0), n.u(1, 1), n.u(time_bits, k % resolution), n.u(1, 1), n.u(1, 0)
            n.stuff()
            packets.append(n.bytes())
        writer.vop(w, kind, time_bits, k % resolution, k % 2)
        packets.append(w.bytes())
    return packets


#: The intra matrix of :func:`coefficient_vop`: every entry 8, so that at
#: quantiser 1 MPEG dequantisation leaves an AC level as it is.
FLAT_MATRIX = [8, 0]


def coefficient_vop(width: int, height: int, blocks: Sequence[Sequence[int]],
                    user_data: Optional[bytes] = None) -> bytes:
    """A VOL (MPEG quantisation, :data:`FLAT_MATRIX`) and an I-VOP at
    quantiser 1 whose blocks (six a macroblock, in decoding order) hold the
    given values: ``blocks[n]`` is 64 values in raster order, its first the
    DC level (the coefficient is 8 times it) and the rest AC coefficients in
    -2047..2047, each sent as a third escape. Blocks past the list are
    flat. The DC is sent through its VLC as the difference from its
    prediction (:meth:`Writer.cell`'s grid), kept to what FFmpeg takes (at
    most 9 bits, a level of 0 or more), so every coefficient the IDCT sees
    is chosen, the DC as near as that allows: the fixtures that hold an
    IDCT to FFmpeg's."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    w = BitWriter()
    vol_headers(w, width, height, 25, quant_type=1, intra_matrix=FLAT_MATRIX)
    if user_data:
        w.start(0xB2)
        w.bits.append("".join(format(b, "08b") for b in user_data))
    w.start(0xB6)
    w.u(2, 0), w.u(1, 0), w.u(1, 1), w.u(5, 0), w.u(1, 1), w.u(1, 1)
    w.u(3, 0), w.u(5, 1)  # intra_dc_vlc_thr 0 (the DC VLC), quantiser 1
    cells = Writer(np.random.default_rng(0), mb_w, mb_h)
    lw, cw = 2 * mb_w + 1, mb_w + 1
    cells.dc = [[1024] * ((2 * mb_h + 1) * lw), [1024] * ((mb_h + 1) * cw), [1024] * ((mb_h + 1) * cw)]
    flat = [128] + [0] * 63
    for mb in range(mb_w * mb_h):
        mb_x, mb_y = mb % mb_w, mb // mb_w
        mine = [list(blocks[6 * mb + n]) if 6 * mb + n < len(blocks) else flat for n in range(6)]
        cbp = sum(32 >> n for n in range(6) if any(mine[n][1:]))
        w.code(mpeg4.INTRA_MCBPC, cbp & 3)
        w.u(1, 0)  # ac_pred
        w.code(mpeg4.CBPY, cbp >> 2)
        for n, block in enumerate(mine):
            grid, k, step = cells.cell(n, mb_x, mb_y)
            a, b, c = grid[k - 1], grid[k - 1 - step], grid[k - step]
            pred = ((c if abs(a - b) < abs(b - c) else a) + 4) // 8
            diff = min(max(block[0] - pred, -min(pred, 511)), 511)  # FFmpeg's DC VLC: 9 bits
            grid[k] = min((pred + diff) * 8, 2047)
            size = abs(diff).bit_length()
            w.code(mpeg4.DC_LUM if n < 4 else mpeg4.DC_CHROM, size)
            if size:
                w.u(size, diff if diff > 0 else diff + (1 << size) - 1)
                if size > 8:
                    w.u(1, 1)
            coded = [(i, block[mpeg4.ZIGZAG[i]]) for i in range(1, 64) if block[mpeg4.ZIGZAG[i]]]
            last_i = 0
            for j, (i, level) in enumerate(coded):
                w.code(mpeg4.INTRA_VLC, mpeg4.ESCAPE)
                w.u(2, 3)
                w.u(1, int(j == len(coded) - 1)), w.u(6, i - last_i - 1), w.u(1, 1)
                w.u(12, level), w.u(1, 1)
                last_i = i
    w.stuff()
    return w.bytes()


def chunk(fourcc: bytes, body: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def avi_bytes(packets: Sequence[bytes], width: int, height: int, fourcc: bytes = b"FMP4",
              rate: int = 25, extradata: bytes = b"") -> bytes:
    """An AVI of one video stream, ``idx1`` offsets from ``movi``, each
    I-VOP's entry flagged as a key frame; ``extradata`` after ``strf``'s
    BITMAPINFOHEADER (where some writers put the VOL)."""
    n = len(packets)
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIiI4h", 0, 0, 0, 0, 1, rate, 0, n, 0, -1, 0, 0, 0,
                                          width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    avih = struct.pack("<14I", round(1e6 / rate), 0, 0, 0x110, n, 0, 1, 0, width, height, 0, 0, 0, 0)
    head = b"RIFF\0\0\0\0AVI " + chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)))
    body, index = bytearray(b"movi"), []
    for p in packets:
        at = p.find(b"\x00\x00\x01\xb6")
        key = at >= 0 and p[at + 4] >> 6 == 0
        index.append(struct.pack("<4sIII", b"00dc", 0x10 if key else 0, len(body), len(p)))
        body += chunk(b"00dc", p)
    out = bytearray(head + chunk(b"LIST", bytes(body)) + chunk(b"idx1", b"".join(index)))
    out[4:8] = struct.pack("<I", len(out) - 8)
    return bytes(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out")
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--gop", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fourcc", default="FMP4")
    parser.add_argument("--user-data", action="append", default=None,
                        help="a user data string (again for more)")
    parser.add_argument("--bframes", type=int, default=0, help="B-VOPs between references")
    parser.add_argument("--packed", action="store_true", help="DivX's packed bitstream")
    parser.add_argument("--gov", choices=("", "open", "closed", "broken"), default="")
    parser.add_argument("--low-delay", type=int, choices=(0, 1), default=None,
                        help="VOL control parameters with this low_delay bit")
    args = parser.parse_args(argv)
    user_data = [u.encode() for u in args.user_data or ()]
    if args.bframes or args.packed or args.gov:
        vol = {} if args.low_delay is None else {"low_delay": args.low_delay}
        packets = bstream(args.width, args.height, args.frames, args.gop, args.bframes, args.seed,
                          user_data, gov=args.gov, packed=args.packed, **vol)
    else:
        packets = stream(args.width, args.height, args.frames, args.gop, args.seed,
                         user_data[0] if user_data else None)
    with open(args.out, "wb") as fh:
        fh.write(avi_bytes(packets, args.width, args.height, args.fourcc.encode()))


if __name__ == "__main__":
    main()
