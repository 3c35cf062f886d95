"""Decode JPEG images from bytes as ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)``
decodes them with libjpeg-turbo's defaults, bit for bit, and encode them as
``cv2.imencode(".jpg", img)`` encodes them, byte for byte: the port's JPEG
codec for ``.pkg.slp`` files, HDF5 frame files, image folders, ImgStores and
``sleap-render``'s Motion-JPEG, where ``cv2`` is not installed.

Scope: baseline, extended-sequential and progressive Huffman JPEGs (SOF0,
SOF1, SOF2), 8-bit, of one component (gray, returned (H, W)), three
(returned (H, W, 3) in BGR order: YCbCr, or RGB as stored where an Adobe
marker's transform is 0 or the component ids are 'R', 'G', 'B', as
libjpeg-turbo's ``default_decompress_parms`` guesses, JFIF first) or four
(CMYK, or YCCK where an Adobe marker's transform is not 0; returned BGR as
OpenCV's ``icvCvt_CMYK2BGR_8u_C4C3R`` converts libjpeg's inverted CMYK), with
any sampling whose factors divide the largest (4:4:4, 4:2:2, 4:2:0, 4:4:0,
4:1:1, ...), restart intervals, optimised Huffman tables (redefined between
scans too) or none (a stream without DHT, as Motion-JPEG frames come, takes
the Annex K.3 tables, as libjpeg-turbo's ``jinit_huff_decoder`` does),
several scans and sizes that are no multiple of the MCU. A progressive file
may use any scan script libjpeg accepts (spectral selection and successive
approximation; DC scans of several components, AC scans of one); where its
scans leave AC coefficients 1-9 short of full precision (a truncated file, a
partial script), the blocks are smoothed as libjpeg-turbo 3's
``jdcoefct.c`` ``decompress_smooth_data`` smooths them (``smoothing_ok``;
:func:`smooth_plain`, J6 on the card). Lossless and hierarchical
(differential) frames and 12-bit samples, which cv2 returns nothing for,
and arithmetic-coded frames (nothing here writes a real one to hold cv2
to) raise :class:`UnsupportedJpeg` naming the feature.

A decode has four stages, each as libjpeg-turbo does it:

1. markers and Huffman entropy decoding into de-zigzagged int16 coefficients
   (byte stuffing; a restart marker resets the DC predictions and, in a
   progressive scan, the end-of-band run). Progressive scans are those of
   ``jdphuff.c``: DC first (with its point transform), DC refinement (one
   bit a block), AC first (with end-of-band runs across blocks) and AC
   refinement (correction bits for the coefficients already nonzero); a
   scan of one component walks that component's own blocks;
2. dequantisation and the integer inverse DCT of ``jidctint.c``
   (``jpeg_idct_islow``: CONST_BITS 13, PASS1_BITS 2, 64-bit sums, +128 and
   the post-IDCT range limit);
3. upsampling as ``jinit_upsampler`` picks it (``jdsample.c``:
   ``h2v1_fancy_upsample``, the 3:1 triangle with rounding 1/2,
   ``h2v2_fancy_upsample``, the 3:1 triangle on both axes with rounding
   8/7, and ``h1v2_fancy_upsample`` for 4:4:0; edge samples replicated),
   or plain replication (a plane at most 2 samples wide, 4:1:1 and other
   integral factors: ``int_upsample``);
4. the integer YCbCr -> BGR tables of ``jdcolor.c`` (SCALEBITS 16), RGB as
   stored, or CMYK and YCCK through OpenCV's CMYK conversion.

Progressive files that libjpeg-turbo smooths take a stage between 1 and 2:
block smoothing (J6 on the card).

Two routes, by the ``device`` asked for:

- ``"cpu"``: the plain version. Stage 1 in Python (slow: about a second for
  a 1024^2 frame), stages 2-4 in PyTorch integer tensor code.
- ``"cuda"``: stage 1 in host C (``sleap_jpeg_decode_scan`` and, for
  progressive scans, ``sleap_jpeg_decode_progressive`` in ``csrc/jpeg.cu``)
  into a pinned buffer, one copy to the card, then ``jpeg_smooth_kernel``
  (J6, block smoothing, where it applies), ``jpeg_idct_kernel`` (J1, stage
  2) and ``jpeg_color_kernel`` (J2, stages 3 and 4, its colour space and
  upsamplers arguments), and the frame back to the host as numpy. A failed build or launch raises; there is no fallback
  to the plain version.

Encoding (:func:`imencode`) writes cv2's defaults, all the JAX package
writes: quality 95, baseline, the standard Huffman tables, gray as one
component and colour (BGR) as YCbCr 4:2:0, JFIF 1.01. Its stages, each as
libjpeg-turbo's C does it (its SIMD paths give the same bits):

1. colour conversion (``jccolor.c``, SCALEBITS 16), edge repetition to whole
   blocks and MCUs (``jcprepct.c``, ``jcsample.c``) and ``h2v2_downsample``
   with its alternating bias;
2. the level shift, ``jpeg_fdct_islow`` (16-bit ``DCTELEM`` between the
   passes) and ``jcdctmgr.c``'s reciprocal quantisation;
3. Huffman coding of the MCUs with ``jccoefct.c``'s dummy blocks past Y's
   edges, byte stuffing and 1-bit padding; then the markers.

On ``"cpu"`` these are :func:`ycc_plain`, :func:`fdct_plain` (PyTorch
integer code) and :func:`encode_scan_plain` (Python: the whole plain
route takes 0.19-0.42 s a 1024^2 frame on an H100 server's host, by
``chip_smoke.py`` 18a). On ``"cuda"``: ``jpeg_ycc_kernel`` (J3) and ``jpeg_fdct_kernel`` (J4)
on the card, one copy of the coefficients back, and
``sleap_jpeg_encode_scan`` in host C; no fallback.

No TPU kernel has a counterpart here: the JAX package decodes and encodes
with cv2 on the host (``sleap_tpu/io/video.py``, ``HDF5Video.get_frame`` and
``Video.to_hdf5``; ``sleap_tpu/io/slp.py``; ``sleap_tpu/io/dirimgstore.py``).
"""

from __future__ import annotations

import functools
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# Zigzag position k -> natural (row-major) index, with 16 entries of 63
# after the end, as libjpeg's ``jpeg_natural_order``, so a corrupt run
# length lands on the last coefficient instead of past the block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16, np.int32)

_SOF_NAMES = {
    0xC3: "lossless JPEG (SOF3)",
    0xC5: "differential sequential JPEG (SOF5)", 0xC6: "differential progressive JPEG (SOF6)",
    0xC7: "differential lossless JPEG (SOF7)", 0xC9: "arithmetic-coded JPEG (SOF9)",
    0xCA: "arithmetic-coded progressive JPEG (SOF10)", 0xCB: "arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "arithmetic-coded differential JPEG (SOF13)",
    0xCE: "arithmetic-coded differential progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded differential lossless JPEG (SOF15)",
}


class UnsupportedJpeg(ValueError):
    """The stream uses a JPEG feature outside the subset this module decodes."""


@dataclass
class Component:
    """A frame component: its sampling factors and quantisation table, its
    size after downsampling (``width`` x ``height`` samples, libjpeg's
    ``downsampled_width``/``height``), and its coefficient blocks, padded
    to whole MCUs, at block ``offset`` of the frame's coefficient buffer."""

    ident: int
    h: int
    v: int
    tq: int
    width: int = 0
    height: int = 0
    blocks_w: int = 0
    blocks_h: int = 0
    offset: int = 0
    declared_v: int = 1  # the frame header's vertical factor (a lone component's v is reset to 1)


@dataclass
class Scan:
    """A scan: the components it codes (indices into the frame's), their DC
    and AC tables (by id, and the lookups defined when the scan starts),
    where its entropy-coded data starts, the restart interval in force, and
    its spectral band and successive-approximation bits (``ss``, ``se``,
    ``ah``, ``al``: 0, 63, 0, 0 for a sequential scan)."""

    comps: List[int]
    dc: List[int]
    ac: List[int]
    start: int
    restart: int
    luts: List[np.ndarray] = field(default_factory=list)
    ss: int = 0
    se: int = 63
    ah: int = 0
    al: int = 0

    @property
    def kind(self) -> str:
        """"sequential", "dc_first", "dc_refine", "ac_first" or "ac_refine"."""
        if (self.ss, self.se, self.ah, self.al) == (0, 63, 0, 0):
            return "sequential"
        return ("dc" if self.ss == 0 else "ac") + ("_refine" if self.ah else "_first")


@dataclass
class Header:
    """What the markers say: the frame size, components, quantisation
    tables latched per component (natural order) and the scans (each with
    its Huffman lookups)."""

    height: int
    width: int
    components: List[Component]
    quant: np.ndarray  # (components, 64) uint16
    scans: List[Scan]
    progressive: bool = False
    #: "gray", "ycc", "rgb" (no colour transform), "cmyk" or "ycck", as
    #: libjpeg-turbo's ``default_decompress_parms`` picks the colour space.
    color: str = "gray"
    #: Each component's ``coef_bits`` for zigzag coefficients 0-9 after the
    #: last scan (-1: none yet), and whether libjpeg-turbo smooths the blocks.
    coef_bits: List[List[int]] = field(default_factory=list)
    smooth: bool = False

    @property
    def blocks(self) -> int:
        return sum(c.blocks_w * c.blocks_h for c in self.components)

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)


@functools.lru_cache(maxsize=64)
def huffman_lookup(counts: bytes, values: bytes) -> np.ndarray:
    """A table of 65536 entries indexed by the next 16 bits of the stream:
    ``length << 8 | symbol`` of the code they start with, 0 where none does
    (read-only; kept for the tables seen last, which a JPEG-in-TIFF's strips
    and a video's frames repeat)."""
    table = np.zeros(1 << 16, np.uint16)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= (1 << length):
                raise ValueError("JPEG Huffman table has more codes than its lengths allow.")
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = (length << 8) | values[k]
            code, k = code + 1, k + 1
        code <<= 1
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=4)
def _standard_lookup(tc: int, th: int) -> np.ndarray:
    """The lookup of the Annex K.3 table of class ``tc`` (0 DC, 1 AC) and id
    ``th`` (0 luma, 1 chroma), which a stream without DHT decodes with."""
    table = STD_HUFFMAN[2 * th + tc]
    return huffman_lookup(table[:16], table[16:])


def _segment(data: bytes, pos: int) -> Tuple[bytes, int]:
    """The entropy-coded bytes from ``pos`` to the next marker, unstuffed
    (0xFF 0x00 -> 0xFF), and the marker's position."""
    i = pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            end = len(data)
            break
        if data[i + 1] == 0:
            i += 2
            continue
        end = i
        break
    return data[pos:end].replace(b"\xff\x00", b"\xff"), end


def _skip_restart(data: bytes, pos: int, expect: int) -> int:
    """Past the restart marker RST``expect`` at ``pos`` (after fill bytes)."""
    while pos + 1 < len(data) and data[pos] == 0xFF and data[pos + 1] == 0xFF:
        pos += 1
    if pos + 1 >= len(data) or data[pos] != 0xFF or data[pos + 1] != 0xD0 + expect:
        found = data[pos + 1] if pos + 1 < len(data) else None
        raise ValueError(f"JPEG restart marker RST{expect} expected, found "
                         f"{'end of data' if found is None else hex(found)}.")
    return pos + 2


def _color_space(components: List[Component], jfif: bool, adobe_transform) -> str:
    """libjpeg-turbo's guess of the stored colour space
    (``jdapimin.c``'s ``default_decompress_parms``): for three components
    a JFIF marker means YCbCr, else an Adobe marker's transform (0 RGB),
    else component ids 'R', 'G', 'B' mean RGB; four are CMYK, or YCCK where
    an Adobe marker's transform is not 0."""
    if len(components) == 1:
        return "gray"
    if len(components) == 3:
        if jfif:
            return "ycc"
        if adobe_transform is not None:
            return "rgb" if adobe_transform == 0 else "ycc"
        return "rgb" if [c.ident for c in components] == [82, 71, 66] else "ycc"
    return "cmyk" if adobe_transform in (None, 0) else "ycck"


def parse(data: bytes, colorspace: Optional[str] = None) -> Header:
    """Read the markers of a JPEG stream; raise :class:`UnsupportedJpeg` for
    a feature outside the subset, ``ValueError`` for a malformed stream.
    ``colorspace`` ("ycc" or "rgb") overrides the guess from the markers, as
    libtiff sets libjpeg's for a JPEG-in-TIFF strip."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG stream (no SOI marker).")
    pos, quant_tables, tables = 2, {}, {}
    components: List[Component] = []
    scans: List[Scan] = []
    latched: Dict[int, np.ndarray] = {}
    size, restart, adobe_transform, progressive, jfif = None, 0, None, False, False
    coef_bits: List[List[int]] = []  # progressive: each component's precision so far (-1: none)
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between markers, as libjpeg skips it
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError("JPEG stream ends before its EOI marker.")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise ValueError("JPEG marker segment is truncated.")
        pos += length
        if marker in (0xC0, 0xC1, 0xC2):
            precision, height, width, n = struct.unpack_from(">BHHB", body)
            if precision != 8:
                raise UnsupportedJpeg(f"{precision}-bit JPEG samples are not supported (8-bit only).")
            if n not in (1, 3, 4):
                raise UnsupportedJpeg(f"JPEGs of {n} components are not supported (1, 3 or 4).")
            if height == 0:
                raise UnsupportedJpeg("JPEGs whose height is set by a DNL marker are not supported.")
            size, progressive = (height, width), marker == 0xC2
            for i in range(n):
                ident, hv, tq = body[6 + 3 * i:9 + 3 * i]
                components.append(Component(ident, hv >> 4, hv & 15, tq, declared_v=hv & 15))
            coef_bits = [[-1] * 64 for _ in range(n)]
        elif marker in _SOF_NAMES:
            raise UnsupportedJpeg(f"{_SOF_NAMES[marker]} is not supported "
                                  "(baseline, extended sequential and progressive Huffman only).")
        elif marker == 0xCC:
            raise UnsupportedJpeg("arithmetic coding (DAC marker) is not supported.")
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq:
                    values = np.frombuffer(body, ">u2", 64, p + 1).astype(np.uint16)
                    p += 129
                else:
                    values = np.frombuffer(body, np.uint8, 64, p + 1).astype(np.uint16)
                    p += 65
                table = np.empty(64, np.uint16)
                table[ZIGZAG[:64]] = values
                quant_tables[tq] = table
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = body[p + 1:p + 17]
                total = sum(counts)
                tables[(tc, th)] = huffman_lookup(bytes(counts), bytes(body[p + 17:p + 17 + total]))
                p += 17 + total
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xE0 and body[:5] == b"JFIF\0" and len(body) >= 14:
            jfif = True
        elif marker == 0xDC:
            raise UnsupportedJpeg("JPEGs with a DNL marker are not supported.")
        elif marker == 0xDA:  # SOS
            if size is None:
                raise ValueError("JPEG scan before its frame header.")
            if not scans:
                _layout(size, components)
            n = body[0]
            idents = [c.ident for c in components]
            comps, dc, ac = [], [], []
            for i in range(n):
                cs, td_ta = body[1 + 2 * i:3 + 2 * i]
                if cs not in idents:
                    raise ValueError(f"JPEG scan names component {cs}, which the frame lacks.")
                comps.append(idents.index(cs))
                dc.append(td_ta >> 4)
                ac.append(td_ta & 15)
            ss, se, ahal = body[1 + 2 * n:4 + 2 * n]
            ah, al = ahal >> 4, ahal & 15
            scan = Scan(comps, dc, ac, pos, restart, [], ss, se, ah, al)
            if not progressive and (ss, se, ahal) != (0, 63, 0):
                raise UnsupportedJpeg("spectral-selection or successive-approximation scans in a "
                                      "sequential (SOF0/SOF1) JPEG are not supported.")
            if progressive:
                _check_progression(scan, coef_bits)
            # The lookups this scan decodes with: DC tables for a sequential
            # or DC-first scan, AC tables for a sequential or AC scan.
            keys = ([(0, d) for d in dc] if scan.kind in ("sequential", "dc_first") else []) \
                + ([(1, a) for a in ac] if scan.kind in ("sequential", "ac_first", "ac_refine") else [])
            for key in keys:
                if key not in tables and key[1] < 2:
                    # Motion-JPEG frames leave out DHT: libjpeg-turbo's
                    # jinit_huff_decoder then installs the Annex K.3 tables.
                    tables[key] = _standard_lookup(*key)
                if key not in tables:
                    raise ValueError(f"JPEG scan uses Huffman table {key}, never defined.")
            scan.luts = [tables[key] for key in keys]
            for ci in comps:
                if ci not in latched:  # libjpeg latches a table at the component's first scan
                    tq = components[ci].tq
                    if tq not in quant_tables:
                        raise ValueError(f"JPEG component uses quantisation table {tq}, never defined.")
                    latched[ci] = quant_tables[tq].copy()
            scans.append(scan)
            pos = _segment_end(data, pos)
        # APPn, COM and the rest carry nothing the decode needs.
    if size is None or not scans:
        raise ValueError("JPEG stream has no frame or no scan.")
    if len(latched) != len(components):
        raise ValueError("JPEG stream leaves a component without a scan.")
    quant = np.stack([latched[i] for i in range(len(components))])
    smooth = progressive and _smoothing_ok(quant, coef_bits)
    color = colorspace if colorspace and len(components) == 3 else _color_space(
        components, jfif, adobe_transform)
    return Header(size[0], size[1], components, quant, scans, progressive, color,
                  [bits[:SMOOTH_COEFS] for bits in coef_bits], smooth)


def _check_progression(scan: Scan, coef_bits: List[List[int]]) -> None:
    """``jdphuff.c``'s checks of a progressive scan's parameters (fatal in
    libjpeg) and its record of each coefficient's precision."""
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    bad = (se != 0) if ss == 0 else (ss > se or se > 63 or len(scan.comps) != 1)
    if (ah and al != ah - 1) or al > 13 or bad:
        raise ValueError(f"JPEG progressive scan parameters Ss={ss} Se={se} Ah={ah} Al={al} are "
                         "invalid.")
    for ci in scan.comps:
        coef_bits[ci][ss:se + 1] = [al] * (se - ss + 1)


SMOOTH_COEFS = 10  # jdcoefct.c's SAVED_COEFS: zigzag coefficients 0-9


def _smoothing_ok(quant: np.ndarray, coef_bits: List[List[int]]) -> bool:
    """libjpeg-turbo's ``smoothing_ok`` at the output pass: every component's
    DC known and its table's entries for zigzag coefficients 0-9 nonzero,
    and some component with one of AC coefficients 1-9 short of full
    precision."""
    useful = False
    for table, bits in zip(quant, coef_bits):
        if (table[ZIGZAG[:SMOOTH_COEFS]] == 0).any() or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:SMOOTH_COEFS])
    return useful


def _segment_end(data: bytes, pos: int) -> int:
    """Where a scan's entropy-coded data (restart markers included) ends."""
    i = pos
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= len(data):
            return len(data)
        nxt = data[i + 1]
        if nxt == 0 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
            i += 1 if nxt == 0xFF else 2
            continue
        return i


def _layout(size, components: List[Component]) -> None:
    """Check the sampling and set each component's downsampled size and
    block layout (libjpeg's ``downsampled_width`` and MCU padding)."""
    height, width = size
    hmax = max(c.h for c in components)
    vmax = max(c.v for c in components)
    if len(components) > 1 and any(not c.h or not c.v or hmax % c.h or vmax % c.v
                                   for c in components):
        # libjpeg-turbo's jinit_upsampler: JERR_FRACT_SAMPLE_NOTIMPL
        samplings = "x".join(f"{c.h}{c.v}" for c in components)
        raise UnsupportedJpeg(f"JPEG sampling {samplings} is not supported: a component's factors "
                              "do not divide the largest (libjpeg refuses fractional upsampling).")
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    offset = 0
    for c in components:
        if len(components) == 1:
            c.h = c.v = 1  # a lone component is one block an MCU, whatever it declares
            hmax = vmax = 1
        c.width = -(-width * c.h // hmax)
        c.height = -(-height * c.v // vmax)
        c.blocks_w = mcux * c.h if len(components) > 1 else -(-c.width // 8)
        c.blocks_h = mcuy * c.v if len(components) > 1 else -(-c.height // 8)
        c.offset = offset
        offset += c.blocks_w * c.blocks_h


def _scan_geometry(header: Header, scan: Scan):
    """(MCUs across, MCUs down, per scan component (blocks across an MCU,
    down an MCU)): an interleaved scan walks whole MCUs, a one-component
    scan walks that component's own blocks."""
    if len(scan.comps) == 1:
        c = header.components[scan.comps[0]]
        return -(-c.width // 8), -(-c.height // 8), [(1, 1)]
    hmax, vmax = header.hmax, header.vmax
    mcux = -(-header.width // (8 * hmax))
    mcuy = -(-header.height // (8 * vmax))
    return mcux, mcuy, [(header.components[i].h, header.components[i].v) for i in scan.comps]


# --------------------------------------------------------------------------- #
# Stage 1, plain: Huffman decoding in Python
# --------------------------------------------------------------------------- #


def decode_scan_plain(data: bytes, header: Header, scan: Scan, coefs: np.ndarray) -> None:
    """Entropy-decode a sequential ``scan`` into ``coefs`` (blocks, 64)
    int16, in natural order. Bits are read through a window of three bytes a
    byte position; a symbol is found by one lookup of the next 16 bits."""
    mcux, mcuy, shape = _scan_geometry(header, scan)
    comps = [header.components[i] for i in scan.comps]
    dc_tabs = [t.tolist() for t in scan.luts[:len(comps)]]
    ac_tabs = [t.tolist() for t in scan.luts[len(comps):]]
    zigzag = ZIGZAG.tolist()
    # Units of one MCU: (component slot, block row, block column).
    units = [(s, by, bx) for s, (h, v) in enumerate(shape) for by in range(v) for bx in range(h)]
    total = mcux * mcuy
    interval = scan.restart or total
    out = np.zeros((total * len(units), 64), np.int64)
    where = np.empty(total * len(units), np.int64)
    pos, mcu, row, n_restarts = scan.start, 0, 0, 0
    while True:
        seg, end = _segment(data, pos)
        n_bits = 8 * len(seg)
        padded = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
        window = ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()
        p = 0
        preds = [0] * len(comps)
        stop = min(mcu + interval, total)
        while mcu < stop:
            my, mx = divmod(mcu, mcux)
            mcu += 1
            for s, by, bx in units:
                c = comps[s]
                h, v = shape[s]
                where[row] = c.offset + (my * v + by) * c.blocks_w + mx * h + bx
                block = out[row]
                row += 1
                # DC: a category, then that many bits of difference.
                look = dc_tabs[s][((window[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                if not look or (look & 0xFF) > 15:
                    raise ValueError("JPEG entropy data holds an invalid Huffman code.")
                p += look >> 8
                t = look & 0xFF
                diff = 0
                if t:
                    diff = ((window[p >> 3] << (p & 7)) >> (24 - t)) & ((1 << t) - 1)
                    p += t
                    if diff < (1 << (t - 1)):
                        diff -= (1 << t) - 1
                preds[s] += diff
                block[0] = preds[s]
                # AC: run/size symbols up to the end of block.
                ac, k = ac_tabs[s], 1
                while k < 64:
                    look = ac[((window[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
                    if not look:
                        raise ValueError("JPEG entropy data holds an invalid Huffman code.")
                    p += look >> 8
                    r, t = (look >> 4) & 15, look & 15
                    if t:
                        k += r
                        val = ((window[p >> 3] << (p & 7)) >> (24 - t)) & ((1 << t) - 1)
                        p += t
                        if val < (1 << (t - 1)):
                            val -= (1 << t) - 1
                        block[zigzag[k]] = val
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
        if p > n_bits:
            raise ValueError("JPEG entropy data ends before its last block.")
        if mcu == total:
            break
        pos = _skip_restart(data, end, n_restarts % 8)
        n_restarts += 1
    coefs[where] = out.astype(np.int16)  # JCOEF is 16-bit: values wrap as libjpeg's do


def _w16(v: int) -> int:
    """``v`` stored in a 16-bit JCOEF."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def decode_progressive_scan_plain(data: bytes, header: Header, scan: Scan,
                                  blocks: List[List[int]]) -> None:
    """One progressive scan of ``jdphuff.c`` (``decode_mcu_DC_first``,
    ``_DC_refine``, ``_AC_first``, ``_AC_refine``) into ``blocks``, each
    block's 64 coefficients in natural order as Python ints."""
    mcux, mcuy, shape = _scan_geometry(header, scan)
    comps = [header.components[i] for i in scan.comps]
    tabs = [t.tolist() for t in scan.luts]
    natural = ZIGZAG.tolist()
    units = [(s, by, bx) for s, (h, v) in enumerate(shape) for by in range(v) for bx in range(h)]
    kind, ss, se, al = scan.kind, scan.ss, scan.se, scan.al
    p1, m1 = 1 << al, -1 << al
    total = mcux * mcuy
    interval = scan.restart or total
    pos, mcu, n_restarts = scan.start, 0, 0
    while True:
        seg, end = _segment(data, pos)
        n_bits = 8 * len(seg)
        padded = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
        window = ((padded[:-2] << 16) | (padded[1:-1] << 8) | padded[2:]).tolist()
        p = 0

        def bits(n):
            nonlocal p
            v = ((window[p >> 3] << (p & 7)) >> (24 - n)) & ((1 << n) - 1)
            p += n
            return v

        def symbol(table):
            nonlocal p
            if p > n_bits:
                raise ValueError("JPEG entropy data ends before its last block.")
            look = table[((window[p >> 3] << (p & 7)) >> 8) & 0xFFFF]
            if not look:
                raise ValueError("JPEG entropy data holds an invalid Huffman code.")
            p += look >> 8
            return look & 0xFF

        def extend(v, t):
            return v - (1 << t) + 1 if v < (1 << (t - 1)) else v

        def correct(block, k):
            """A correction bit for the already-nonzero coefficient at k."""
            at = natural[k]
            v = block[at]
            if bits(1) and (v & p1) == 0:
                block[at] = _w16(v + (p1 if v >= 0 else m1))

        preds = [0] * len(comps)
        eobrun = 0
        stop = min(mcu + interval, total)
        while mcu < stop:
            my, mx = divmod(mcu, mcux)
            mcu += 1
            for s, by, bx in units:
                c = comps[s]
                h, v = shape[s]
                block = blocks[c.offset + (my * v + by) * c.blocks_w + mx * h + bx]
                if kind == "dc_first":
                    t = symbol(tabs[s])
                    if t > 15:
                        raise ValueError("JPEG entropy data holds an invalid Huffman code.")
                    if t:
                        preds[s] += extend(bits(t), t)
                    block[0] = _w16(preds[s] << al)
                elif kind == "dc_refine":
                    if bits(1):
                        block[0] = _w16(block[0] | p1)
                elif kind == "ac_first":
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        rs = symbol(tabs[0])
                        r, t = rs >> 4, rs & 15
                        if t:
                            k += r
                            block[natural[k]] = _w16(extend(bits(t), t) << al)
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = (1 << r) + (bits(r) if r else 0) - 1
                            break
                        k += 1
                else:  # ac_refine
                    k = ss
                    if eobrun == 0:
                        while k <= se:
                            rs = symbol(tabs[0])
                            r, t = rs >> 4, rs & 15
                            if t:
                                t = p1 if bits(1) else m1  # a newly nonzero coefficient
                            elif r != 15:
                                eobrun = (1 << r) + (bits(r) if r else 0)
                                break
                            # Past r zero coefficients, with a correction bit
                            # for each nonzero one on the way.
                            while True:
                                if block[natural[k]]:
                                    correct(block, k)
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                                if k > se:
                                    break
                            if t:
                                block[natural[k]] = t
                            k += 1
                    if eobrun:
                        while k <= se:
                            if block[natural[k]]:
                                correct(block, k)
                            k += 1
                        eobrun -= 1
        if p > n_bits:
            raise ValueError("JPEG entropy data ends before its last block.")
        if mcu == total:
            break
        pos = _skip_restart(data, end, n_restarts % 8)
        n_restarts += 1


def coefficients_plain(data: bytes, header: Header) -> np.ndarray:
    """Every block's coefficients, (blocks, 64) int16, natural order."""
    coefs = np.zeros((header.blocks, 64), np.int16)
    if header.progressive:
        blocks = [[0] * 64 for _ in range(header.blocks)]
        for scan in header.scans:
            decode_progressive_scan_plain(data, header, scan, blocks)
        return np.array(blocks, np.int64).astype(np.int16)
    for scan in header.scans:
        decode_scan_plain(data, header, scan, coefs)
    return coefs


# --------------------------------------------------------------------------- #
# Stages 2-4, plain: PyTorch integer code (the kernels' reference)
# --------------------------------------------------------------------------- #

# jidctint.c's constants: FIX(x) = round(x * 2^13).
_C = dict(c0_298=2446, c0_390=3196, c0_541=4433, c0_765=6270, c0_899=7373, c1_175=9633,
          c1_501=12299, c1_847=15137, c1_961=16069, c2_053=16819, c2_562=20995, c3_072=25172)


def _idct_1d(x, shift: int):
    """One 1-D pass of ``jpeg_idct_islow`` on the eight inputs ``x`` (int64
    tensors), descaled by ``shift``."""
    c = _C
    z1 = (x[2] + x[6]) * c["c0_541"]
    tmp2 = z1 - x[6] * c["c1_847"]
    tmp3 = z1 + x[2] * c["c0_765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["c1_175"]
    t0, t1, t2, t3 = t0 * c["c0_298"], t1 * c["c2_053"], t2 * c["c3_072"], t3 * c["c1_501"]
    z1, z2 = z1 * -c["c0_899"], z2 * -c["c2_562"]
    z3, z4 = z3 * -c["c1_961"] + z5, z4 * -c["c0_390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return [(o + half) >> shift for o in outs]


def idct_plain(coefs: torch.Tensor, quant: torch.Tensor, block_comp: torch.Tensor) -> torch.Tensor:
    """Stage 2: (blocks, 64) int16 coefficients, (components, 64) quant
    tables and each block's component -> (blocks, 8, 8) uint8 samples."""
    z = (coefs.long() * quant.long()[block_comp]).view(-1, 8, 8)
    cols = _idct_1d([z[:, k, :] for k in range(8)], 11)  # pass 1: columns, 8 rows out
    ws = torch.stack(cols, 1).int().long()  # libjpeg's int workspace
    rows = _idct_1d([ws[:, :, k] for k in range(8)], 18)  # pass 2: rows
    out = torch.stack(rows, 2)
    out = ((out + 512) & 1023) - 512  # the post-IDCT table wraps at 10 bits
    return (out + 128).clamp(0, 255).to(torch.uint8)


def planes_of(samples: torch.Tensor, header: Header) -> List[torch.Tensor]:
    """(blocks, 8, 8) samples -> each component's plane, (blocks_h * 8,
    blocks_w * 8)."""
    out = []
    for c in header.components:
        b = samples[c.offset:c.offset + c.blocks_w * c.blocks_h]
        out.append(b.view(c.blocks_h, c.blocks_w, 8, 8).permute(0, 2, 1, 3)
                   .reshape(c.blocks_h * 8, c.blocks_w * 8))
    return out


REPLICATE, H2V1, H2V2, H1V2 = 0, 1, 2, 3
COLOR_MODES = {"gray": 0, "ycc": 1, "rgb": 2, "cmyk": 3, "ycck": 4}


def upsampling(header: Header, comp: Component) -> Tuple[int, int, int]:
    """(horizontal factor, vertical factor, method) by which libjpeg-turbo's
    ``jinit_upsampler`` brings a component to full size: ``h2v1_fancy``,
    ``h2v2_fancy`` (for planes more than 2 samples wide) or ``h1v2_fancy``
    upsampling, else plain replication (``fullsize``, ``h2v1``, ``h2v2`` and
    ``int_upsample``)."""
    hs, vs = header.hmax // comp.h, header.vmax // comp.v
    if (hs, vs) == (2, 1) and comp.width > 2:
        return hs, vs, H2V1
    if (hs, vs) == (2, 2) and comp.width > 2:
        return hs, vs, H2V2
    if (hs, vs) == (1, 2):
        return hs, vs, H1V2
    return hs, vs, REPLICATE


def _upsample_plain(plane: torch.Tensor, comp: Component, header: Header) -> torch.Tensor:
    """Stage 3: a component's plane to (height, width) int32 as
    :func:`upsampling` says: the fancy upsamplers' 3:1 triangles (edge
    samples replicated at the component's downsampled size), or plain
    replication."""
    hs, vs, method = upsampling(header, comp)
    x = plane[:comp.height, :comp.width].int()
    if method == H2V2:  # 3:1 on rows, then on columns, rounding 8 then 7
        above = torch.cat([x[:1], x[:-1]], 0)
        below = torch.cat([x[1:], x[-1:]], 0)
        sums = torch.stack([3 * x + above, 3 * x + below], 1).reshape(-1, x.shape[1])
        left = torch.cat([sums[:, :1], sums[:, :-1]], 1)
        right = torch.cat([sums[:, 1:], sums[:, -1:]], 1)
        x = torch.stack([(3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4], 2)
        x = x.reshape(sums.shape[0], -1)
    elif method == H2V1:  # 3:1 on columns, rounding 1 then 2
        left = torch.cat([x[:, :1], x[:, :-1]], 1)
        right = torch.cat([x[:, 1:], x[:, -1:]], 1)
        x = torch.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], 2).reshape(x.shape[0], -1)
    elif method == H1V2:  # 3:1 on rows, rounding 1 then 2
        above = torch.cat([x[:1], x[:-1]], 0)
        below = torch.cat([x[1:], x[-1:]], 0)
        x = torch.stack([(3 * x + above + 1) >> 2, (3 * x + below + 2) >> 2], 1).reshape(-1, x.shape[1])
    else:
        x = x.repeat_interleave(vs, 0).repeat_interleave(hs, 1)
    return x[:header.height, :header.width]


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's integer YCbCr -> R, G, B (SCALEBITS 16), clamped."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb - 46802 * cr + 32768) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return [v.clamp(0, 255) for v in (r, g, b)]


def cmyk_to_bgr(c, m, y, k):
    """OpenCV's ``icvCvt_CMYK2BGR_8u_C4C3R`` (the inverted Adobe CMYK that
    libjpeg returns): each of C, M, Y becomes ``k - ((255 - v) * k >> 8)``,
    written B, G, R from Y, M, C."""
    return [k - (((255 - v) * k) >> 8) for v in (y, m, c)]


def color_plain(planes: List[torch.Tensor], header: Header) -> torch.Tensor:
    """Stages 3 and 4: component planes -> (H, W) gray or (H, W, 3) BGR
    uint8, by the header's colour space: YCbCr through jdcolor.c's tables,
    RGB as stored, CMYK and YCCK (YCbCr to R, G, B, each inverted to C, M,
    Y; K as stored) through OpenCV's CMYK conversion."""
    h, w = header.height, header.width
    if header.color == "gray":
        return planes[0][:h, :w].contiguous()
    v = [_upsample_plain(p, c, header) for p, c in zip(planes, header.components)]
    if header.color == "ycc":
        r, g, b = _ycc_to_rgb(*v)
        out = [b, g, r]
    elif header.color == "rgb":
        out = v[2::-1]
    else:
        cmy = v[:3] if header.color == "cmyk" else [255 - x for x in _ycc_to_rgb(*v[:3])]
        out = cmyk_to_bgr(*cmy, v[3])
    return torch.stack(out, 2).clamp(0, 255).to(torch.uint8)


# --------------------------------------------------------------------------- #
# Block smoothing, plain: jdcoefct.c's decompress_smooth_data (J6's reference)
# --------------------------------------------------------------------------- #

#: The natural positions of zigzag coefficients 1-9: AC01, AC10, AC20,
#: AC11, AC02, AC03, AC12, AC21, AC30.
SMOOTH_POS = ZIGZAG[1:SMOOTH_COEFS].tolist()
#: Each estimate's weights on the 5 x 5 DC values around the block (rows
#: above to below, columns left to right; libjpeg-turbo's DC01-DC25), with
#: DC interpolation (``change_dc``: the component has no AC data yet) and
#: without it (coefficients 1-5 only); the last row is the DC estimate.
_W_CHANGE_DC = np.array([
    [-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1],
    [-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1],
    [0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0],
    [-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1],
    [0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0],
    [-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2],
], np.int64)
_W_AC = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0],
    [0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0],
    [0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
], np.int64)


def smooth_rows(hib: int, v: int, total: int) -> np.ndarray:
    """(hib, 5) the block rows whose DC values ``decompress_smooth_data``
    reads for each block row: two above, itself, two below, edges
    replicated by its test on ``image_block_row``, which counts the rows of
    the last iMCU row as if every iMCU row had as many."""
    out = np.empty((hib, 5), np.int64)
    for r in range(hib):
        i, br = divmod(r, v)
        rows = v if i < total - 1 else (hib % v or v)
        ibr, ibrs = i * rows + br, rows * total
        prev = r - 1 if ibr > 0 else r
        prev2 = r - 2 if ibr > 1 else prev
        nxt = r + 1 if ibr < ibrs - 1 else r
        nxt2 = r + 2 if ibr < ibrs - 2 else nxt
        out[r] = (prev2, prev, r, nxt, nxt2)
    return out


def smooth_params(header: Header) -> np.ndarray:
    """(components, 32) int32, J6's and :func:`smooth_plain`'s arguments per
    component: block offset, blocks a row of the buffer, blocks across and
    down the image, block rows an iMCU row, iMCU rows, coef_bits of zigzag
    coefficients 1-9, the quantisation values of coefficients 0-9 (DC,
    then :data:`SMOOTH_POS`), then the block rows of the buffer. A lone
    component's iMCU row is as many block rows as its frame header
    declares (libjpeg keeps ``v_samp_factor``); the buffer holds only its
    image's rows, and a row past them reads as zeros, as libjpeg's
    pre-zeroed padding row does."""
    out = np.zeros((len(header.components), 32), np.int32)
    lone = len(header.components) == 1
    vmax = header.components[0].declared_v if lone else header.vmax
    total = -(-header.height // (8 * vmax))
    for ci, c in enumerate(header.components):
        q = header.quant[ci].astype(np.int64)
        out[ci, :6] = (c.offset, c.blocks_w, -(-c.width // 8), -(-c.height // 8),
                       vmax if lone else c.v, total)
        out[ci, 6:15] = header.coef_bits[ci][1:SMOOTH_COEFS]
        out[ci, 15:25] = [q[0]] + [q[p] for p in SMOOTH_POS]
        out[ci, 25] = c.blocks_h
    return out


def _estimate(num: torch.Tensor, q: int, al: int) -> torch.Tensor:
    """``pred`` of ``decompress_smooth_data``: |num| rounded to a multiple of
    ``q << 8``, capped below ``1 << al`` where ``al`` > 0, with num's sign."""
    pred = ((q << 7) + num.abs()) // (q << 8)
    if al > 0:
        pred = pred.clamp(max=(1 << al) - 1)
    return torch.where(num >= 0, pred, -pred)


def smooth_plain(coefs: torch.Tensor, header: Header) -> torch.Tensor:
    """Block smoothing, as libjpeg-turbo 3's ``decompress_smooth_data``
    computes it where ``smoothing_ok`` holds: (blocks, 64) int16
    coefficients -> new ones, each block's AC coefficients 1-9 that are
    zero and short of full precision estimated from the 5 x 5 DC values
    around it (its DC too, where the component has no AC data yet); blocks
    outside the image are copied."""
    out = coefs.clone()
    for ci, p in enumerate(smooth_params(header)):
        offset, bw, wib, hib, v, total = (int(x) for x in p[:6])
        bits, quant = p[6:15].tolist(), p[15:25].tolist()
        bh = int(p[25])
        blocks = coefs[offset:offset + bw * bh].view(bh, bw, 64)
        dc = torch.cat([blocks[..., 0].long(), blocks.new_zeros((1, bw), dtype=torch.long)])
        rows = torch.from_numpy(smooth_rows(hib, v, total))
        cols = (torch.arange(wib)[:, None] + torch.arange(-2, 3)[None]).clamp(0, wib - 1)
        window = dc[rows[:, :, None, None], cols[None, None]]  # (hib, 5, wib, 5)
        window = window.permute(0, 2, 1, 3).reshape(hib, wib, 25)
        change_dc = all(b == -1 for b in bits)
        weights = torch.from_numpy(_W_CHANGE_DC if change_dc else _W_AC)
        work = blocks[:hib, :wib].long().clone()
        for k, (pos, al) in enumerate(zip(SMOOTH_POS, bits)):
            if k >= (9 if change_dc else 5) or al == 0:
                continue
            num = quant[0] * (window * weights[k]).sum(-1)
            est = _estimate(num, quant[k + 1], al)
            work[..., pos] = torch.where(work[..., pos] == 0, est, work[..., pos])
        if change_dc:
            work[..., 0] = _estimate(quant[0] * (window * weights[-1]).sum(-1), quant[0], 0)
        view = out[offset:offset + bw * bh].view(bh, bw, 64)
        view[:hib, :wib] = ((work + 0x8000) & 0xFFFF) - 0x8000  # JCOEF is 16-bit
    return out


def block_components(header: Header) -> torch.Tensor:
    """Each block's component index, (blocks,) int64."""
    return torch.cat([torch.full((c.blocks_w * c.blocks_h,), i, dtype=torch.int64)
                      for i, c in enumerate(header.components)])


def decode_plain(data: bytes, colorspace: Optional[str] = None) -> np.ndarray:
    """The plain version of :func:`imdecode`: Python and PyTorch on the CPU."""
    data = bytes(data)
    header = parse(data, colorspace)
    coefs = torch.from_numpy(coefficients_plain(data, header))
    if header.smooth:
        coefs = smooth_plain(coefs, header)
    samples = idct_plain(coefs, torch.from_numpy(header.quant.astype(np.int32)),
                         block_components(header))
    return color_plain(planes_of(samples, header), header).numpy()


# --------------------------------------------------------------------------- #
# The card's route: host entropy decoder, J1 and J2
# --------------------------------------------------------------------------- #

def decode_scan_host(data: bytes, header: Header, scan: Scan, coefs: torch.Tensor) -> None:
    """Stage 1 in host C (``sleap_jpeg_decode_scan``, or
    ``sleap_jpeg_decode_progressive`` for a progressive scan) into
    ``coefs``, a (blocks, 64) int16 CPU tensor (pinned on the card's
    route)."""
    from sleap_tpu_torch.ops import _build

    mcux, mcuy, shape = _scan_geometry(header, scan)
    info = []
    for slot, ci in enumerate(scan.comps):
        c = header.components[ci]
        info += [c.offset, c.blocks_w, *shape[slot]]
    info = np.array(info, np.int32)
    luts = np.stack(scan.luts) if scan.luts else np.zeros((1, 1 << 16), np.uint16)
    buf = np.frombuffer(data, np.uint8)
    common = (buf.ctypes.data, len(data), scan.start, luts.ctypes.data, len(scan.comps),
              info.ctypes.data, mcux, mcuy, scan.restart)
    scratch = _scratch(len(data) + 16).ctypes.data
    if scan.kind == "sequential":
        err = _build.entry("sleap_jpeg_decode_scan")(*common, coefs.data_ptr(), scratch)
    else:
        err = _build.entry("sleap_jpeg_decode_progressive")(
            *common, scan.ss, scan.se, scan.ah, scan.al, coefs.data_ptr(), scratch)
    if err:
        raise ValueError(f"JPEG entropy data is malformed (host decoder error {err}: "
                         f"{_HOST_ERRORS.get(err, 'unknown')}).")


_HOST_ERRORS = {1: "invalid Huffman code", 2: "data ends before its last block",
                3: "restart marker missing or out of order"}


@functools.lru_cache(maxsize=8)
def _buffer(nbytes: int, thread: int) -> np.ndarray:
    return np.empty(nbytes, np.uint8)


def _scratch(nbytes: int) -> np.ndarray:
    """A host buffer of at least ``nbytes``, reused across frames by the
    calling thread (sizes rounded up to a power of two, so one serves a
    whole video; the eight last sizes and threads are kept). Each thread
    has its own: the host coders release the GIL, so a render's reader
    thread decodes while its caller encodes."""
    return _buffer(1 << max(16, (nbytes - 1).bit_length()), threading.get_ident())


def coefficients_host(data: bytes, header: Header, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every block's coefficients from the host C decoder, (blocks, 64) int16,
    into ``out`` where given."""
    if out is None:
        out = torch.empty((header.blocks, 64), dtype=torch.int16)
    if out.shape != (header.blocks, 64) or out.dtype != torch.int16 or out.device.type != "cpu" \
            or not out.is_contiguous():
        raise ValueError(f"The host decoder writes a contiguous ({header.blocks}, 64) int16 CPU "
                         f"tensor, not {tuple(out.shape)} {out.dtype} on {out.device}.")
    out.zero_()
    for scan in header.scans:
        decode_scan_host(data, header, scan, out)
    return out


def _check_card(t: torch.Tensor, dtype, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} CUDA tensor, not "
                         f"{t.dtype} on {t.device}{'' if t.is_contiguous() else ' (strided)'}.")


def idct_cuda(coefs: torch.Tensor, quant: torch.Tensor, header: Header) -> torch.Tensor:
    """J1 (``jpeg_idct_kernel``): :func:`idct_plain` on the card, (blocks,
    64) int16 coefficients and (components, 64) int32 quant tables ->
    (blocks, 8, 8) uint8 samples."""
    from sleap_tpu_torch.ops import _build

    _check_card(coefs, torch.int16, "coefficients")
    _check_card(quant, torch.int32, "quantisation tables")
    comps = header.components
    if coefs.shape != (header.blocks, 64) or quant.shape != (len(comps), 64):
        raise ValueError(f"coefficients {tuple(coefs.shape)} and tables {tuple(quant.shape)} do not "
                         f"fit a frame of {header.blocks} blocks and {len(comps)} components.")
    out = torch.empty((header.blocks, 8, 8), dtype=torch.uint8, device=coefs.device)
    ends = [c.offset + c.blocks_w * c.blocks_h for c in comps[:3]]
    ends += [header.blocks] * (3 - len(ends))
    _build.launch("sleap_jpeg_idct", coefs.device.index, coefs.data_ptr(), header.blocks,
                  quant.data_ptr(), *ends, out.data_ptr())
    idct_cuda.launches += 1
    return out


idct_cuda.launches = 0


def smooth_cuda(coefs: torch.Tensor, header: Header) -> torch.Tensor:
    """J6 (``jpeg_smooth_kernel``): :func:`smooth_plain` on the card,
    (blocks, 64) int16 coefficients -> smoothed ones, one thread a block."""
    from sleap_tpu_torch.ops import _build

    _check_card(coefs, torch.int16, "coefficients")
    if coefs.shape != (header.blocks, 64):
        raise ValueError(f"coefficients {tuple(coefs.shape)} do not fit a frame of {header.blocks} "
                         "blocks.")
    if coefs.data_ptr() % 16:
        raise ValueError("J6 reads each block's coefficients as 16-byte words: the coefficients "
                         "must start on a 16-byte boundary.")
    params = np.ascontiguousarray(smooth_params(header))
    out = torch.empty_like(coefs)
    _build.launch("sleap_jpeg_smooth", coefs.device.index, coefs.data_ptr(), header.blocks,
                  params.ctypes.data, len(header.components), out.data_ptr())
    smooth_cuda.launches += 1
    return out


smooth_cuda.launches = 0


def color_cuda(samples: torch.Tensor, header: Header) -> torch.Tensor:
    """J2 (``jpeg_color_kernel``): :func:`color_plain` on the card, from the
    (blocks, 8, 8) samples J1 writes -> (H, W) or (H, W, 3) BGR uint8."""
    from sleap_tpu_torch.ops import _build

    _check_card(samples, torch.uint8, "samples")
    if samples.shape != (header.blocks, 8, 8):
        raise ValueError(f"samples {tuple(samples.shape)} do not fit a frame of {header.blocks} "
                         "blocks.")
    h, w, comps = header.height, header.width, header.components
    shape = (h, w) if len(comps) == 1 else (h, w, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=samples.device)
    info = []
    for c in comps + comps[:1] * (4 - len(comps)):
        info += [c.offset, c.blocks_w, c.width, c.height, *upsampling(header, c)]
    _build.launch("sleap_jpeg_color", samples.device.index, samples.data_ptr(),
                  COLOR_MODES[header.color], h, w, *info, out.data_ptr())
    color_cuda.launches += 1
    return out


color_cuda.launches = 0


@functools.lru_cache(maxsize=8)
def _pinned(nbytes: int, thread: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _staging(blocks: int) -> torch.Tensor:
    """A pinned (blocks, 64) int16 buffer, reused across frames by the
    calling thread, as :func:`_scratch` is: its copy to the card is
    synchronous, so the thread's next frame may fill it at once."""
    size = 1 << max(12, (blocks * 128 - 1).bit_length())
    return _pinned(size, threading.get_ident())[:blocks * 128].view(torch.int16).view(blocks, 64)


def decode_cuda(data: bytes, device, colorspace: Optional[str] = None) -> torch.Tensor:
    """The card's route, the frame left on ``device``: the host entropy
    decoder, J6 where libjpeg-turbo smooths the blocks, J1, J2."""
    data = bytes(data)
    header = parse(data, colorspace)
    coefs = coefficients_host(data, header, _staging(header.blocks))
    device = torch.device(device)
    on_card = coefs.to(device)
    if header.smooth:
        on_card = smooth_cuda(on_card, header)
    quant = torch.from_numpy(header.quant.astype(np.int32)).to(device)
    return color_cuda(idct_cuda(on_card, quant, header), header)


def imdecode(data: bytes, device="cuda", colorspace: Optional[str] = None) -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` for the JPEGs this module
    reads: (H, W) gray, or (H, W, 3) BGR; decoded on ``device``'s route.
    ``colorspace`` ("ycc" or "rgb") overrides the markers' colour space."""
    if torch.device(device).type == "cuda":
        return decode_cuda(data, device, colorspace).cpu().numpy()
    return decode_plain(data, colorspace)


def with_tables(tables: bytes, stream: bytes) -> bytes:
    """An abbreviated JPEG stream (a JPEG-in-TIFF strip or tile) with the
    tables-only stream ``tables`` (the JPEGTables tag) put ahead of its
    markers, as libtiff hands both to libjpeg."""
    stream = bytes(stream)
    if not tables:
        return stream
    tables = bytes(tables)
    if tables[:2] != b"\xff\xd8" or stream[:2] != b"\xff\xd8":
        raise ValueError("JPEG-in-TIFF tables or strip lack their SOI marker.")
    end = tables.rfind(b"\xff\xd9")
    return tables[:end if end > 0 else len(tables)] + stream[2:]


# --------------------------------------------------------------------------- #
# Encoding: cv2.imencode(".jpg", img) at cv2's defaults
# --------------------------------------------------------------------------- #

QUALITY = 95  # cv2's IMWRITE_JPEG_QUALITY default, the only quality the JAX package writes

# The standard quantisation tables (ITU T.81 Annex K, natural order), which
# jcparam.c's jpeg_set_quality scales.
STD_LUMA = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
            14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
            18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
            49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99)
STD_CHROMA = (17, 18, 24, 47) + (99,) * 4 + (18, 21, 26, 66) + (99,) * 4 + (24, 26, 56) + (99,) * 5 \
    + (47, 66) + (99,) * 38

# The standard Huffman tables (Annex K.3, jstdhuff.c) as DHT bodies: 16
# counts of codes by length, then the symbols. DC luma, AC luma, DC chroma,
# AC chroma, which cv2 writes in that order.
STD_HUFFMAN = tuple(bytes.fromhex(h) for h in (
    "00010501010101010100000000000000000102030405060708090a0b",
    "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
    "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
    "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3"
    "e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "00030101010101010101010000000000000102030405060708090a0b",
    "0002010204040304070504040001027700010203110405213106124151076171132232810814429"
    "1a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a4344454647"
    "48494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495"
    "969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9"
    "dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
))


def quant_table(basic, quality: int = QUALITY) -> np.ndarray:
    """``jpeg_add_quant_table(..., jpeg_quality_scaling(quality), TRUE)``:
    a standard table scaled, clamped to 1..255 (baseline), natural order."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    t = (np.asarray(basic, np.int64) * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.uint16)


def divisors(quant: np.ndarray) -> np.ndarray:
    """``jcdctmgr.c``'s ``compute_reciprocal`` for each entry of a table, with
    libjpeg-turbo's SIMD types (``DCTELEM`` short): (3, 64) int32 rows of the
    reciprocal, the correction (rounding) and the shift past 16 bits, for
    the divisor ``quantval << 3`` (the DCT leaves its output scaled by 8)."""
    out = np.empty((3, 64), np.int32)
    for i, q in enumerate(np.asarray(quant, np.int64)):
        d = int(q) << 3
        if d == 1:
            out[:, i] = (1, 0, -16)
            continue
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two: fq is one bit too wide
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        out[:, i] = (fq, c, r - 16)
    return out


@dataclass
class Frame:
    """An encoded frame's layout, as libjpeg lays out cv2's defaults: gray is
    one component of 8x8 MCUs; colour is Y, Cb, Cr sampled 2x2, 1x1, 1x1
    (4:2:0) in MCUs of 16x16. Each component's DCT blocks (``blocks_w`` x
    ``blocks_h``, libjpeg's ``width_in_blocks`` and ``height_in_blocks``)
    lie row-major at ``offset`` of the frame's (blocks, 64) buffers; the
    MCUs may reach past them on the right and bottom of Y, where the
    encoder writes libjpeg's dummy blocks."""

    height: int
    width: int
    components: List[Component]
    mcux: int
    mcuy: int

    @property
    def blocks(self) -> int:
        return sum(c.blocks_w * c.blocks_h for c in self.components)


def frame_layout(height: int, width: int, channels: int) -> Frame:
    """The layout of an (height, width) frame of 1 or 3 channels."""
    height, width = int(height), int(width)
    if height < 1 or width < 1 or height > 65535 or width > 65535:
        raise ValueError(f"A JPEG frame is 1 to 65535 pixels a side, not {height} x {width}.")
    if channels not in (1, 3):
        raise ValueError(f"JPEG frames are encoded from 1 or 3 channels, not {channels}.")
    if channels == 1:
        bw, bh = -(-width // 8), -(-height // 8)
        return Frame(height, width, [Component(1, 1, 1, 0, width, height, bw, bh, 0)], bw, bh)
    mcux, mcuy = -(-width // 16), -(-height // 16)
    bw, bh = -(-width // 8), -(-height // 8)
    y = Component(1, 2, 2, 0, width, height, bw, bh, 0)
    cb = Component(2, 1, 1, 1, -(-width // 2), -(-height // 2), mcux, mcuy, bw * bh)
    cr = Component(3, 1, 1, 1, cb.width, cb.height, mcux, mcuy, bw * bh + mcux * mcuy)
    return Frame(height, width, [y, cb, cr], mcux, mcuy)


def _as_frame(img) -> np.ndarray:
    """(H, W), (H, W, 1) or (H, W, 3) uint8 as (H, W) or (H, W, 3)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"JPEG frames are encoded from uint8, not {img.dtype}.")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"JPEG frames are (H, W), (H, W, 1) or (H, W, 3) BGR, not {img.shape}.")
    return np.ascontiguousarray(img)


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


# jccolor.c's rgb_ycc_convert coefficients (SCALEBITS 16): Y adds ONE_HALF,
# Cb and Cr add CBCR_OFFSET + ONE_HALF - 1.
YCC = ((_fix16(0.299), _fix16(0.587), _fix16(0.114), 1 << 15),
       (-_fix16(0.16874), -_fix16(0.33126), _fix16(0.5), (128 << 16) + (1 << 15) - 1),
       (_fix16(0.5), -_fix16(0.41869), -_fix16(0.08131), (128 << 16) + (1 << 15) - 1))


def tiles(plane: torch.Tensor) -> torch.Tensor:
    """(8 * bh, 8 * bw) -> (bh * bw, 64): the plane's 8x8 blocks row-major."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3).reshape(bh * bw, 64)


def _edge(plane: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``plane`` grown to (rows, cols) by repeating its last row and column."""
    r = torch.arange(rows, device=plane.device).clamp(max=plane.shape[0] - 1)
    c = torch.arange(cols, device=plane.device).clamp(max=plane.shape[1] - 1)
    return plane[r][:, c]


def ycc_plain(img: torch.Tensor, frame: Frame) -> torch.Tensor:
    """J3's stages, plain: (H, W) gray or (H, W, 3) BGR uint8 -> the
    components' (blocks, 64) uint8 samples. Colour converts with
    ``rgb_ycc_convert``; the right and bottom edges repeat to whole blocks
    (``expand_right_edge``, ``expand_bottom_edge``); chroma is downsampled
    by ``h2v2_downsample``, whose 2x2 sums add a bias of 1, 2, 1, 2, ...
    along each output row, then repeats its last row to whole MCUs."""
    y = frame.components[0]
    if len(frame.components) == 1:
        return tiles(_edge(img, 8 * y.blocks_h, 8 * y.blocks_w))
    b, g, r = (img[..., k].long() for k in range(3))
    planes = [(cr * r + cg * g + cb * b + add) >> 16 for cr, cg, cb, add in YCC]
    out = [tiles(_edge(planes[0], 8 * y.blocks_h, 8 * y.blocks_w))]
    for plane, c in zip(planes[1:], frame.components[1:]):
        p = _edge(plane, 2 * c.height, 16 * c.blocks_w)
        sums = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        bias = 1 + (torch.arange(sums.shape[1], device=sums.device) & 1)
        out.append(tiles(_edge((sums + bias) >> 2, 8 * c.blocks_h, 8 * c.blocks_w)))
    return torch.cat(out).to(torch.uint8)


def _fdct_1d(d, pass1: bool):
    """One 1-D pass of ``jpeg_fdct_islow`` (CONST_BITS 13, PASS1_BITS 2) on
    the eight int64 tensors ``d``: pass 1 scales by 4, pass 2 removes it
    and leaves the output scaled by 8."""
    c = _C
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = 11 if pass1 else 15

    def descale(x, bits):
        return (x + (1 << (bits - 1))) >> bits

    out = [None] * 8
    out[0] = (tmp10 + tmp11) << 2 if pass1 else descale(tmp10 + tmp11, 2)
    out[4] = (tmp10 - tmp11) << 2 if pass1 else descale(tmp10 - tmp11, 2)
    z1 = (tmp12 + tmp13) * c["c0_541"]
    out[2] = descale(z1 + tmp13 * c["c0_765"], n)
    out[6] = descale(z1 - tmp12 * c["c1_847"], n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * c["c1_175"]
    tmp4, tmp5 = tmp4 * c["c0_298"], tmp5 * c["c2_053"]
    tmp6, tmp7 = tmp6 * c["c3_072"], tmp7 * c["c1_501"]
    z1, z2 = z1 * -c["c0_899"], z2 * -c["c2_562"]
    z3, z4 = z3 * -c["c1_961"] + z5, z4 * -c["c0_390"] + z5
    out[7] = descale(tmp4 + z1 + z3, n)
    out[5] = descale(tmp5 + z2 + z4, n)
    out[3] = descale(tmp6 + z2 + z3, n)
    out[1] = descale(tmp7 + z1 + z4, n)
    return out


def fdct_plain(samples: torch.Tensor, divs: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """J4's stages, plain: (blocks, 64) uint8 samples, the (tables, 3, 64)
    :func:`divisors` and each block's table -> (blocks, 64) int16 quantised
    coefficients, natural order. The samples are level-shifted by 128,
    transformed by ``jpeg_fdct_islow`` (rows, then columns, through 16-bit
    ``DCTELEM``) and quantised as ``jcdctmgr.c``'s ``quantize``:
    ``(|x| + corr) * recip >> (16 + shift)`` in unsigned 32 bits, the sign
    put back."""
    x = samples.view(-1, 8, 8).long() - 128
    rows = _fdct_1d([x[:, :, k] for k in range(8)], True)
    ws = torch.stack(rows, 2).to(torch.int16).long()  # DCTELEM between the passes
    cols = _fdct_1d([ws[:, k, :] for k in range(8)], False)
    coef = torch.stack(cols, 1).to(torch.int16).long().view(-1, 64)
    d = divs.long().to(coef.device)[block_table.to(coef.device)]
    recip, corr, shift = d[:, 0], d[:, 1], d[:, 2]
    q = (((coef.abs() + corr) * recip) & 0xFFFFFFFF) >> (shift + 16)
    return torch.where(coef < 0, -q, q).to(torch.int16)


def huffman_codes(table: bytes) -> Tuple[List[int], List[int]]:
    """``jpeg_make_c_derived_tbl``: each symbol's code and code length (0
    for a symbol the table lacks), from a DHT body."""
    counts, symbols = table[:16], table[16:]
    code, k = 0, 0
    ehufco, ehufsi = [0] * 256, [0] * 256
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            ehufco[symbols[k]], ehufsi[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return ehufco, ehufsi


@functools.lru_cache(maxsize=None)
def _std_codes():
    return tuple(huffman_codes(t) for t in STD_HUFFMAN)


def _mcu_units(frame: Frame):
    """The blocks of one MCU in coding order: (component slot, block row,
    block column)."""
    return [(s, by, bx) for s, c in enumerate(frame.components)
            for by in range(c.v if len(frame.components) > 1 else 1)
            for bx in range(c.h if len(frame.components) > 1 else 1)]


def encode_scan_plain(coefs: np.ndarray, frame: Frame) -> bytes:
    """The Huffman stage, plain (``jchuff.c``'s ``encode_one_block`` over
    the MCUs, as ``jccoefct.c`` feeds it): each block's DC difference from
    its component's last, then the AC run/size symbols with ZRL and EOB;
    a value ``v < 0`` is sent as the low bits of ``v - 1``. A block past
    the right or bottom edge of Y is libjpeg's dummy: no AC, and the DC of
    the block before it in the MCU. 0xFF bytes are stuffed with 0x00 and
    the last byte is padded with 1-bits. ``coefs``: (blocks, 64) int16."""
    codes = _std_codes()
    comps = frame.components
    tabs = [(codes[0], codes[1]) if c.tq == 0 else (codes[2], codes[3]) for c in comps]
    zigzag = ZIGZAG[1:64].tolist()
    rows = coefs.astype(np.int64).tolist()
    out = bytearray()
    acc, nacc = 0, 0
    last = [0] * len(comps)

    def put(code, size):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    units = _mcu_units(frame)
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            dc = None
            for s, uy, ux in units:
                c = comps[s]
                h, v = (c.h, c.v) if len(comps) > 1 else (1, 1)
                by, bx = my * v + uy, mx * h + ux
                (dco, dcs), (aco, acs) = tabs[s]
                if by < c.blocks_h and bx < c.blocks_w:
                    block = rows[c.offset + by * c.blocks_w + bx]
                    dc = block[0]
                    ac = [block[k] for k in zigzag]
                else:
                    ac = None  # a dummy block keeps the DC before it
                diff = dc - last[s]
                last[s] = dc
                t = -diff if diff < 0 else diff
                nbits = t.bit_length()
                put(dco[nbits], dcs[nbits])
                if nbits:
                    put((diff - 1 if diff < 0 else diff) & ((1 << nbits) - 1), nbits)
                run = 0
                for val in ac or ():
                    if val == 0:
                        run += 1
                        continue
                    while run > 15:
                        put(aco[0xF0], acs[0xF0])
                        run -= 16
                    t = -val if val < 0 else val
                    nbits = t.bit_length()
                    sym = (run << 4) | nbits
                    put(aco[sym], acs[sym])
                    put((val - 1 if val < 0 else val) & ((1 << nbits) - 1), nbits)
                    run = 0
                if run or ac is None:
                    put(aco[0], acs[0])
    if nacc:
        put((1 << (8 - nacc)) - 1, 8 - nacc)
    return bytes(out)


def _segment_bytes(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


@functools.lru_cache(maxsize=64)
def headers(height: int, width: int, channels: int) -> Tuple[bytes, bytes]:
    """The bytes before and after the entropy-coded data, in cv2's order:
    SOI; APP0 JFIF 1.01, density 1:1; a DQT per table; SOF0; a DHT per
    table, DC0, AC0, DC1, AC1; SOS; and EOI after the data."""
    frame = frame_layout(height, width, channels)
    comps = frame.components
    out = [b"\xff\xd8", _segment_bytes(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, basic in enumerate((STD_LUMA, STD_CHROMA)[:1 + (channels > 1)]):
        table = quant_table(basic)
        out.append(_segment_bytes(0xDB, bytes([t]) + table[ZIGZAG[:64]].astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for c in comps:
        sof += bytes([c.ident, (c.h << 4) | c.v, c.tq])
    out.append(_segment_bytes(0xC0, sof))
    for k, table in enumerate(STD_HUFFMAN[:2 * (1 + (channels > 1))]):
        out.append(_segment_bytes(0xC4, bytes([(k & 1) << 4 | (k >> 1)]) + table))
    sos = bytes([len(comps)])
    for c in comps:
        sos += bytes([c.ident, c.tq << 4 | c.tq])
    out.append(_segment_bytes(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(out), b"\xff\xd9"


@functools.lru_cache(maxsize=None)
def _divisor_tables() -> torch.Tensor:
    """(2, 3, 64) int32: the luma and chroma tables' :func:`divisors`."""
    return torch.from_numpy(np.stack([divisors(quant_table(t)) for t in (STD_LUMA, STD_CHROMA)]))


def block_tables(frame: Frame) -> torch.Tensor:
    """Each block's quantisation table, (blocks,) int64."""
    return torch.cat([torch.full((c.blocks_w * c.blocks_h,), c.tq, dtype=torch.int64)
                      for c in frame.components])


def encode_plain(img) -> bytes:
    """The plain version of :func:`imencode`: PyTorch and Python on the CPU."""
    img = _as_frame(img)
    channels = 1 if img.ndim == 2 else 3
    frame = frame_layout(img.shape[0], img.shape[1], channels)
    samples = ycc_plain(torch.from_numpy(img), frame)
    coefs = fdct_plain(samples, _divisor_tables(), block_tables(frame))
    head, tail = headers(frame.height, frame.width, channels)
    return head + encode_scan_plain(coefs.numpy(), frame) + tail


# --------------------------------------------------------------------------- #
# The card's encoding route: J3, J4 and the host entropy coder
# --------------------------------------------------------------------------- #


@functools.lru_cache(maxsize=None)
def _code_table() -> np.ndarray:
    """int32 (4, 2, 256): each standard table's codes and code lengths."""
    return np.array([list(t) for t in _std_codes()], np.int32)


def _encode_info(frame: Frame) -> np.ndarray:
    comps = frame.components
    info = []
    for c in comps:
        h, v = (c.h, c.v) if len(comps) > 1 else (1, 1)
        info += [c.offset, c.blocks_w, c.blocks_h, h, v, c.tq]
    return np.array(info, np.int32)


def encode_scan_host(coefs: torch.Tensor, frame: Frame) -> bytes:
    """The Huffman stage in host C (``sleap_jpeg_encode_scan``), from a
    contiguous (blocks, 64) int16 CPU tensor."""
    from sleap_tpu_torch.ops import _build

    if coefs.shape != (frame.blocks, 64) or coefs.dtype != torch.int16 \
            or coefs.device.type != "cpu" or not coefs.is_contiguous():
        raise ValueError(f"The host encoder reads a contiguous ({frame.blocks}, 64) int16 CPU "
                         f"tensor, not {tuple(coefs.shape)} {coefs.dtype} on {coefs.device}.")
    units = len(_mcu_units(frame)) * frame.mcux * frame.mcuy
    out = _scratch(512 * units + 64)  # a block codes to at most ~430 bytes, stuffed
    info, codes = _encode_info(frame), _code_table()
    written = np.zeros(1, np.int64)
    err = _build.entry("sleap_jpeg_encode_scan")(
        coefs.data_ptr(), len(frame.components), info.ctypes.data, frame.mcux, frame.mcuy,
        codes.ctypes.data, out.ctypes.data, out.size, written.ctypes.data)
    if err:
        raise RuntimeError("sleap_jpeg_encode_scan ran out of output buffer.")
    return out[:int(written[0])].tobytes()


def ycc_cuda(img: torch.Tensor, frame: Frame) -> torch.Tensor:
    """J3 (``jpeg_ycc_kernel``): :func:`ycc_plain` on the card, (H, W) gray
    or (H, W, 3) BGR uint8 -> (blocks, 64) uint8 samples."""
    from sleap_tpu_torch.ops import _build

    _check_card(img, torch.uint8, "the frame")
    ncomp = len(frame.components)
    want = (frame.height, frame.width) if ncomp == 1 else (frame.height, frame.width, 3)
    if tuple(img.shape) != want:
        raise ValueError(f"the frame {tuple(img.shape)} does not fit a layout of {want}.")
    y = frame.components[0]
    out = torch.empty((frame.blocks, 64), dtype=torch.uint8, device=img.device)
    _build.launch("sleap_jpeg_ycc", img.device.index, img.data_ptr(), frame.height, frame.width,
                  ncomp, y.blocks_w, y.blocks_h, frame.mcux, frame.mcuy, out.data_ptr())
    ycc_cuda.launches += 1
    return out


ycc_cuda.launches = 0


def fdct_cuda(samples: torch.Tensor, divs: torch.Tensor, frame: Frame) -> torch.Tensor:
    """J4 (``jpeg_fdct_kernel``): :func:`fdct_plain` on the card, (blocks,
    64) uint8 samples and the (2, 3, 64) int32 :func:`divisors` -> (blocks,
    64) int16 coefficients."""
    from sleap_tpu_torch.ops import _build

    _check_card(samples, torch.uint8, "samples")
    _check_card(divs, torch.int32, "divisor tables")
    if samples.shape != (frame.blocks, 64) or divs.shape != (2, 3, 64):
        raise ValueError(f"samples {tuple(samples.shape)} and divisors {tuple(divs.shape)} do not "
                         f"fit a frame of {frame.blocks} blocks.")
    y = frame.components[0]
    out = torch.empty((frame.blocks, 64), dtype=torch.int16, device=samples.device)
    _build.launch("sleap_jpeg_fdct", samples.device.index, samples.data_ptr(), frame.blocks,
                  divs.data_ptr(), y.blocks_w * y.blocks_h, out.data_ptr())
    fdct_cuda.launches += 1
    return out


fdct_cuda.launches = 0

@functools.lru_cache(maxsize=None)
def _card_divisors(device: torch.device) -> torch.Tensor:
    return _divisor_tables().to(device)


def card_divisors(device) -> torch.Tensor:
    """The :func:`divisors` of both tables on ``device``, uploaded once."""
    return _card_divisors(torch.device(device))


def encode_cuda(img, device) -> bytes:
    """The card's route: the frame to ``device``, J3, J4, one copy of the
    coefficients back, the host entropy coder and the markers."""
    img = _as_frame(img)
    channels = 1 if img.ndim == 2 else 3
    frame = frame_layout(img.shape[0], img.shape[1], channels)
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    samples = ycc_cuda(torch.from_numpy(img).to(device), frame)
    coefs = fdct_cuda(samples, card_divisors(device), frame).cpu()
    head, tail = headers(frame.height, frame.width, channels)
    return head + encode_scan_host(coefs, frame) + tail


def imencode(img, device="cuda") -> bytes:
    """``cv2.imencode(".jpg", img)[1].tobytes()`` at cv2's defaults (quality
    95, baseline, standard Huffman tables, 4:2:0 for colour, JFIF 1.01): the
    JPEG of an (H, W) or (H, W, 1) gray or (H, W, 3) BGR uint8 frame,
    encoded on ``device``'s route."""
    if torch.device(device).type == "cuda":
        return encode_cuda(img, device)
    return encode_plain(img)
