"""Read TIFF stills as ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` returns
them and write them as ``cv2.imencode(".tif", img)`` writes them (OpenCV 5
on libtiff 4.7), byte for byte: the port's TIFF codec for image folders,
``.pkg.slp`` and HDF5 frame rows and ImgStores, where ``cv2`` is not
installed.

Reading (:func:`imdecode`): the first directory (page 0, as ``cv2.imread``
reads a multi-page file) of a classic TIFF in either byte order, as cv2
(``grfmt_tiff.cpp`` on libtiff 4.7) reads it, by one of its two routes:

- 8-bit frames come from libtiff's RGBA reader (``tif_getimage.c``): 1-bit
  gray and palette, 4- and 8-bit palette (a colormap with an entry past 255
  cut to its high bytes, as ``checkcmap`` and ``cvtcmap`` do), 8-bit gray
  (min-is-white inverted; gray and alpha, and 16-bit gray and alpha by its
  high byte, to one channel), RGB(A) (unassociated alpha premultiplied),
  YCbCr (subsampling 1x1, 2x1, 2x2, 1x2, 4x1, 4x2 or 4x4, through
  ``TIFFYCbCrToRGB``'s integer tables with ReferenceBlackWhite) and CMYK (to
  BGRA, alpha opaque); then OpenCV's BGRA conversion to gray (a 1-bit
  palette), BGR or BGRA; uint8, or int8 where the samples are signed;
- wider samples as stored, min-is-white too: 16- and 32-bit integers,
  unsigned or signed, and 32- and 64-bit floats, of 1, 3 or 4 samples (BGR
  and BGRA); 16-bit gray of 3 or 4 samples through ``cvtColor``'s gray rule.

Then the orientation tag (2-8: flips, a transpose, turns) is applied. Strips
or tiles; chunky or planar-separate samples; no compression (1), CCITT
Modified Huffman (2), T.4 (3, 1-D and 2-D) and T.6 (4), LZW (5), JPEG (7:
each strip or tile with the JPEGTables tag ahead of it through
:mod:`~sleap_tpu_torch.io.jpeg`, RGB planes as stored, YCbCr converted as
libtiff has libjpeg convert it; tiles cropped at the image's edge), deflate
(8 and 32946) or PackBits (32773); predictor 1, 2 (horizontal differencing
on 8- to 64-bit words) or 3 (floating point); fill order 1 or 2. What cv2
gives no frame for raises :class:`UnsupportedTiff` naming the feature:
BigTIFF, planar-separate samples wider than 8 bits (cv2 reads unset
memory), 2- and 4-bit gray and other sub-byte layouts, uncompressed tiles of
8-bit samples, 16-bit floats, palettes, CMYK and YCbCr of 16 bits, YCbCr
subsampled 1x4, gray and alpha wider than 16 bits, old-style JPEG-in-TIFF
and LZW, CCITT's uncompressed mode, and other compressions and
photometric interpretations. :func:`transposed` tells the files
``cv2.imread`` refuses though ``cv2.imdecode`` reads them (orientations 5-8
of a frame that is not square).

Writing (:func:`imencode`): what cv2 writes for (H, W), (H, W, 1), (H, W, 3)
BGR and (H, W, 4) BGRA frames of uint8, uint16 or float32: samples in RGB(A)
order, ``max(1, 8192 // row_bytes)`` rows a strip, LZW with the horizontal
predictor for integers (uncompressed floats), the strips from byte 8, then
the directory at the next even offset with its twelve tags (eleven for
floats: no predictor), then the values that do not fit in an entry, in
libtiff's order (BitsPerSample, StripByteCounts, StripOffsets,
SampleFormat). LZW follows ``tif_lzw.c``'s ``LZWEncode``: a clear code
first, code widths that grow one code early, a clear code when the table
reaches 4094 entries and whenever the compression ratio stops improving at
a checkpoint every 10000 input bytes.

Two routes, by the ``device`` asked for:

- ``"cpu"``, the plain version: LZW, PackBits and CCITT in Python,
  predictors and the RGBA reader's conversions in numpy, deflate with
  ``zlib``, JPEG strips by ``io/jpeg.py``'s plain decoder;
- ``"cuda"``: LZW, PackBits and CCITT in host C (``sleap_tiff_lzw_decode``,
  ``sleap_tiff_lzw_encode``, ``sleap_tiff_packbits_decode``,
  ``sleap_tiff_packbits_encode`` and ``sleap_tiff_ccitt_decode`` in
  ``csrc/tiff.cu``, built into the kernel library), JPEG strips on the
  card's JPEG route (J6, J1, J2); the rest as on the CPU. A failed build
  raises; there is no fallback to the plain version.

No kernel: the JAX package reads and writes TIFF with cv2 on the host
(``sleap_tpu/io/video.py``, ``SingleImageVideo.get_frame``,
``HDF5Video.get_frame`` and ``Video.to_hdf5``; ``sleap_tpu/io/slp.py``;
``sleap_tpu/io/dirimgstore.py``).
"""

from __future__ import annotations

import functools
import struct
import zlib
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


class UnsupportedTiff(ValueError):
    """The file uses a TIFF feature outside the subset this module reads."""


# --------------------------------------------------------------------------- #
# LZW and PackBits, plain
# --------------------------------------------------------------------------- #

CODE_CLEAR, CODE_EOI, CODE_FIRST = 256, 257, 258
CODE_MAX = 4095  # MAXCODE(BITS_MAX): 12-bit codes
CHECK_GAP = 10000  # input bytes between compression-ratio checks


def _old_style(data: bytes) -> bool:
    """libtiff's test for the pre-5.0 (LSB-first) LZW variant."""
    return len(data) >= 2 and data[0] == 0 and data[1] & 1


def lzw_decode_plain(data: bytes, size: int) -> bytes:
    """``size`` bytes of an LZW-coded strip or tile, as ``tif_lzw.c``'s
    ``LZWDecode`` reads them: MSB-first codes of 9 to 12 bits, the width
    growing one code before the table needs it; a longer stream is cut at
    ``size`` bytes, a shorter one raises."""
    data = bytes(data)
    if _old_style(data):
        raise UnsupportedTiff("old-style (LSB-first, pre-TIFF 6.0) LZW is not supported.")
    n_bits = 8 * len(data)
    padded = data + b"\0\0\0"
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    p, nbits, prev = 0, 9, None
    while len(out) < size and p + nbits <= n_bits:
        q = p >> 3
        code = (int.from_bytes(padded[q:q + 3], "big") >> (24 - nbits - (p & 7))) & ((1 << nbits) - 1)
        p += nbits
        if code == CODE_EOI:
            break
        if code == CODE_CLEAR:
            del table[CODE_FIRST:]
            nbits, prev = 9, None
            continue
        if prev is None:  # the first code after a clear
            if code > CODE_CLEAR:
                raise ValueError("TIFF LZW data is corrupt (a clear code followed by a string code).")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) <= CODE_MAX:  # a full table takes no more
                table.append(prev + entry[:1])
        elif code == len(table) <= CODE_MAX:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"TIFF LZW data is corrupt (code {code} past the table's {len(table)}).")
        out += entry
        prev = entry
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    if len(out) < size:
        raise ValueError(f"TIFF LZW data ends after {len(out)} of {size} bytes.")
    return bytes(out[:size])


def lzw_encode_plain(data: bytes) -> bytes:
    """One strip LZW-coded as ``tif_lzw.c``'s ``LZWPreEncode``, ``LZWEncode``
    and ``LZWPostEncode`` code it, byte for byte."""
    data = bytes(data)
    out = bytearray()
    acc, nacc = 0, 0
    nbits, maxcode, free_ent = 9, 511, CODE_FIRST
    outcount, ratio, checkpoint, reset_at = 0, 0, CHECK_GAP, 0
    table: Dict[int, int] = {}

    def put(code: int) -> None:
        nonlocal acc, nacc, outcount
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
        outcount += nbits

    ent = -1
    if data:
        put(CODE_CLEAR)
        ent = data[0]
    for i in range(1, len(data)):
        c = data[i]
        key = (c << 12) | ent
        code = table.get(key)
        if code is not None:
            ent = code
            continue
        put(ent)
        ent = c
        table[key] = free_ent
        free_ent += 1
        if free_ent == CODE_MAX - 1:  # the table is full: clear it
            table.clear()
            ratio, outcount, free_ent, reset_at = 0, 0, CODE_FIRST, i + 1
            put(CODE_CLEAR)
            nbits, maxcode = 9, 511
        elif free_ent > maxcode:
            nbits += 1
            maxcode = (1 << nbits) - 1
        elif i + 1 - reset_at >= checkpoint:
            incount = i + 1 - reset_at
            checkpoint = incount + CHECK_GAP
            rat = (incount << 8) // outcount if incount <= 0x7FFFFF else \
                (0x7FFFFFFF if outcount >> 8 == 0 else incount // (outcount >> 8))
            if rat <= ratio:  # compression stopped improving: start afresh
                table.clear()
                ratio, outcount, free_ent, reset_at = 0, 0, CODE_FIRST, i + 1
                put(CODE_CLEAR)
                nbits, maxcode = 9, 511
            else:
                ratio = rat
    if ent >= 0:
        put(ent)
        free_ent += 1
        if free_ent == CODE_MAX - 1:
            put(CODE_CLEAR)
            nbits = 9
        elif free_ent > maxcode:
            nbits += 1
    put(CODE_EOI)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_decode_plain(data: bytes, size: int) -> bytes:
    """``size`` bytes of a PackBits strip or tile, as ``tif_packbits.c``'s
    ``PackBitsDecode`` reads them (runs past ``size`` cut; a header of -128
    skipped)."""
    data = bytes(data)
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < size:
        n = data[i]
        i += 1
        if n == 128:
            continue
        if n > 128:
            if i >= len(data):
                break
            out += data[i:i + 1] * min(257 - n, size - len(out))
            i += 1
        else:
            n = min(n + 1, size - len(out))
            if i + n > len(data):
                break
            out += data[i:i + n]
            i += n
    if len(out) < size:
        raise ValueError(f"TIFF PackBits data ends after {len(out)} of {size} bytes.")
    return bytes(out)


def packbits_encode_plain(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as a repeat, the bytes between
    them as literals of up to 128 (at most one header byte per 128 bytes)."""
    data = bytes(data)
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


# --------------------------------------------------------------------------- #
# CCITT (fax) decoding, plain
# --------------------------------------------------------------------------- #

# ITU-T T.4's run-length codes, as MSB-first bit strings: terminating codes
# for runs 0-63, then make-up codes for 64, 128, ..., 1728; the extended
# make-up codes (1792-2560) are the same for both colours.
WHITE_CODES = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 "
    "110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 "
    "0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 "
    "00010110 00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101 "
    "00001010 00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100 "
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
    "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
    "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
BLACK_CODES = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 "
    "000011010100 000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
    "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 000001100111 "
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
EXTENDED_CODES = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
                  "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
                  "000000011111").split()
#: The 2-D modes (T.4 4.2.1.3): pass, horizontal, vertical -3..3, as
#: (code, mode, offset); a code of seven zeros starts an extension or EOL.
MODE_CODES = (("0001", "pass", 0), ("001", "horizontal", 0), ("1", "vertical", 0),
              ("011", "vertical", 1), ("000011", "vertical", 2), ("0000011", "vertical", 3),
              ("010", "vertical", -1), ("000010", "vertical", -2), ("0000010", "vertical", -3))
CCITT_LOOKUP_BITS = 13  # the longest run code


def run_codes(colour: int) -> List[Tuple[str, int]]:
    """(code, run) of every run-length code of ``colour`` (0 white, 1 black)."""
    codes = WHITE_CODES if colour == 0 else BLACK_CODES
    runs = list(range(64)) + [64 * k for k in range(1, 28)]
    return list(zip(codes, runs)) + [(c, 1792 + 64 * k) for k, c in enumerate(EXTENDED_CODES)]


@functools.lru_cache(maxsize=2)
def run_lookup(colour: int) -> np.ndarray:
    """A table indexed by the next 13 bits: ``length << 12 | run`` of the
    code they start with, 0 where none does."""
    table = np.zeros(1 << CCITT_LOOKUP_BITS, np.int32)
    for code, run in run_codes(colour):
        lo = int(code, 2) << (CCITT_LOOKUP_BITS - len(code))
        table[lo:lo + (1 << (CCITT_LOOKUP_BITS - len(code)))] = len(code) << 12 | run
    return table


class _Bits:
    """An MSB-first bit reader over ``data``."""

    def __init__(self, data: bytes):
        self.data = data
        self.value = int.from_bytes(data, "big") if data else 0
        self.n = 8 * len(data)
        self.p = 0

    def peek(self, k: int) -> int:
        """The next ``k`` bits (zeros past the end)."""
        shift = self.n - self.p - k
        v = self.value >> shift if shift >= 0 else self.value << -shift
        return v & ((1 << k) - 1)

    def take(self, k: int) -> int:
        v = self.peek(k)
        self.p += k
        return v

    def check(self) -> None:
        if self.p > self.n:
            raise ValueError("TIFF CCITT data ends before its last row.")

    def align(self) -> None:
        self.p = -(-self.p // 8) * 8

    def eol(self) -> None:
        """Past the next EOL code (11 or more zeros and a one), as libtiff's
        ``SYNC_EOL`` finds it."""
        zeros = 0
        while zeros < 11 or not self.peek(1):
            if self.p >= self.n:
                raise ValueError("TIFF CCITT data ends before an EOL code.")
            zeros = zeros + 1 if not self.take(1) else 0
        self.p += 1


def _run(bits: _Bits, colour: int) -> int:
    """One run of ``colour``: make-up codes, then a terminating one."""
    table = run_lookup(colour)
    total = 0
    while True:
        look = int(table[bits.peek(CCITT_LOOKUP_BITS)])
        if not look:
            raise ValueError("TIFF CCITT data holds an invalid run-length code.")
        bits.p += look >> 12
        total += look & 0xFFF
        if look & 0xFFF < 64:
            bits.check()
            return total


def _line_1d(bits: _Bits, width: int) -> List[int]:
    """A 1-D coded row: its changing elements (white and black runs in
    turn, white first)."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 = min(a0 + _run(bits, colour), width)
        changes.append(a0)
        colour ^= 1
    return changes


def _line_2d(bits: _Bits, width: int, ref: List[int]) -> List[int]:
    """A 2-D coded row against the reference row's changing elements."""
    ref = ref + [width] * 3
    changes: List[int] = []
    a0, colour, i = -1, 0, 0
    while a0 < width:
        # b1: the first change on the reference row right of a0 that turns
        # to the opposite colour of a0's (even indices turn white to black).
        i = max(i - 1, 0)
        while ref[i] <= a0 or (i & 1) != colour:
            i += 1
        b1, b2 = ref[i], ref[i + 1]
        for code, mode, offset in MODE_CODES:
            if bits.peek(len(code)) == int(code, 2):
                bits.p += len(code)
                break
        else:
            raise ValueError("TIFF CCITT data holds an invalid 2-D mode code.")
        bits.check()
        if mode == "pass":
            a0 = b2
        elif mode == "horizontal":
            a1 = min(max(a0, 0) + _run(bits, colour), width)
            a2 = min(a1 + _run(bits, colour ^ 1), width)
            changes += [a1, a2]
            a0 = a2
        else:
            a1 = b1 + offset
            if a1 < max(a0, 0) or a1 > width:
                raise ValueError("TIFF CCITT data holds a vertical code past the row.")
            changes.append(a1)
            a0 = a1
            colour ^= 1
    return changes


def _row_bits(changes: List[int], width: int) -> np.ndarray:
    """Changing elements -> a row of packed bits, black (1) between each
    even-indexed change and the next."""
    edges = np.zeros(width + 1, np.int8)
    for k, x in enumerate(changes):
        edges[min(x, width)] ^= 1
    return np.packbits(np.bitwise_xor.accumulate(edges)[:width].astype(np.uint8))


def ccitt_decode_plain(data: bytes, width: int, rows: int, compression: int, options: int = 0) -> bytes:
    """``rows`` rows of a CCITT-coded strip or tile, packed MSB-first with
    black as 1 (as libtiff's ``tif_fax3.c`` writes them): Modified Huffman
    (2: 1-D rows, each from a byte boundary), T.4 (3: an EOL before each
    row; with bit 0 of ``options`` a tag bit after it, 1-D or 2-D) or T.6
    (4: 2-D rows against the one above, white above the first)."""
    bits = _Bits(bytes(data))
    ref: List[int] = []
    out = []
    for _ in range(rows):
        if compression == 2:
            changes = _line_1d(bits, width)
            bits.align()
        elif compression == 3:
            bits.eol()
            one_d = bits.take(1) if options & 1 else 1
            changes = _line_1d(bits, width) if one_d else _line_2d(bits, width, ref)
        else:
            changes = _line_2d(bits, width, ref)
        out.append(_row_bits(changes, width))
        ref = changes
    return b"".join(r.tobytes() for r in out)


# --------------------------------------------------------------------------- #
# LZW and PackBits in host C (the card's route)
# --------------------------------------------------------------------------- #

_HOST_ERRORS = {1: "the data ends before the strip does", 2: "a code past the table",
                3: "a clear code followed by a string code", 4: "the output buffer is too small"}


def _host(name: str, data: bytes, capacity: int) -> bytes:
    """Call host routine ``name`` on ``data`` into a buffer of ``capacity``
    bytes (a decoder's wanted size); its output."""
    from sleap_tpu_torch.ops import _build

    src = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(max(capacity, 1), np.uint8)
    written = np.zeros(1, np.int64)
    err = _build.entry(name)(src.ctypes.data, src.size, out.ctypes.data, capacity,
                             written.ctypes.data)
    if err == 1:
        kind = "LZW" if "lzw" in name else "PackBits"
        raise ValueError(f"TIFF {kind} data ends after {int(written[0])} of {capacity} bytes.")
    if err:
        raise ValueError(f"TIFF {'LZW' if 'lzw' in name else 'PackBits'} data is corrupt ({name}: "
                         f"{_HOST_ERRORS.get(err, err)}).")
    return out[:int(written[0])].tobytes()


def lzw_decode_host(data: bytes, size: int) -> bytes:
    """:func:`lzw_decode_plain` in host C (``sleap_tiff_lzw_decode``)."""
    if _old_style(data):
        raise UnsupportedTiff("old-style (LSB-first, pre-TIFF 6.0) LZW is not supported.")
    return _host("sleap_tiff_lzw_decode", data, size)


def lzw_encode_host(data: bytes) -> bytes:
    """:func:`lzw_encode_plain` in host C (``sleap_tiff_lzw_encode``)."""
    return _host("sleap_tiff_lzw_encode", data, 2 * len(data) + 16)


def packbits_decode_host(data: bytes, size: int) -> bytes:
    """:func:`packbits_decode_plain` in host C (``sleap_tiff_packbits_decode``)."""
    return _host("sleap_tiff_packbits_decode", data, size)


def packbits_encode_host(data: bytes) -> bytes:
    """:func:`packbits_encode_plain` in host C (``sleap_tiff_packbits_encode``)."""
    return _host("sleap_tiff_packbits_encode", data, len(data) + len(data) // 128 + 2)


def ccitt_decode_host(data: bytes, width: int, rows: int, compression: int, options: int = 0) -> bytes:
    """:func:`ccitt_decode_plain` in host C (``sleap_tiff_ccitt_decode``)."""
    from sleap_tpu_torch.ops import _build

    src = np.frombuffer(bytes(data), np.uint8)
    size = rows * -(-width // 8)
    out = np.zeros(max(size, 1), np.uint8)
    err = _build.entry("sleap_tiff_ccitt_decode")(src.ctypes.data, src.size, out.ctypes.data, width,
                                                 rows, compression, options)
    if err:
        raise ValueError(f"TIFF CCITT data is malformed (sleap_tiff_ccitt_decode: "
                         f"{_CCITT_ERRORS.get(err, err)}).")
    return out[:size].tobytes()


_CCITT_ERRORS = {1: "the data ends before its last row", 2: "an invalid run-length code",
                 3: "an invalid 2-D mode code", 4: "a vertical code past the row",
                 5: "no EOL code before a row"}


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_COMPRESSIONS = {6: "old-style JPEG-in-TIFF", 32809: "ThunderScan", 34676: "SGI LogLuv",
                 34712: "JPEG 2000", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP", 34887: "LERC",
                 32908: "Pixar log", 32909: "Pixar log", 32947: "DCS", 34661: "JBIG",
                 34677: "SGI LogL"}
_DECODED = (1, 2, 3, 4, 5, 7, 8, 32946, 32773)
_PHOTOMETRICS = {4: "transparency-mask", 8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*",
                 32844: "LogL", 32845: "LogLuv", 32803: "CFA (raw sensor)", 34892: "linear raw"}
#: The YCbCr subsamplings libtiff's RGBA reader converts (its
#: ``putcontig8bitYCbCr{44,42,41,22,21,12,11}tile``), (horizontal, vertical).
_SUBSAMPLINGS = ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4))
#: Orientation tag value -> how the stored frame becomes cv2's: a transpose
#: first, then flips of rows and columns (EXIF's eight orientations).
_ORIENTATIONS = {1: (False, False, False), 2: (False, False, True), 3: (False, True, True),
                 4: (False, True, False), 5: (True, False, False), 6: (True, False, True),
                 7: (True, True, True), 8: (True, True, False)}


def read_ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order (``"<"`` or ``">"``) and the first directory's tags,
    each a tuple of values (a RATIONAL as a float)."""
    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        raise ValueError("Not a TIFF stream (no II or MM byte-order mark).")
    e = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack_from(e + "H", data, 2)
    if magic == 43:
        raise UnsupportedTiff("BigTIFF files are not supported (classic TIFF only).")
    if magic != 42:
        raise ValueError(f"Not a TIFF stream (magic {magic}).")
    (off,) = struct.unpack_from(e + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError("TIFF directory offset lies past the end of the data.")
    (n,) = struct.unpack_from(e + "H", data, off)
    tags = {}
    for k in range(n):
        at = off + 2 + 12 * k
        if at + 12 > len(data):
            raise ValueError("TIFF directory is truncated.")
        tag, typ, count = struct.unpack_from(e + "HHI", data, at)
        if typ not in _TYPES:
            continue  # doubles and ASCII carry nothing the decode needs
        fmt = e + _TYPES[typ] * count
        size = struct.calcsize(fmt)
        where = at + 8 if size <= 4 else struct.unpack_from(e + "I", data, at + 8)[0]
        if where + size > len(data):
            raise ValueError(f"TIFF tag {tag}'s values lie past the end of the data.")
        values = struct.unpack_from(fmt, data, where)
        if typ == 5:
            values = tuple(a / b if b else 0.0 for a, b in zip(values[::2], values[1::2]))
        elif typ in (1, 7) and tag == 347:
            values = (bytes(values),)  # JPEGTables: the bytes themselves
        tags[tag] = values
    return e, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else int(v[0])


def _route(bits: int, spp: int, sf: int, photometric: int, planar: int, subsampling) -> Tuple[str, int]:
    """How cv2 (``grfmt_tiff.cpp`` on libtiff 4.7) reads these samples, as
    (route, channels): ``"rgba"`` where its frame is 8-bit and comes from
    libtiff's RGBA reader (``TIFFReadRGBAStrip``/``Tile``), ``"direct"``
    where it is wider and comes from the strips as stored; raise where cv2
    returns nothing."""
    what = f"{bits}-bit {['unsigned', 'signed', 'floating-point'][min(sf, 3) - 1]} TIFF samples"
    if sf not in (1, 2, 3) or (sf == 3 and bits not in (32, 64)) or (sf != 3 and bits == 64):
        raise UnsupportedTiff(f"{what} (sample format {sf}) are not supported: cv2 reads none.")
    gray = photometric in (0, 1)
    if bits == 1:
        if spp == 1 and (gray or photometric == 3):
            return "rgba", 1  # a 1-bit palette comes out gray, as the RGBA reader's colours
        raise UnsupportedTiff(f"bilevel TIFFs of {spp} samples with photometric interpretation "
                              f"{photometric} are not supported: cv2 reads none.")
    if bits == 4 and spp == 1 and photometric == 3:
        return "rgba", 3
    if bits < 8 or bits not in (8, 16, 32, 64):
        raise UnsupportedTiff(f"{bits}-bit TIFF samples of photometric interpretation {photometric} "
                              "are not supported: cv2 reads none (1-bit gray and palette, 4-bit "
                              "palette, 8, 16, 32 and 64 bits are read).")
    if bits == 8:
        if gray and spp <= 4:
            return "rgba", 1
        if photometric == 2 and spp in (3, 4) or photometric == 6 and spp == 3:
            if photometric == 6 and (subsampling not in _SUBSAMPLINGS
                                     or planar == 2 and subsampling != (1, 1)):
                raise UnsupportedTiff(f"YCbCr TIFF subsampling {subsampling} is not supported: "
                                      "libtiff's RGBA reader, which cv2 uses, refuses it.")
            return "rgba", 3 if spp == 3 else 4
        if photometric == 3 and spp == 1:
            return "rgba", 3
        if photometric == 5 and spp == 4:
            return "rgba", 4
    elif bits == 16 and gray and spp == 2:
        return "rgba", 1  # gray and alpha: cv2 takes the RGBA reader's 8-bit gray
    elif photometric in (0, 1, 2) and spp in (1, 3, 4):
        # The samples as channels, whatever the photometric interpretation;
        # but 16-bit gray of 3 or 4 samples comes out as one, converted as
        # cv2.cvtColor converts RGB(A) to gray.
        return "direct", 1 if bits == 16 and gray else spp
    raise UnsupportedTiff(f"{what} of {spp} samples a pixel with photometric interpretation "
                          f"{photometric} are not supported: cv2 reads none.")


def _layout(e: str, tags) -> dict:
    """Check the directory against what the port reads; the image's layout
    and the route cv2 takes for it."""
    width, height = _one(tags, 256), _one(tags, 257)
    if not width or not height:
        raise ValueError("TIFF directory has no image width or length.")
    spp = _one(tags, 277, 1)
    compression = _one(tags, 259, 1)
    bps = tags.get(258, (1,))
    sf = _one(tags, 339, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if len(set(bps)) != 1:
        raise UnsupportedTiff(f"TIFF samples of differing sizes {bps} are not supported.")
    bits = bps[0]
    if compression in _COMPRESSIONS:
        raise UnsupportedTiff(f"{_COMPRESSIONS[compression]} compression in TIFF is not supported.")
    if compression not in _DECODED:
        raise UnsupportedTiff(f"TIFF compression {compression} is not supported.")
    photometric = _one(tags, 262)
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    if photometric in _PHOTOMETRICS:
        raise UnsupportedTiff(f"{_PHOTOMETRICS[photometric]} TIFFs are not supported.")
    if photometric not in (0, 1, 2, 3, 5, 6):
        raise UnsupportedTiff(f"TIFF photometric interpretation {photometric} is not supported.")
    subsampling = tuple(tags.get(530, (2, 2))[:2]) if photometric == 6 else (1, 1)
    if compression == 7:
        subsampling = (1, 1)  # the JPEG stream holds its own sampling
        if bits != 8 or (photometric, spp) not in ((1, 1), (2, 3), (6, 3)):
            raise UnsupportedTiff(f"JPEG-in-TIFF of {bits}-bit samples, {spp} a pixel, photometric "
                                  f"interpretation {photometric} is not supported (gray, RGB or "
                                  "YCbCr).")
    if compression in (2, 3, 4) and (bits != 1 or spp != 1):
        raise UnsupportedTiff("CCITT-compressed TIFFs of more than one bit a pixel are not supported.")
    if photometric == 5 and _one(tags, 332, 1) != 1:
        raise UnsupportedTiff(f"separated TIFFs of ink set {_one(tags, 332)} are not supported "
                              "(CMYK only).")
    jpeg_colorspace = None
    if compression == 7 and photometric != 1:
        # libtiff has libjpeg convert YCbCr to RGB (JPEGCOLORMODE_RGB, as its
        # RGBA reader asks) and leaves RGB planes as they are.
        jpeg_colorspace = "ycc" if photometric == 6 else "rgb"
        photometric = 2
    route, channels = _route(bits, spp, sf, photometric, planar, subsampling)
    if route == "rgba" and 322 in tags and compression == 1:
        raise UnsupportedTiff("uncompressed tiles of 8-bit TIFF samples are not supported: cv2 reads "
                              "none (libtiff's RGBA tile reader reports an invalid tile byte count).")
    if planar == 2 and spp > 1 and bits > 8:
        raise UnsupportedTiff("planar-separate TIFF samples wider than 8 bits are not supported: "
                              "cv2 reads them into unset memory.")
    fill_order = _one(tags, 266, 1)
    if fill_order not in (1, 2):
        raise UnsupportedTiff(f"TIFF fill order {fill_order} is not supported.")
    orientation = _one(tags, 274, 1)
    if orientation not in _ORIENTATIONS:
        raise UnsupportedTiff(f"TIFF orientation {orientation} is not supported (1 to 8).")
    if predictor not in (1, 2, 3) or (predictor == 3 and sf != 3) or (predictor != 1 and bits < 8):
        raise UnsupportedTiff(f"TIFF predictor {predictor} on these samples is not supported.")
    colormap = None
    if photometric == 3:
        colormap = np.asarray(tags.get(320, ()), np.int64)
        if colormap.size != 3 << bits:
            raise ValueError(f"TIFF palette image has a colormap of {colormap.size} entries, not "
                             f"{3 << bits}.")
        colormap = colormap.reshape(3, 1 << bits)
    extra = tags.get(338, ())
    tiled = 322 in tags
    if tiled:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw = width
        ch = min(_one(tags, 278, height) or height, height)
        offsets, counts = tags.get(273), tags.get(279)
    if not cw or not ch or offsets is None or counts is None:
        raise ValueError("TIFF directory lacks its strip or tile layout.")
    kind = {1: "u", 2: "i", 3: "f"}[sf]
    dtype = np.dtype(f"{kind}{max(bits, 8) // 8}").newbyteorder(e)
    t4 = _one(tags, 292, 0) if compression == 3 else 0
    if compression in (3, 4) and (t4 if compression == 3 else _one(tags, 293, 0)) & 2:
        raise UnsupportedTiff("CCITT uncompressed mode is not supported.")
    return dict(width=width, height=height, spp=spp, bits=bits, sf=sf, dtype=dtype,
                compression=compression, photometric=photometric, planar=planar,
                predictor=predictor, tiled=tiled, cw=cw, ch=ch, offsets=offsets, counts=counts,
                unassociated=spp == 4 and bits == 8 and photometric == 2 and tuple(extra[:1]) == (2,),
                route=route, channels=channels, colormap=colormap, fill_order=fill_order,
                orientation=orientation, subsampling=subsampling, t4options=t4,
                refbw=tags.get(532), luma=tags.get(529), tables=tags.get(347, (b"",))[0],
                jpeg_colorspace=jpeg_colorspace)


def _undo_predictor(chunk: np.ndarray, predictor: int, dtype: np.dtype) -> np.ndarray:
    """(rows, width, samples) of file-order ``dtype`` -> native values, with
    the predictor undone (libtiff's ``horAcc8/16/32/64`` on words, ``fpAcc``
    on the bytes of floats)."""
    rows, width, spp = chunk.shape
    if predictor == 3:
        size = dtype.itemsize
        b = np.ascontiguousarray(chunk).view(np.uint8).reshape(rows, width * spp * size)
        b = np.cumsum(b.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, size, width * spp)
        be = np.ascontiguousarray(b.transpose(0, 2, 1)).view(">" + dtype.str[1:]).reshape(rows, width, spp)
        return be.astype(dtype.newbyteorder("="))
    native = chunk.astype(dtype.newbyteorder("="))
    if predictor == 2:
        words = native.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[dtype.itemsize])
        native = np.cumsum(words, axis=1, dtype=words.dtype).view(native.dtype)
    return native


def _reverse_bits(raw: bytes) -> bytes:
    """Each byte's bits in reverse order, as libtiff reads fill order 2."""
    return _BIT_REVERSED[np.frombuffer(raw, np.uint8)].tobytes()


_BIT_REVERSED = np.packbits(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1,
                                          bitorder="little"), axis=1)[:, 0]


def _unpack(raw: bytes, rows: int, count: int, bits: int) -> np.ndarray:
    """(rows, count) uint8 values of ``bits`` < 8 bits from rows packed
    MSB-first, each padded to a whole byte."""
    stride = -(-count * bits // 8)
    packed = np.frombuffer(raw, np.uint8, rows * stride).reshape(rows, stride)
    unpacked = np.unpackbits(packed, axis=1)[:, :count * bits].reshape(rows, count, bits)
    return (unpacked << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(2, dtype=np.uint8)


def _chunk_size(lay: dict, rows: int, per_chunk: int) -> int:
    """Bytes of a decoded strip or tile of ``rows`` rows."""
    cw, bits = lay["cw"], lay["bits"]
    if lay["photometric"] == 6 and lay["compression"] != 7 and lay["subsampling"] != (1, 1):
        h, v = lay["subsampling"]
        return -(-rows // v) * -(-cw // h) * (h * v + 2)
    return rows * -(-cw * per_chunk * bits // 8)


def _ycbcr_units(raw: bytes, rows: int, cw: int, sub) -> np.ndarray:
    """TIFF's chunky subsampled YCbCr data units -> (rows, cw, 3) Y, Cb, Cr,
    each chroma sample copied to every pixel of its unit (libtiff's RGBA
    reader uses a unit's one Cb and Cr for all its pixels)."""
    h, v = sub
    down, across = -(-rows // v), -(-cw // h)
    units = np.frombuffer(raw, np.uint8, down * across * (h * v + 2)).reshape(down, across, h * v + 2)
    y = units[..., :h * v].reshape(down, across, v, h).transpose(0, 2, 1, 3).reshape(down * v, across * h)
    cb = np.repeat(np.repeat(units[..., h * v], v, 0), h, 1)
    cr = np.repeat(np.repeat(units[..., h * v + 1], v, 0), h, 1)
    return np.stack([y, cb, cr], -1)[:rows, :cw]


def _decode_chunk(raw: bytes, lay: dict, rows: int, per_chunk: int, device) -> np.ndarray:
    """One strip or tile -> (rows, cw, samples) native values (YCbCr units
    expanded, sub-byte samples unpacked)."""
    card = _on_card(device)
    compression, cw = lay["compression"], lay["cw"]
    if compression == 7:
        from sleap_tpu_torch.io import jpeg

        frame = jpeg.imdecode(jpeg.with_tables(lay["tables"], raw), device, lay["jpeg_colorspace"])
        frame = frame.reshape(frame.shape[0], frame.shape[1], -1)[..., ::-1]  # BGR -> stored RGB
        out = np.zeros((rows, cw, per_chunk), np.uint8)
        part = frame[:rows, :cw]
        out[:part.shape[0], :part.shape[1]] = part
        return out
    if lay["fill_order"] == 2:
        raw = _reverse_bits(raw)
    size = _chunk_size(lay, rows, per_chunk)
    if compression in (2, 3, 4):
        raw = (ccitt_decode_host if card else ccitt_decode_plain)(
            raw, cw, rows, compression, lay["t4options"])
    elif compression in (8, 32946):
        raw = zlib.decompressobj().decompress(raw, size)
        if len(raw) < size:
            raise ValueError(f"TIFF deflate data ends after {len(raw)} of {size} bytes.")
    elif compression == 5:
        raw = (lzw_decode_host if card else lzw_decode_plain)(raw, size)
    elif compression == 32773:
        raw = (packbits_decode_host if card else packbits_decode_plain)(raw, size)
    elif len(raw) < size:
        raise ValueError(f"TIFF strip or tile holds {len(raw)} of {size} bytes.")
    if lay["photometric"] == 6 and lay["subsampling"] != (1, 1):
        return _ycbcr_units(raw, rows, cw, lay["subsampling"])
    if lay["bits"] < 8:
        return _unpack(raw, rows, cw * per_chunk, lay["bits"]).reshape(rows, cw, per_chunk)
    dtype = lay["dtype"]
    chunk = np.frombuffer(raw, dtype, rows * cw * per_chunk).reshape(rows, cw, per_chunk)
    return _undo_predictor(chunk, lay["predictor"], dtype)


def samples_of(data: bytes, lay: dict, device="cuda") -> np.ndarray:
    """The image's samples as stored, (H, W, samples) in native order (a
    JPEG-in-TIFF's decoded, YCbCr units expanded, sub-byte samples one a
    byte), from every strip or tile."""
    w, h, spp = lay["width"], lay["height"], lay["spp"]
    cw, ch = lay["cw"], lay["ch"]
    planes = spp if lay["planar"] == 2 else 1
    per_chunk = spp // planes
    across = -(-w // cw) if lay["tiled"] else 1
    down = -(-h // ch)
    if len(lay["offsets"]) < planes * across * down or len(lay["counts"]) < planes * across * down:
        raise ValueError("TIFF directory has fewer strips or tiles than the image needs.")
    out = np.empty((h, w, spp), np.uint8 if lay["bits"] < 8 else lay["dtype"].newbyteorder("="))
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                off, count = lay["offsets"][k], lay["counts"][k]
                k += 1
                rows = ch if lay["tiled"] else min(ch, h - ty * ch)
                chunk = _decode_chunk(data[off:off + count], lay, rows, per_chunk, device)
                y0, x0 = ty * ch, tx * cw
                part = chunk[:min(rows, h - y0), :min(cw, w - x0)]
                out[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                    plane * per_chunk:(plane + 1) * per_chunk] = part
    return out


# --------------------------------------------------------------------------- #
# libtiff's RGBA reader (tif_getimage.c), the route of cv2's 8-bit frames
# --------------------------------------------------------------------------- #

#: OpenCV's ``icvCvt_BGRA2Gray_8u_C4C1R`` weights (SCALE 14) for R, G, B.
GRAY_R, GRAY_G, GRAY_B = 4899, 9617, 1868


def ycbcr_tables(luma=None, refbw=None):
    """libtiff's ``TIFFYCbCrToRGBInit`` integer tables (SHIFT 16), built in
    the float32 arithmetic of ``tif_color.c``: (Cr_r, Cb_b, Cr_g, Cb_g, Y),
    each 256 int64 entries indexed by the stored value."""
    f = np.float32
    lr, lg, lb = (f(x) for x in (luma or (0.299, 0.587, 0.114)))
    rbw = [f(x) for x in (refbw or (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))]

    def fix(x):  # FIX(CLAMP(x, 0, 2)): a float times 2^16, plus 0.5 in double
        return int(np.floor(float(f(min(max(x, f(0)), f(2))) * f(65536)) + 0.5))

    f1 = f(2) - f(2) * lr
    d1 = fix(f1)
    d2 = -fix(lr * f1 / lg)
    f3 = f(2) - f(2) * lb
    d3 = fix(f3)
    d4 = -fix(lb * f3 / lg)

    def code2v(c, rb, rw, cr):  # Code2V then CLAMPw to +-4096, truncated to int
        span = rw - rb
        v = f(f(c - int(rb)) * f(cr)) / (span if span != 0 else f(1))
        v = f(v)
        return int(min(max(v, f(-4096)), f(4096)))

    half = 1 << 15
    cr_r, cb_b, cr_g, cb_g, ytab = (np.empty(256, np.int64) for _ in range(5))
    for i in range(256):
        x = i - 128
        cr = code2v(x, rbw[4] - f(128), rbw[5] - f(128), 127)
        cb = code2v(x, rbw[2] - f(128), rbw[3] - f(128), 127)
        cr_r[i] = (d1 * cr + half) >> 16
        cb_b[i] = (d3 * cb + half) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + half
        ytab[i] = code2v(x + 128, rbw[0], rbw[1], 255)
    return cr_r, cb_b, cr_g, cb_g, ytab


def ycbcr_to_rgb(ycc: np.ndarray, luma=None, refbw=None) -> np.ndarray:
    """(..., 3) uint8 Y, Cb, Cr -> (..., 3) uint8 R, G, B, as
    ``TIFFYCbCrtoRGB`` converts them."""
    cr_r, cb_b, cr_g, cb_g, ytab = ycbcr_tables(luma, refbw)
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    r = ytab[y] + cr_r[cr]
    g = ytab[y] + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = ytab[y] + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _rgba_frame(s: np.ndarray, lay: dict) -> np.ndarray:
    """cv2's 8-bit frame from the stored samples, through libtiff's RGBA
    reader and OpenCV's conversion of its RGBA to 1, 3 or 4 channels."""
    photometric, bits = lay["photometric"], lay["bits"]
    if photometric in (0, 1):
        v = s[..., 0]
        if bits == 1:
            v = v * np.uint8(255)
        elif bits == 16:
            v = v.view(np.uint16) >> 8  # put16bitbwtile: the high byte
        v = v.view(np.uint8) if v.dtype.itemsize == 1 else v.astype(np.uint8)
        return 255 - v if photometric == 0 else v
    if photometric == 3:
        cmap = lay["colormap"]
        if (cmap >= 256).any():  # checkcmap: a 16-bit colormap, cut to its high byte
            cmap = cmap >> 8
        rgb = cmap[:, s[..., 0]].transpose(1, 2, 0)
        if lay["channels"] == 1:  # OpenCV's BGRA2Gray, descaled by 2^14 with rounding
            gray = rgb[..., 0] * GRAY_R + rgb[..., 1] * GRAY_G + rgb[..., 2] * GRAY_B
            return ((gray + (1 << 13)) >> 14).astype(np.uint8)
        return rgb[..., ::-1].astype(np.uint8)
    s = s.view(np.uint8)
    if photometric == 5:  # putRGBcontig8bitCMYKtile, alpha opaque
        k = 255 - s[..., 3:].astype(np.int64)
        rgb = k * (255 - s[..., :3].astype(np.int64)) // 255
        return np.concatenate([rgb[..., ::-1], np.full_like(k, 255)], -1).astype(np.uint8)
    if photometric == 6:
        return ycbcr_to_rgb(s, lay["luma"], lay["refbw"])[..., ::-1]
    out = s.copy()
    if lay["unassociated"]:  # the RGBA reader premultiplies: (a * v + 127) // 255
        alpha = out[..., 3:].astype(np.uint32)
        out[..., :3] = ((alpha * out[..., :3] + 127) // 255).astype(np.uint8)
    return out[..., [2, 1, 0, 3][:lay["spp"]]]


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The stored frame as cv2 returns it for TIFF orientation 1-8: 2 flips
    left-right, 3 turns 180 degrees, 4 flips up-down, 5 transposes, 6 turns
    90 degrees clockwise, 7 transposes across the other diagonal, 8 turns 90
    degrees anticlockwise."""
    transpose, flip_rows, flip_cols = _ORIENTATIONS[orientation]
    if transpose:
        img = img.swapaxes(0, 1)
    if flip_rows:
        img = img[::-1]
    if flip_cols:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def transposed(data: bytes) -> bool:
    """Whether the first page's orientation (5 to 8) transposes a frame
    that is not square."""
    _, tags = read_ifd(bytes(data))
    return _one(tags, 274, 1) in (5, 6, 7, 8) and _one(tags, 256) != _one(tags, 257)


def imdecode(data: bytes, device="cuda") -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` of a TIFF's first page:
    (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, in cv2's dtype (uint8 or
    int8 for what it reads through libtiff's RGBA reader; uint16, int16,
    uint32, int32, float32 or float64 as stored otherwise). LZW, PackBits
    and CCITT are decoded in host C, a JPEG-in-TIFF's strips by J1 and J2,
    on ``device`` "cuda" (the default); in Python on "cpu"."""
    data = bytes(data)
    e, tags = read_ifd(data)
    lay = _layout(e, tags)
    s = samples_of(data, lay, device)
    if lay["route"] == "rgba":
        img = _rgba_frame(s, lay)
        if lay["sf"] == 2:
            img = img.view(np.int8)
    elif lay["channels"] == 1 and lay["spp"] > 1:  # cvtColor's RGB2GRAY on the unsigned words
        u = s.view(np.uint16).astype(np.int64)
        gray = (u[..., 0] * GRAY_R + u[..., 1] * GRAY_G + u[..., 2] * GRAY_B + (1 << 13)) >> 14
        img = gray.astype(np.uint16).view(s.dtype)
    else:
        img = s[..., 0] if lay["spp"] == 1 else s[..., [2, 1, 0, 3][:lay["spp"]]]
    return orient(img, lay["orientation"])


# --------------------------------------------------------------------------- #
# Writing: cv2.imencode(".tif", img)
# --------------------------------------------------------------------------- #

_SAMPLE_FORMATS = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 1, np.dtype(np.float32): 3}


def _as_samples(img) -> np.ndarray:
    """A frame as (H, W, samples) in the file's order (RGB(A))."""
    img = np.asarray(img)
    if img.dtype not in _SAMPLE_FORMATS:
        raise ValueError(f"TIFF frames are written from uint8, uint16 or float32, not {img.dtype}.")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4) or not img.shape[0] or not img.shape[1]:
        raise ValueError(f"TIFF frames are (H, W), (H, W, 1), (H, W, 3) BGR or (H, W, 4) BGRA, not "
                         f"{img.shape}.")
    if img.shape[2] > 1:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def _entry(tag: int, typ: int, values) -> Tuple[int, int, int, bytes]:
    return tag, typ, len(values), struct.pack("<" + ("H" if typ == 3 else "I") * len(values), *values)


def _short_or_long(value: int) -> int:
    return 3 if value <= 0xFFFF else 4


def imencode(img, device="cuda") -> bytes:
    """``cv2.imencode(".tif", img)[1].tobytes()``: the TIFF of an (H, W),
    (H, W, 1), (H, W, 3) BGR or (H, W, 4) BGRA frame of uint8, uint16 or
    float32, as OpenCV writes it; LZW in host C on ``device`` "cuda" (the
    default), in Python on "cpu"."""
    samples = _as_samples(img)
    h, w, spp = samples.shape
    dtype = samples.dtype
    row_bytes = w * spp * dtype.itemsize
    rps = max(1, min(h, 8192 // row_bytes))
    lzw = dtype != np.float32
    if lzw:  # the horizontal predictor: each sample minus the one a pixel to its left
        diff = samples.copy()
        diff[:, 1:] -= samples[:, :-1]
        samples = diff
    encode_strip = (lzw_encode_host if _on_card(device) else lzw_encode_plain) if lzw else bytes
    strips = [encode_strip(samples[y:y + rps].tobytes()) for y in range(0, h, rps)]
    offsets, counts = [], []
    body = bytearray(b"II*\0\0\0\0\0")
    for s in strips:
        offsets.append(len(body))
        counts.append(len(s))
        body += s
    if len(body) & 1:
        body += b"\0"
    diroff = len(body)
    struct.pack_into("<I", body, 4, diroff)
    n = len(strips)
    strip_size = rps * row_bytes
    # libtiff writes byte counts as SHORT where every strip surely fits:
    # an uncompressed strip of at most 65535 bytes, an LZW one under 6553.
    short_counts = n > 1 and (strip_size < 65535 // 10 if lzw else strip_size <= 65535)
    entries = [
        _entry(256, _short_or_long(w), [w]), _entry(257, _short_or_long(h), [h]),
        _entry(258, 3, [8 * dtype.itemsize] * spp), _entry(259, 3, [5 if lzw else 1]),
        _entry(262, 3, [1 if spp == 1 else 2]), _entry(273, 4, offsets), _entry(277, 3, [spp]),
        _entry(278, _short_or_long(rps), [rps]), _entry(279, 3 if short_counts else 4, counts),
        _entry(284, 3, [1]),
    ]
    if lzw:
        entries.append(_entry(317, 3, [2]))
    entries.append(_entry(339, 3, [_SAMPLE_FORMATS[dtype]] * spp))
    # Values that do not fit in their entry follow the directory, in the
    # order libtiff writes them.
    order = {258: 0, 279: 1, 273: 2, 339: 3}
    extra_at = diroff + 2 + 12 * len(entries) + 4
    where = {}
    tail = bytearray()
    for tag, _, _, raw in sorted((x for x in entries if len(x[3]) > 4), key=lambda x: order[x[0]]):
        where[tag] = extra_at + len(tail)
        tail += raw
        if len(tail) & 1:
            tail += b"\0"
    body += struct.pack("<H", len(entries))
    for tag, typ, count, raw in entries:
        value = struct.pack("<I", where[tag]) if tag in where else raw.ljust(4, b"\0")
        body += struct.pack("<HHI", tag, typ, count) + value
    body += b"\0\0\0\0" + tail
    return bytes(body)

