"""Read TIFF stills as ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` returns
them and write them as ``cv2.imencode(".tif", img)`` writes them (OpenCV 5
on libtiff 4.7), byte for byte: the port's TIFF codec for image folders,
``.pkg.slp`` and HDF5 frame rows and ImgStores, where ``cv2`` is not
installed.

Reading (:func:`imdecode`): the first directory (page 0, as ``cv2.imread``
reads a multi-page file) of a classic TIFF in either byte order; samples of
8 or 16 unsigned bits or 32-bit floats, kept in their dtype; one sample
(gray, (H, W)), three (RGB, returned (H, W, 3) BGR) or four (RGBA, returned
(H, W, 4) BGRA); chunky or planar-separate samples (separate only at 8
bits: cv2 returns unset memory for separate planes of wider samples);
strips or tiles; no compression (1), LZW (5), deflate (8 and 32946) or
PackBits (32773); predictor 1, 2 (horizontal differencing, on 8-, 16- or
32-bit words) or 3 (floating point). Four 8-bit samples with unassociated
alpha (ExtraSamples 2) are premultiplied as libtiff's RGBA reader, which cv2
uses for 8-bit files, premultiplies them. BigTIFF, JPEG-in-TIFF, CCITT,
palette, YCbCr, CMYK, bilevel and other sub-byte, min-is-white, signed,
32-bit integer and 64-bit files, other orientations and fill orders, and
old-style LZW raise :class:`UnsupportedTiff` naming the feature.

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

- ``"cpu"``, the plain version: LZW and PackBits in Python, predictors in
  numpy, deflate with ``zlib``;
- ``"cuda"``: LZW and PackBits in host C (``sleap_tiff_lzw_decode``,
  ``sleap_tiff_lzw_encode``, ``sleap_tiff_packbits_decode`` and
  ``sleap_tiff_packbits_encode`` in ``csrc/tiff.cu``, built into the kernel
  library); the rest as on the CPU. A failed build raises; there is no
  fallback to the plain version.

No kernel: the JAX package reads and writes TIFF with cv2 on the host
(``sleap_tpu/io/video.py``, ``SingleImageVideo.get_frame``,
``HDF5Video.get_frame`` and ``Video.to_hdf5``; ``sleap_tpu/io/slp.py``;
``sleap_tpu/io/dirimgstore.py``).
"""

from __future__ import annotations

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


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i", 16: "Q"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax",
                 6: "old-style JPEG-in-TIFF", 7: "JPEG-in-TIFF", 32809: "ThunderScan",
                 32946: None, 34676: "SGI LogLuv", 34712: "JPEG 2000", 34925: "LZMA",
                 50000: "Zstandard", 50001: "WebP", 34887: "LERC"}
_PHOTOMETRICS = {0: "min-is-white", 3: "palette colour", 4: "transparency-mask", 5: "CMYK (separated)",
                 6: "YCbCr", 8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL",
                 32845: "LogLuv"}


def read_ifd(data: bytes) -> Tuple[str, Dict[int, tuple]]:
    """The byte order (``"<"`` or ``">"``) and the first directory's tags,
    each a tuple of values."""
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
            continue  # rationals, doubles and ASCII carry nothing the decode needs
        fmt = e + _TYPES[typ] * count
        size = struct.calcsize(fmt)
        where = at + 8 if size <= 4 else struct.unpack_from(e + "I", data, at + 8)[0]
        if where + size > len(data):
            raise ValueError(f"TIFF tag {tag}'s values lie past the end of the data.")
        tags[tag] = struct.unpack_from(fmt, data, where)
    return e, tags


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else int(v[0])


def _layout(e: str, tags) -> dict:
    """Check the directory against the subset; the image's layout."""
    width, height = _one(tags, 256), _one(tags, 257)
    if not width or not height:
        raise ValueError("TIFF directory has no image width or length.")
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,))
    compression = _one(tags, 259, 1)
    photometric = _one(tags, 262)
    sf = _one(tags, 339, 1)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    if len(set(bps)) != 1:
        raise UnsupportedTiff(f"TIFF samples of differing sizes {bps} are not supported.")
    bits = bps[0]
    if compression in _COMPRESSIONS and _COMPRESSIONS[compression]:
        raise UnsupportedTiff(f"{_COMPRESSIONS[compression]} compression in TIFF is not supported.")
    if compression not in (1, 5, 8, 32946, 32773):
        raise UnsupportedTiff(f"TIFF compression {compression} is not supported.")
    if photometric in _PHOTOMETRICS:
        raise UnsupportedTiff(f"{_PHOTOMETRICS[photometric]} TIFFs are not supported.")
    if bits < 8:
        raise UnsupportedTiff(f"bilevel and other {bits}-bit TIFF samples are not supported.")
    if bits not in (8, 16, 32):
        raise UnsupportedTiff(f"{bits}-bit TIFF samples are not supported (8, 16 or 32-bit float).")
    if sf == 2:
        raise UnsupportedTiff("signed integer TIFF samples are not supported.")
    if bits == 32 and sf != 3:
        raise UnsupportedTiff("32-bit integer TIFF samples are not supported (32-bit float only).")
    if sf == 3 and bits != 32:
        raise UnsupportedTiff(f"{bits}-bit floating-point TIFF samples are not supported.")
    if sf not in (1, 3):
        raise UnsupportedTiff(f"TIFF sample format {sf} is not supported.")
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    if (photometric, spp) not in ((1, 1), (2, 3), (2, 4)):
        raise UnsupportedTiff(f"TIFFs of {spp} samples a pixel with photometric interpretation "
                              f"{photometric} are not supported (gray, RGB or RGBA).")
    if planar == 2 and spp > 1 and bits > 8:
        raise UnsupportedTiff("planar-separate TIFF samples wider than 8 bits are not supported.")
    if _one(tags, 266, 1) != 1:
        raise UnsupportedTiff("TIFF fill order 2 (LSB-first bits) is not supported.")
    if _one(tags, 274, 1) != 1:
        raise UnsupportedTiff(f"TIFF orientation {_one(tags, 274)} is not supported (top-left only).")
    if predictor not in (1, 2, 3) or (predictor == 3 and sf != 3):
        raise UnsupportedTiff(f"TIFF predictor {predictor} on these samples is not supported.")
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
    dtype = np.dtype({8: "u1", 16: "u2", 32: "f4"}[bits]).newbyteorder(e)
    return dict(width=width, height=height, spp=spp, dtype=dtype, compression=compression,
                planar=planar, predictor=predictor, tiled=tiled, cw=cw, ch=ch, offsets=offsets,
                counts=counts, unassociated=spp == 4 and bits == 8 and tuple(extra[:1]) == (2,))


def _undo_predictor(chunk: np.ndarray, predictor: int, dtype: np.dtype) -> np.ndarray:
    """(rows, width, samples) of file-order ``dtype`` -> native values, with
    the predictor undone (libtiff's ``horAcc8/16/32`` on words, ``fpAcc``
    on the bytes of floats)."""
    rows, width, spp = chunk.shape
    if predictor == 3:
        size = dtype.itemsize
        b = np.ascontiguousarray(chunk).view(np.uint8).reshape(rows, width * spp * size)
        b = np.cumsum(b.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, size, width * spp)
        be = np.ascontiguousarray(b.transpose(0, 2, 1)).view(">f4").reshape(rows, width, spp)
        return be.astype(np.float32)
    native = chunk.astype(dtype.newbyteorder("="))
    if predictor == 2:
        words = native.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[dtype.itemsize])
        native = np.cumsum(words, axis=1, dtype=words.dtype).view(native.dtype)
    return native


def imdecode(data: bytes, device="cuda") -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` of a TIFF's first page:
    (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA, in the file's dtype
    (uint8, uint16 or float32). LZW and PackBits are decoded in host C on
    ``device`` "cuda" (the default), in Python on "cpu"."""
    data = bytes(data)
    e, tags = read_ifd(data)
    lay = _layout(e, tags)
    card = _on_card(device)
    codecs: Dict[int, Callable[[bytes, int], bytes]] = {
        5: lzw_decode_host if card else lzw_decode_plain,
        32773: packbits_decode_host if card else packbits_decode_plain,
    }
    w, h, spp, dtype = lay["width"], lay["height"], lay["spp"], lay["dtype"]
    cw, ch = lay["cw"], lay["ch"]
    planes = spp if lay["planar"] == 2 else 1
    per_chunk = spp // planes
    across = -(-w // cw) if lay["tiled"] else 1
    down = -(-h // ch)
    if len(lay["offsets"]) < planes * across * down or len(lay["counts"]) < planes * across * down:
        raise ValueError("TIFF directory has fewer strips or tiles than the image needs.")
    out = np.empty((h, w, spp), dtype.newbyteorder("="))
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                off, count = lay["offsets"][k], lay["counts"][k]
                k += 1
                rows = ch if lay["tiled"] else min(ch, h - ty * ch)
                size = rows * cw * per_chunk * dtype.itemsize
                raw = data[off:off + count]
                if lay["compression"] in (8, 32946):
                    raw = zlib.decompressobj().decompress(raw, size)
                    if len(raw) < size:
                        raise ValueError(f"TIFF deflate data ends after {len(raw)} of {size} bytes.")
                elif lay["compression"] in codecs:
                    raw = codecs[lay["compression"]](raw, size)
                elif len(raw) < size:
                    raise ValueError(f"TIFF strip or tile holds {len(raw)} of {size} bytes.")
                chunk = np.frombuffer(raw, dtype, rows * cw * per_chunk).reshape(rows, cw, per_chunk)
                chunk = _undo_predictor(chunk, lay["predictor"], dtype)
                y0, x0 = ty * ch, tx * cw
                part = chunk[:min(rows, h - y0), :min(cw, w - x0)]
                out[y0:y0 + part.shape[0], x0:x0 + part.shape[1],
                    plane * per_chunk:(plane + 1) * per_chunk] = part
    if lay["unassociated"]:  # libtiff's RGBA reader premultiplies: (a * v + 127) // 255
        alpha = out[..., 3:].astype(np.uint32)
        out[..., :3] = ((alpha * out[..., :3] + 127) // 255).astype(np.uint8)
    if spp == 1:
        return out[..., 0]
    return np.ascontiguousarray(out[..., [2, 1, 0, 3][:spp]])


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

