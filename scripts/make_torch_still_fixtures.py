"""Write the BMP and TIFF fixtures of the port's tests and ``chip_smoke.py``
phases 19 and 22 with cv2, PIL (built with libtiff) and a small writer of
its own for the layouts neither writes (tiles, planar-separate samples,
big-endian files, the floating-point predictor, sub-byte samples,
palettes, fill order 2, YCbCr data units, CCITT Modified Huffman, T.4 1-D
and 2-D and T.6 coding, JPEG-in-TIFF strips and tiles with their
JPEGTables, RLE-coded BMPs, the headers the port refuses), from a seed;
nothing is downloaded.

    JAX_PLATFORMS=cpu python scripts/make_torch_still_fixtures.py

Writes, under ``tests/torch_data/stills``:

- ``*.bmp`` and ``*.tif``: small stills of smooth content (a few KB each),
  one for each layout cv2 reads (``layouts``: orientations 2-8, signed and
  wide samples, min-is-white, palettes, bilevel and CCITT pages, YCbCr,
  CMYK, gray and alpha, JPEG-in-TIFF), and four 1024^2 TIFFs: two as cv2
  writes them (uint8 gray, and uint16 gray of 12-bit values), a
  JPEG-in-TIFF and a CCITT Group 4 page holding two blob animals
  (``animal_scene``);
- ``decoded.json``: for each file, the sha256 of ``cv2.imdecode(buf,
  cv2.IMREAD_UNCHANGED)``'s bytes with its shape and dtype (cv2 read three
  times, the same each time), or the feature the port refuses (named in
  its error) with why cv2 gives no frame (``CV2_REFUSES``), so the card,
  which has no cv2, can hold the port's decoders to cv2's output;
- ``encoded.json``: the sha256 and length of ``cv2.imencode(".bmp" or
  ".tif", frame)`` for the frames cv2 decodes from the committed files
  (BMP of the uint8 ones, TIFF of the uint8, uint16 and float32 ones) and
  for crops of the 1024^2 frames, so the card can hold the port's encoders
  to cv2's bytes.

Both records name the cv2, libtiff, Pillow and numpy that wrote them.
``--records`` rewrites only the two JSON files from the committed stills.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "torch_data", "stills")
BIG = 1024

#: The frame types whose TIFF encoding encoded.json records.
WRITTEN_DTYPES = (np.uint8, np.uint16, np.float32)

#: Crops (W, H) of the 1024^2 frames that encoded.json records, at (1, 1).
CROPS = ((1, 1), (3, 50), (1023, 1021))


def smooth(h: int, w: int, channels: int, seed: int, dtype=np.uint8) -> np.ndarray:
    """Smooth shapes and gradients (no noise: the files stay small), each
    channel its own."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    phase = np.random.default_rng(seed).uniform(0, 6, channels)
    chans = [0.5 + 0.35 * np.sin(xx / (w / 5.0 + 1) + p) * np.cos(yy / (h / 4.0 + 1) - p)
             + 0.1 * (xx + yy) / (h + w) for p in phase]
    img = np.stack(chans, -1)
    if dtype == np.float32:
        return img.astype(np.float32)
    top = np.iinfo(dtype).max
    return np.clip(np.rint(img * top), 0, top).astype(dtype)


# --------------------------------------------------------------------------- #
# TIFF layouts neither cv2 nor PIL writes
# --------------------------------------------------------------------------- #


def pack_rows(chunk: np.ndarray, bits: int) -> bytes:
    """(rows, width, samples) values of ``bits`` < 8 bits, each row packed
    MSB-first and padded to a whole byte, as TIFF stores sub-byte samples."""
    rows, width, samples = chunk.shape
    flat = chunk.reshape(rows, width * samples).astype(np.uint8)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint8)
    bitplane = (flat[..., None] >> shifts) & 1
    return np.packbits(bitplane.reshape(rows, -1), axis=1).tobytes()


def ycbcr_units(img: np.ndarray, h: int, v: int) -> np.ndarray:
    """(H, W, 3) Y, Cb, Cr -> TIFF's chunky subsampled data units, (rows of
    units, units across, h * v + 2): each unit's luma row by row, then one Cb
    and one Cr (the unit's top-left pixel's), edges padded by repetition."""
    H, W, _ = img.shape
    ph, pw = -(-H // v) * v, -(-W // h) * h
    pad = np.pad(img, ((0, ph - H), (0, pw - W), (0, 0)), mode="edge")
    units = pad.reshape(ph // v, v, pw // h, h, 3).transpose(0, 2, 1, 3, 4)
    luma = units[..., 0].reshape(ph // v, pw // h, v * h)
    return np.concatenate([luma, units[:, :, 0, 0, 1:]], -1)


def _changes(row: np.ndarray) -> list:
    """A row of 0/1 (1 black) -> its changing elements, as T.4 numbers them."""
    flips = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8)])))
    return flips.tolist()


def _run_bits(run: int, colour: int) -> str:
    """A run as T.4 codes it: 2560-long make-up codes, one make-up code, a
    terminating code."""
    from sleap_tpu_torch.io.tiff import run_codes

    codes = {r: c for c, r in run_codes(colour)}
    out = ""
    while run >= 2560:
        out += codes[2560]
        run -= 2560
    if run >= 64:
        out += codes[run // 64 * 64]
    return out + codes[run % 64]


def _row_1d(changes: list, width: int) -> str:
    out, a0, colour = "", 0, 0
    for x in changes + [width]:
        out += _run_bits(x - a0, colour)
        a0, colour = x, colour ^ 1
        if x >= width:
            break
    return out


def _row_2d(changes: list, ref: list, width: int) -> str:
    """A row 2-D coded against ``ref`` (T.4 4.2.1.3's coding procedure)."""
    from sleap_tpu_torch.io.tiff import MODE_CODES

    modes = {(m, o): c for c, m, o in MODE_CODES}
    cur, ref = changes + [width] * 3, ref + [width] * 3
    out, a0, colour = "", -1, 0

    def first(line, after, parity):
        return next(k for k, x in enumerate(line) if x > after and (k & 1) == parity)

    while a0 < width:
        k1 = first(cur, a0, colour)
        a1 = cur[k1]
        j = first(ref, a0, colour)
        b1, b2 = ref[j], ref[j + 1]
        if b2 < a1:
            out += modes["pass", 0]
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += modes["vertical", a1 - b1]
            a0, colour = a1, colour ^ 1
        else:
            a2 = cur[k1 + 1]
            out += (modes["horizontal", 0] + _run_bits(a1 - max(a0, 0), colour)
                    + _run_bits(a2 - a1, colour ^ 1))
            a0 = a2
    return out


def ccitt_bytes(bits: np.ndarray, compression: int, k: int = 1, fill: bool = False) -> bytes:
    """(H, W) 0/1 pixels (1 black) CCITT-coded: Modified Huffman (2), T.4
    (3; with ``k`` > 1, 2-D coding with a 1-D row every ``k`` rows, and
    ``fill`` pads before each EOL to end it on a byte boundary) or T.6 (4;
    an EOFB after the last row)."""
    eol = "000000000001"
    out, ref = "", []
    for y, row in enumerate(bits):
        changes = _changes(row)
        width = row.shape[0]
        if compression == 2:
            out += _row_1d(changes, width)
            out += "0" * (-len(out) % 8)
        elif compression == 3:
            tag = "" if k == 1 else ("1" if y % k == 0 else "0")
            if fill:
                out += "0" * ((4 - len(out)) % 8)
            out += eol + tag
            out += _row_1d(changes, width) if k == 1 or y % k == 0 else _row_2d(changes, ref, width)
        else:
            out += _row_2d(changes, ref, width)
        ref = changes
    if compression == 3:
        out += (eol + ("1" if k > 1 else "")) * 6  # RTC
    elif compression == 4:
        out += eol * 2  # EOFB
    out += "0" * (-len(out) % 8)
    return bytes(int(out[i:i + 8], 2) for i in range(0, len(out), 8))


def assemble_tiff(order: str, blobs, entries, magic: int = 42) -> bytes:
    """A one-page TIFF: the strips or tiles ``blobs`` from byte 8, then the
    directory of ``entries`` (tag, type, values; the offsets tag's values
    None), values that do not fit an entry after it."""
    out = bytearray((b"II" if order == "<" else b"MM") + struct.pack(order + "HI", magic, 0))
    offsets = []
    for b in blobs:
        offsets.append(len(out))
        out += b + bytes(len(b) & 1)
    ifd = len(out)
    struct.pack_into(order + "I", out, 4, ifd)
    entries.sort(key=lambda e: e[0])
    data_at = ifd + 2 + 12 * len(entries) + 4
    table, tail = bytearray(struct.pack(order + "H", len(entries))), bytearray()
    for tag, typ, values in entries:
        values = offsets if values is None else values
        if typ == 5:
            raw = b"".join(struct.pack(order + "II", *v) for v in values)
        else:
            raw = struct.pack(order + {3: "H", 4: "I", 1: "B", 7: "B"}[typ] * len(values), *values)
        if len(raw) <= 4:
            table += struct.pack(order + "HHI", tag, typ, len(values)) + raw.ljust(4, b"\0")
        else:
            table += struct.pack(order + "HHII", tag, typ, len(values), data_at + len(tail))
            tail += raw + bytes(len(raw) & 1)
    return bytes(out + table + b"\0\0\0\0" + tail)


def tiff_bytes(img, order="<", compression=1, predictor=1, planar=1, tile=None, rows=None,
               photometric=None, sample_format=None, bits=None, magic=42, orientation=None,
               colormap=None, fill_order=None, extra_samples=None, subsampling=None,
               refbw=None, tags=(), ccitt=(1, False)):
    """A one-page TIFF of ``img`` (H, W) or (H, W, C) in RGB(A) order, with
    no compression (1) or deflate (8), the horizontal (2) or floating-point
    (3) predictor, chunky (1) or separate (2) samples, strips of ``rows``
    rows or ``tile`` (W, H) tiles. ``bits`` below 8 packs the values of a
    uint8 ``img`` into that many bits; ``colormap`` (3, 2**bits) uint16 is
    a palette's; ``fill_order`` 2 stores each byte's bits reversed;
    ``subsampling`` (h, v) stores a (H, W, 3) Y, Cb, Cr ``img`` as
    photometric YCbCr's data units, with ``refbw`` its six
    ReferenceBlackWhite values; compressions 2-4 code a 1-bit ``img`` (1
    black) as fax rows, ``ccitt`` the (k, fill) of :func:`ccitt_bytes`;
    ``tags`` more (tag, type, values) entries."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    dt = img.dtype
    nbits = bits or 8 * dt.itemsize
    photo = photometric if photometric is not None else (1 if c == 1 else 2)
    fmt = sample_format or (3 if dt.kind == "f" else 2 if dt.kind == "i" else 1)
    planes = [img] if planar == 1 else [img[..., s:s + 1] for s in range(c)]
    chunks = []
    step = rows or h
    for plane in planes:
        if subsampling and planar == 1:
            units = ycbcr_units(plane, *subsampling)
            per = -(-step // subsampling[1])
            chunks += [units[y:y + per] for y in range(0, units.shape[0], per)]
        elif tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), dt)
                    part = plane[ty:ty + th, tx:tx + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(t)
        else:
            chunks += [plane[y:y + step] for y in range(0, h, step)]
    blobs = []
    for chunk in chunks:
        if nbits < 8:
            raw = pack_rows(chunk, nbits)
        elif predictor == 2:  # on words of the sample's size, as libtiff's horDiff
            words = chunk.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[dt.itemsize])
            diff = words.copy()
            diff[:, 1:] = words[:, 1:] - words[:, :-1]
            raw = diff.astype(diff.dtype.newbyteorder(order)).tobytes()
        elif predictor == 3:  # bytes by significance, then differenced
            r, cw, cc = chunk.shape
            b = chunk.astype(">" + dt.str[1:]).view(np.uint8).reshape(r, cw * cc, dt.itemsize)
            b = np.ascontiguousarray(b.transpose(0, 2, 1)).reshape(r, -1)
            diff = b.copy()
            diff[:, cc:] = b[:, cc:] - b[:, :-cc]
            raw = diff.tobytes()
        else:
            raw = chunk.astype(dt.newbyteorder(order)).tobytes()
        if compression in (2, 3, 4):
            raw = ccitt_bytes(chunk[..., 0], compression, *ccitt)
        raw = zlib.compress(raw) if compression == 8 else raw
        if fill_order == 2:  # libtiff reverses the stored (coded) bytes
            raw = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little").reshape(-1, 8)
            raw = np.packbits(raw, axis=1).tobytes()
        blobs.append(raw)
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [nbits] * c),
               (259, 3, [compression]), (262, 3, [photo]), (277, 3, [c]), (284, 3, [planar]),
               (339, 3, [fmt] * c), *tags]
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    if compression == 3 and (ccitt[0] > 1 or ccitt[1]):
        entries.append((292, 4, [(ccitt[0] > 1) | 4 * bool(ccitt[1])]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, np.asarray(colormap, np.uint16).ravel().tolist()))
    if fill_order is not None:
        entries.append((266, 3, [fill_order]))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    if subsampling:
        entries.append((530, 3, list(subsampling)))
    if refbw is not None:
        entries.append((532, 5, [(int(round(x * 1000)), 1000) for x in refbw]))
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, None),
                    (325, 4, [len(b) for b in blobs])]
    else:
        entries += [(273, 4, None), (278, 3, [step]), (279, 4, [len(b) for b in blobs])]
    return assemble_tiff(order, blobs, entries, magic)


def pil_tiff(img, mode, compression, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", compression=compression, **kw)
    return buf.getvalue()


#: Why cv2 gives no frame for each still the port refuses (recorded beside
#: its feature in decoded.json).
CV2_REFUSES = {
    "refused_bigtiff.tif": "cv2.imdecode returns None",
    "refused_planar16.tif": "three cv2.imdecode calls return three different frames (unset memory)",
    "refused_gray4.tif": "cv2.imdecode returns None",
    "refused_uncompressed_tiles.tif": "cv2.imdecode returns None (libtiff: invalid tile byte count)",
    "refused_os2.bmp": "cv2.imdecode returns None",
    "refused_jpeg.bmp": "cv2.imdecode returns None",
    "refused_565_v5.bmp": "cv2.imdecode returns None",
}


def jpeg_tiff(cv2, img, photometric, rows=None, tile=None, sampling=None, quality=90) -> bytes:
    """A JPEG-in-TIFF (compression 7) of ``img`` (H, W) or (H, W, 3) RGB:
    each strip or tile (edge tiles padded by repetition) a JPEG by
    ``cv2.imencode`` (YCbCr ``sampling`` for photometric 6), its quantisation
    and Huffman tables moved into the JPEGTables tag as libtiff writes
    them."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if tile:
        tw, th = tile
        pad = np.pad(img, ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (img.ndim - 2), mode="edge")
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        parts = [img[y:y + (rows or h)] for y in range(0, h, rows or h)]
    tables, blobs = b"", []
    for part in parts:
        ok, buf = cv2.imencode(".jpg", part[..., ::-1] if c == 3 else part, params)
        assert ok
        data, pos, keep, moved = buf.tobytes(), 2, b"\xff\xd8", b""
        while data[pos + 1] != 0xDA:
            (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
            segment = data[pos:pos + 2 + length]
            if data[pos + 1] in (0xDB, 0xC4):
                moved += segment
            else:
                keep += segment
            pos += 2 + length
        tables = b"\xff\xd8" + moved + b"\xff\xd9"
        blobs.append(keep + data[pos:])
    entries = [(256, 3, [w]), (257, 3, [h]), (258, 3, [8] * c), (259, 3, [7]), (262, 3, [photometric]),
               (277, 3, [c]), (284, 3, [1]), (347, 7, list(tables))]
    if photometric == 6:
        entries.append((530, 3, [2, 2] if sampling == cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420 else [2, 1]))
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, None), (325, 4, [len(b) for b in blobs])]
    else:
        entries += [(273, 4, None), (278, 3, [rows or h]), (279, 4, [len(b) for b in blobs])]
    return assemble_tiff("<", blobs, entries)


def drawn_page(h: int, w: int) -> np.ndarray:
    """A bilevel page of drawn shapes (1 black): rules, boxes, discs and
    rows of 'text' blocks, as a scanned form holds."""
    yy, xx = np.mgrid[:h, :w]
    page = np.zeros((h, w), bool)
    s = max(1, w // 256)
    page |= (yy % (16 * s) < max(1, s // 2)) & (xx > 4 * s) & (xx < w - 4 * s)  # ruled lines
    for k in range(5):
        cy, cx, r = h * (k + 1) // 6, w * ((3 * k) % 5 + 1) // 6, (3 + k) * s
        page |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        page |= (abs(yy - cy) < 2 * r) & (abs(xx - cx) < 2 * r) & ~((abs(yy - cy) < 2 * r - s)
                                                                    & (abs(xx - cx) < 2 * r - s))
    glyphs = ((xx // (2 * s)) % 4 != 3) & ((yy // s) % 5 < 4) & ((xx // s * 7 + yy // s * 3) % 11 > 3)
    lines = (yy // (4 * s)) % 4 == 1
    page |= glyphs & lines & (xx > w // 8) & (xx < w * 7 // 8) & ((xx // (24 * s)) % 5 != 4)
    return page.astype(np.uint8)


#: Animals in the 1024^2 stills: two Gaussian blobs of this sigma in px and
#: peak, which the trained top-down pair in .convergence_runs finds (as
#: ``chip_smoke.py`` phase 4g draws them), over a smooth floor.
ANIMAL_SIGMA, ANIMAL_PEAK = 14.0, 200.0


def animal_scene(size: int, seed: int, channels: int = 1) -> np.ndarray:
    """(size, size, channels) uint8: a smooth lit floor (no noise) and two
    blob animals at seeded places, each channel's floor its own."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    floor = [25 + 20 * (xx + yy) / (2 * size) + 6 * np.sin(xx / (31.0 + 7 * c)) * np.sin(yy / 47.0)
             for c in range(channels)]
    img = np.stack(floor, -1)
    for y, x in rng.uniform(0.15, 0.85, (2, 2)) * size:
        img += ANIMAL_PEAK * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * ANIMAL_SIGMA ** 2))[..., None]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def layouts(cv2) -> dict:
    """name -> bytes of the layouts cv2 reads that the port reads since:
    orientations, signed and wide samples, min-is-white, palettes,
    bilevel and CCITT pages, YCbCr, CMYK, gray and alpha, JPEG-in-TIFF."""
    rgb = smooth(29, 37, 3, 50)
    gray = smooth(29, 37, 1, 51)[..., 0]
    bits = (gray > 120).astype(np.uint8)
    rng = np.random.default_rng(52)
    cmap16 = rng.integers(0, 65536, (3, 256)).astype(np.uint16)  # no multiples of 257 needed
    out = {f"hand_orientation{o}_37x29": tiff_bytes(rgb, orientation=o, compression=8)
           for o in range(2, 9)}
    out.update({
        "hand_int8_37x29": tiff_bytes((gray.astype(np.int16) - 128).astype(np.int8)),
        "hand_int16_pred2_37x29": tiff_bytes((gray.astype(np.int16) - 128) * 200, compression=8,
                                             predictor=2),
        "hand_int32_rgb_37x29": tiff_bytes(rgb.astype(np.int32) * -70000, compression=8),
        "hand_uint32_37x29": tiff_bytes(gray.astype(np.uint32) * 16000000, compression=8, predictor=2),
        "hand_float64_pred3_37x29": tiff_bytes(smooth(29, 37, 3, 53, np.float32).astype(np.float64) - 0.5,
                                               compression=8, predictor=3, rows=8),
        "hand_min_is_white16_37x29": tiff_bytes(gray.astype(np.uint16) * 257, photometric=0),
        "hand_min_is_white_1bit_37x29": tiff_bytes(bits, bits=1, photometric=0),
        "hand_min_is_white_float_37x29": tiff_bytes(gray.astype(np.float32) / 255, photometric=0),
        "hand_min_is_white_int8_37x29": tiff_bytes(gray.view(np.int8), photometric=0),
        "hand_palette16_37x29": tiff_bytes(gray, photometric=3, colormap=cmap16, rows=8),
        "hand_palette8bit_colormap_37x29": tiff_bytes(gray, photometric=3, colormap=cmap16 >> 8),
        "hand_palette4_37x29": tiff_bytes(gray // 16, bits=4, photometric=3, colormap=cmap16[:, :16],
                                          compression=8),
        "hand_palette1_37x29": tiff_bytes(bits, bits=1, photometric=3, colormap=cmap16[:, :2]),
        "pil_bilevel_packbits_37x29": pil_tiff(rgb, "1", "packbits"),
        "pil_bilevel_lzw_37x29": pil_tiff(rgb, "1", "tiff_lzw"),
        "hand_bilevel_fill2_37x29": tiff_bytes(bits, bits=1, fill_order=2, compression=8, rows=10),
        "pil_ccitt_rle_37x29": pil_tiff(rgb, "1", "tiff_ccitt"),
        "pil_ccitt_group3_37x29": pil_tiff(rgb, "1", "group3"),
        "hand_ccitt_mh_37x29": tiff_bytes(bits, bits=1, compression=2, photometric=0),
        "hand_ccitt_t4_2d_37x29": tiff_bytes(bits, bits=1, compression=3, photometric=0, ccitt=(4, False)),
        "hand_ccitt_t4_2d_fill_37x29": tiff_bytes(bits, bits=1, compression=3, photometric=0, rows=16,
                                                  ccitt=(2, True)),
        "hand_ccitt_t6_fill2_37x29": tiff_bytes(bits, bits=1, compression=4, photometric=0, fill_order=2),
        "hand_ycbcr11_37x29": tiff_bytes(rgb, photometric=6, subsampling=(1, 1)),
        "hand_ycbcr21_37x29": tiff_bytes(rgb, photometric=6, subsampling=(2, 1), rows=8),
        "hand_ycbcr22_refbw_37x29": tiff_bytes(rgb, photometric=6, subsampling=(2, 2), rows=8,
                                               refbw=(16, 235, 128, 240, 128, 240)),
        "hand_ycbcr42_37x29": tiff_bytes(rgb, photometric=6, subsampling=(4, 2), compression=8),
        "hand_ycbcr_planar_37x29": tiff_bytes(rgb, photometric=6, planar=2, tags=[(530, 3, [1, 1])]),
        "pil_ycbcr_37x29": pil_tiff(rgb, "YCbCr", "raw"),
        "pil_cmyk_37x29": pil_tiff(rgb, "CMYK", "tiff_lzw"),
        "hand_cmyk_planar_37x29": tiff_bytes(smooth(29, 37, 4, 54), photometric=5, planar=2, compression=8),
        "pil_gray_alpha_37x29": pil_tiff(np.dstack([gray, 255 - gray]), "LA", "tiff_lzw"),
        "hand_gray_alpha16_37x29": tiff_bytes(smooth(29, 37, 2, 55, np.uint16), photometric=1),
        "hand_gray16_3samples_37x29": tiff_bytes(smooth(29, 37, 3, 56, np.uint16), photometric=1),
        "pil_jpeg_gray_37x29": pil_tiff(rgb, "L", "jpeg"),
        "pil_jpeg_ycbcr_37x29": pil_tiff(rgb, "YCbCr", "jpeg"),
        "hand_jpeg_ycbcr22_strips_37x29": jpeg_tiff(cv2, rgb, 6, rows=16,
                                                    sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "hand_jpeg_ycbcr21_tiles_37x29": jpeg_tiff(cv2, rgb, 6, tile=(16, 16),
                                                   sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "hand_jpeg_gray_tiles_37x29": jpeg_tiff(cv2, gray, 1, tile=(32, 16)),
        # The two 1024^2 frames of animals: a JPEG-in-TIFF, and a CCITT
        # Group 4 page (white drawn shapes and the animals' discs on black).
        "animals_jpeg_ycbcr22_1024": jpeg_tiff(cv2, animal_scene(BIG, 57, 3), 6, rows=64,
                                               sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "animals_ccitt_g4_1024": tiff_bytes(drawn_page(BIG, BIG) | (animal_scene(BIG, 58)[..., 0] > 120),
                                            bits=1, compression=4, photometric=1),
    })
    return out


def tiffs(cv2) -> dict:
    """name -> (file bytes, feature the port refuses or None)."""
    from PIL import Image

    def enc(img):
        ok, buf = cv2.imencode(".tif", img)
        assert ok
        return buf.tobytes()

    out = {
        "cv2_gray_100x72": enc(smooth(72, 100, 1, 1)[..., 0]),
        "cv2_bgr_37x29": enc(smooth(29, 37, 3, 2)),
        "cv2_bgra_37x29": enc(smooth(29, 37, 4, 3)),
        "cv2_gray16_100x72": enc(smooth(72, 100, 1, 4, np.uint16)[..., 0]),
        "cv2_bgr16_37x29": enc(smooth(29, 37, 3, 5, np.uint16)),
        "cv2_float_37x29": enc(smooth(29, 37, 1, 6, np.float32)[..., 0]),
        "cv2_bgr_float_13x9": enc(smooth(9, 13, 3, 7, np.float32)),
        "cv2_gray_3x50": enc(smooth(50, 3, 1, 8)[..., 0]),
        "cv2_gray_1024": enc(smooth(BIG, BIG, 1, 9)[..., 0]),
        # 12-bit values, as a scientific camera's
        "cv2_gray16_1024": enc(smooth(BIG, BIG, 1, 10)[..., 0].astype(np.uint16) * 16),
    }
    rgb = smooth(29, 37, 3, 11)
    out["pil_gray_lzw_37x29"] = pil_tiff(rgb, "L", "tiff_lzw")
    out["pil_gray_raw_37x29"] = pil_tiff(rgb, "L", "raw")
    out["pil_rgb_deflate_37x29"] = pil_tiff(rgb, "RGB", "tiff_adobe_deflate")
    out["pil_rgb_zip_37x29"] = pil_tiff(rgb, "RGB", "tiff_deflate")
    out["pil_rgb_packbits_37x29"] = pil_tiff(rgb, "RGB", "packbits")
    rgba = np.concatenate([rgb, smooth(29, 37, 1, 12)], -1)
    out["pil_rgba_lzw_37x29"] = pil_tiff(rgba, "RGBA", "tiff_lzw")  # unassociated alpha
    buf = io.BytesIO()
    Image.fromarray(smooth(29, 37, 1, 13, np.uint16)[..., 0]).save(buf, "TIFF", compression="tiff_lzw")
    out["pil_gray16_lzw_37x29"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(smooth(29, 37, 1, 14, np.float32)[..., 0]).save(buf, "TIFF")
    out["pil_float_raw_37x29"] = buf.getvalue()
    buf = io.BytesIO()
    pages = [Image.fromarray(smooth(29, 37, 3, 15 + i)) for i in range(3)]
    pages[0].save(buf, "TIFF", compression="tiff_lzw", save_all=True, append_images=pages[1:])
    out["pil_rgb_3pages_37x29"] = buf.getvalue()
    hand = {
        "hand_gray_tiles_deflate_37x29": tiff_bytes(smooth(29, 37, 1, 20), compression=8, tile=(16, 16)),
        "hand_rgb16_tiles_37x29": tiff_bytes(smooth(29, 37, 3, 21, np.uint16), tile=(16, 16)),
        "hand_rgb_planar_deflate_37x29": tiff_bytes(smooth(29, 37, 3, 22), compression=8, planar=2,
                                                    rows=7),
        "hand_rgba_planar_tiles_37x29": tiff_bytes(smooth(29, 37, 4, 23), compression=8, planar=2,
                                                   tile=(16, 16)),
        "hand_gray16_be_pred2_37x29": tiff_bytes(smooth(29, 37, 1, 24, np.uint16), ">", 8, 2, rows=5),
        "hand_float_pred3_37x29": tiff_bytes(smooth(29, 37, 1, 25, np.float32), compression=8,
                                             predictor=3, rows=8),
        "hand_rgb_float_pred3_be_13x9": tiff_bytes(smooth(9, 13, 3, 26, np.float32), ">", 8, 3),
        "hand_float_pred2_37x29": tiff_bytes(smooth(29, 37, 1, 27, np.float32), compression=8,
                                             predictor=2),
    }
    out.update(hand)
    files = {name: (data, None) for name, data in out.items()}
    gray = smooth(29, 37, 1, 30)
    files.update({
        # Refused once, read as cv2 reads them since: the names stay.
        "refused_jpeg": (pil_tiff(rgb, "RGB", "jpeg"), None),
        "refused_ccitt": (pil_tiff(rgb, "1", "group4"), None),
        "refused_bilevel": (pil_tiff(rgb, "1", "raw"), None),
        "refused_palette": (pil_tiff(rgb, "P", "raw"), None),
        "refused_min_is_white": (tiff_bytes(gray, photometric=0), None),
        "refused_signed": (tiff_bytes(gray.astype(np.int16)), None),
        "refused_float64": (tiff_bytes(gray.astype(np.float64)), None),
        "refused_orientation": (tiff_bytes(gray, orientation=3), None),
        # Still refused: what cv2 returns is nothing, or differs read to read.
        "refused_bigtiff": (b"II+\0\x08\0\0\0" + bytes(16), "BigTIFF"),
        "refused_planar16": (tiff_bytes(smooth(9, 13, 3, 31, np.uint16), planar=2), "planar-separate"),
        "refused_gray4": (tiff_bytes((gray // 16).astype(np.uint8), bits=4), "4-bit"),
        "refused_uncompressed_tiles": (tiff_bytes(gray, tile=(16, 16)), "uncompressed tiles"),
    })
    files.update({name: (data, None) for name, data in layouts(cv2).items()})
    return files


# --------------------------------------------------------------------------- #
# BMP layouts
# --------------------------------------------------------------------------- #


def bmp_bytes(pixels, bits, palette=None, compression=0, top_down=False, header=40, masks=None,
              rle=None) -> bytes:
    """A BMP of ``pixels``: (H, W) palette indexes for ``bits`` <= 8,
    (H, W) 16-bit words, or (H, W, 3 or 4) bytes B G R (A); ``rle`` the
    coded rows instead; ``masks`` after a 40-byte header, or in a longer
    one."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    if rle is None:
        rows = []
        for row in pixels:
            if bits == 1:
                raw = np.packbits(row.astype(np.uint8)).tobytes()
            elif bits == 4:
                r = np.concatenate([row, [0] * (len(row) % 2)]).astype(np.uint8)
                raw = ((r[0::2] << 4) | r[1::2]).astype(np.uint8).tobytes()
            elif bits == 16:
                raw = row.astype("<u2").tobytes()
            else:
                raw = row.astype(np.uint8).tobytes()
            rows.append(raw + bytes(-len(raw) % 4))
        data = b"".join(rows if top_down else rows[::-1])
    else:
        data = rle
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression,
                       len(data), 2835, 2835, len(pal) // 4, 0)
    if header > 40:
        m = list(masks or (0, 0, 0, 0)) + [0] * 4
        info += (struct.pack("<IIII", *m[:4]) + b"BGRs").ljust(header - 40, b"\0")
    after = struct.pack("<III", *masks[:3]) if masks is not None and header == 40 else b""
    offset = 14 + len(info) + len(after) + len(pal)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + after + pal + data


def rle_rows(idx, bits) -> bytes:
    """RLE8 or RLE4 of (H, W) indexes, bottom row first: each row as runs
    (RLE4: of one index), an absolute block where a row starts with three
    different indexes, a delta over the middle of the second row, an
    end-of-line escape after each row, and an end-of-bitmap escape a row
    early (the top row is left to index 0)."""
    h, w = idx.shape
    out = bytearray()
    for n, r in enumerate(range(h - 1, 0, -1)):
        row = idx[r]
        x = 0
        if n == 1 and w >= 8:  # a delta: skip four pixels, no rows
            out += bytes([1, row[0] if bits == 8 else row[0] << 4 | row[0], 0, 2, 4, 0])
            x = 5
        elif w >= 4 and len(set(row[:3].tolist())) == 3:
            k = 4 if bits == 4 else 3
            vals = row[:k].astype(np.uint8)
            if bits == 4:
                raw = bytes(((vals[0::2] << 4) | vals[1::2]).tolist())
            else:
                raw = vals.tobytes()
            out += bytes([0, k]) + raw + bytes(len(raw) & 1)
            x = k
        while x < w:
            j = x
            while j < w and row[j] == row[x] and j - x < 255:
                j += 1
            out += bytes([j - x, row[x] if bits == 8 else row[x] << 4 | row[x]])
            x = j
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmps(cv2) -> dict:
    """name -> (file bytes, feature the port refuses or None)."""
    def enc(img):
        ok, buf = cv2.imencode(".bmp", img)
        assert ok
        return buf.tobytes()

    from PIL import Image

    def pil(img, mode):
        buf = io.BytesIO()
        Image.fromarray(img).convert(mode).save(buf, "BMP")
        return buf.getvalue()

    gray_pal = np.stack([np.arange(256)] * 3 + [np.zeros(256)], 1).astype(np.uint8)
    rng = np.random.default_rng(40)
    colour_pal = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    idx16 = (smooth(29, 37, 1, 41)[..., 0] // 16).astype(np.uint8)
    idx8 = (smooth(29, 37, 1, 42)[..., 0] // 4).astype(np.uint8)
    words = smooth(29, 37, 1, 43, np.uint16)[..., 0]
    bgra = smooth(29, 37, 4, 44)
    rgb = smooth(29, 37, 3, 45)
    files = {
        "cv2_gray_100x72": enc(smooth(72, 100, 1, 46)[..., 0]),
        "cv2_bgr_37x29": enc(smooth(29, 37, 3, 47)),
        "cv2_bgra_3x50": enc(smooth(50, 3, 4, 48)),
        "pil_1bit_37x29": pil(rgb, "1"),
        "pil_gray_37x29": pil(rgb, "L"),
        "pil_palette_37x29": pil(rgb, "P"),
        "pil_rgb_37x29": pil(rgb, "RGB"),
        "pil_rgba_37x29": pil(np.concatenate([rgb, smooth(29, 37, 1, 49)], -1), "RGBA"),
        "hand_4bit_gray_37x29": bmp_bytes(idx16, 4, gray_pal[::17]),
        "hand_4bit_colour_37x29": bmp_bytes(idx16, 4, colour_pal[:16]),
        "hand_8bit_colour_top_down_37x29": bmp_bytes(idx8, 8, colour_pal[:64], top_down=True),
        "hand_555_37x29": bmp_bytes(words, 16),
        "hand_565_37x29": bmp_bytes(words, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "hand_24bit_top_down_37x29": bmp_bytes(rgb, 24, top_down=True),
        "hand_32bit_v4_37x29": bmp_bytes(bgra, 32, compression=3, header=108,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        "hand_32bit_rgb_37x29": bmp_bytes(bgra, 32),
        "hand_rle8_gray_37x29": bmp_bytes(idx8, 8, gray_pal, compression=1, rle=rle_rows(idx8, 8)),
        "hand_rle8_colour_37x29": bmp_bytes(idx8, 8, colour_pal[:64], compression=1,
                                            rle=rle_rows(idx8, 8)),
        "hand_rle4_colour_37x29": bmp_bytes(idx16, 4, colour_pal[:16], compression=2,
                                            rle=rle_rows(idx16, 4)),
    }
    files = {name: (data, None) for name, data in files.items()}
    core = b"BM" + struct.pack("<IHHI", 26 + 3 * 4, 0, 0, 26) + struct.pack("<IHHHH", 12, 2, 2, 1, 24)
    files.update({
        "refused_os2": (core + bytes(12), "OS/2"),
        "refused_jpeg": (bmp_bytes(rgb, 24, compression=4), "JPEG"),
        "refused_565_v5": (bmp_bytes(words, 16, compression=3, header=124,
                                     masks=(0xF800, 0x7E0, 0x1F, 0)), "bitfields"),
    })
    return files


# --------------------------------------------------------------------------- #
# Records
# --------------------------------------------------------------------------- #


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape), "dtype": str(img.dtype)}


def versions(cv2) -> dict:
    import PIL
    from PIL import features

    return {"cv2": cv2.__version__, "libtiff": features.version("libtiff"), "pillow": PIL.__version__,
            "numpy": np.__version__}


def committed(ext: str):
    return sorted(f[:-len(ext) - 1] for f in os.listdir(OUT) if f.endswith("." + ext))


def write_records(cv2) -> None:
    """decoded.json (whose refusals are kept) and encoded.json, from the
    committed files."""
    path = os.path.join(OUT, "decoded.json")
    old = json.load(open(path))["stills"] if os.path.exists(path) else {}
    decoded, encoded = {}, {}
    for ext in ("bmp", "tif"):
        for name in committed(ext):
            key = f"{name}.{ext}"
            with open(os.path.join(OUT, key), "rb") as fh:
                data = fh.read()
            reads = [cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) for _ in range(3)]
            if "refused" in old.get(key, {}):
                assert reads[0] is None or not all(np.array_equal(reads[0], r) for r in reads), key
                decoded[key] = {"refused": old[key]["refused"], "cv2": CV2_REFUSES[key]}
                continue
            img = reads[0]
            assert img is not None and all(np.array_equal(img, r) for r in reads), key
            decoded[key] = digest(img)
            frames = {key: img}
            if img.shape[:2] == (BIG, BIG):
                for w, h in CROPS:
                    frames[f"{key}_crop_{w}x{h}"] = np.ascontiguousarray(img[1:1 + h, 1:1 + w])
            for fname, frame in frames.items():
                for fmt in ("bmp", "tif"):
                    # The port writes what the JAX package writes: BMP of
                    # uint8, TIFF of uint8, uint16 and float32 frames.
                    if frame.dtype not in ((np.uint8,) if fmt == "bmp" else WRITTEN_DTYPES):
                        continue
                    ok, buf = cv2.imencode("." + fmt, frame)
                    assert ok
                    encoded[f"{fname}.{fmt}"] = {"sha256": hashlib.sha256(buf.tobytes()).hexdigest(),
                                                 "bytes": int(buf.size), "shape": list(frame.shape),
                                                 "dtype": str(frame.dtype)}
    for name, record in (("decoded.json", {"stills": decoded}), ("encoded.json", {"frames": encoded})):
        with open(os.path.join(OUT, name), "w") as fh:
            json.dump({"versions": versions(cv2), **record}, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(f"wrote decoded.json ({len(decoded)} files) and encoded.json ({len(encoded)} frames)")


def main() -> None:
    import argparse

    import cv2

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--records", action="store_true", help="write only the two JSON records")
    if parser.parse_args().records:
        write_records(cv2)
        return
    os.makedirs(OUT, exist_ok=True)
    refused = {}
    for ext, files in (("tif", tiffs(cv2)), ("bmp", bmps(cv2))):
        for name, (data, feature) in files.items():
            with open(os.path.join(OUT, f"{name}.{ext}"), "wb") as fh:
                fh.write(data)
            if feature:
                refused[f"{name}.{ext}"] = {"refused": feature}
    with open(os.path.join(OUT, "decoded.json"), "w") as fh:
        json.dump({"stills": refused}, fh)
    write_records(cv2)
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {len(os.listdir(OUT))} files under {OUT}: {total / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
