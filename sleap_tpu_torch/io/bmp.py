"""Read BMP stills as ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` returns
them and write them as ``cv2.imencode(".bmp", img)`` writes them (OpenCV
5's ``grfmt_bmp.cpp``), byte for byte: the port's BMP codec for image
folders, ``.pkg.slp`` and HDF5 frame rows and ImgStores, where ``cv2`` is
not installed.

Reading (:func:`imdecode`), with a BITMAPINFOHEADER or a longer one (V4,
V5), rows bottom-up or top-down, as OpenCV's reader sees them:

- 1-, 4- and 8-bit palette images, uncompressed, or RLE8 / RLE4 coded
  (pixels an escape skips, and the rest of a line or the image after an
  end-of-line or end-of-bitmap escape, take palette entry 0; an RLE4 delta
  moves across columns only, as OpenCV's reader moves it): (H, W) uint8
  where every entry of the 2^bits palette is gray (R = G = B; entries past
  the file's are black), else (H, W, 3) BGR;
- 16-bit 5-5-5 (``BI_RGB``, or ``BI_BITFIELDS`` with those masks) and 5-6-5
  (``BI_BITFIELDS``) as (H, W, 3): each field shifted to the top of its
  byte, the low bits zero. OpenCV reads the masks from the 12 bytes after the
  header, whatever its length, and refuses masks of any other layout;
- 24-bit as (H, W, 3); 32-bit ``BI_RGB`` as (H, W, 3) (the fourth byte
  dropped) and 32-bit ``BI_BITFIELDS`` as (H, W, 4), bytes B, G, R, A
  whatever the masks say.

OS/2 headers, other compressions (JPEG, PNG, Huffman), other bit depths and
16-bit masks of other layouts raise :class:`UnsupportedBmp` naming the
feature; malformed files raise ``ValueError``.

Writing (:func:`imencode`): gray as 8 bits with a 256-entry gray palette
(pixels at byte 1078), BGR as 24 bits (at byte 54), BGRA as 32 bits with a
BITMAPV5HEADER and ``BI_BITFIELDS`` (at byte 138); rows bottom-up, padded
to 4 bytes with zeros. Other dtypes are brought to uint8 first as cv2's
``convertTo`` does: clipped to 0-255 and rounded half to even.

One route: both devices decode and encode in numpy on the host, as the JAX
package does with cv2 (``sleap_tpu/io/video.py``, ``sleap_tpu/io/slp.py``,
``sleap_tpu/io/dirimgstore.py``); no kernel and no compiled code.
"""

from __future__ import annotations

import struct
import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_COMPRESSIONS = {4: "JPEG", 5: "PNG", 6: "BI_ALPHABITFIELDS", 11: "CMYK", 12: "CMYK RLE8",
                 13: "CMYK RLE4"}


class UnsupportedBmp(ValueError):
    """The file uses a BMP feature outside the subset this module reads."""


def _header(data: bytes):
    """(pixel offset, header size, width, height, bits, compression,
    palette (n, 4) B G R x, 16-bit layout)."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ValueError("Not a BMP stream (no 'BM' signature).")
    (offset,) = struct.unpack_from("<I", data, 10)
    (size,) = struct.unpack_from("<I", data, 14)
    if size == 12:
        raise UnsupportedBmp("OS/2 BMPs (BITMAPCOREHEADER) are not supported.")
    if size < 36 or len(data) < 14 + size:
        raise ValueError(f"BMP header of {size} bytes is malformed or truncated.")
    width, height, _, bits, compression = struct.unpack_from("<iiHHI", data, 18)
    (clrused,) = struct.unpack_from("<I", data, 46)
    if compression in _COMPRESSIONS or compression > BI_BITFIELDS:
        raise UnsupportedBmp(f"BMP compression {_COMPRESSIONS.get(compression, compression)} is "
                             "not supported.")
    ok = ((bits in (1, 4, 8, 24, 32) and compression == BI_RGB)
          or (bits in (16, 32) and compression == BI_BITFIELDS)
          or (bits == 16 and compression == BI_RGB)
          or (bits == 4 and compression == BI_RLE4) or (bits == 8 and compression == BI_RLE8))
    if not ok:
        raise UnsupportedBmp(f"{bits}-bit BMPs of compression {compression} are not supported.")
    if width <= 0 or height == 0:
        raise ValueError(f"BMP of {width} x {height} pixels is malformed.")
    at = 14 + size
    palette, layout = None, None
    if bits <= 8:
        if clrused > 256:
            raise ValueError(f"BMP palette of {clrused} colours is malformed.")
        n = clrused or (1 << bits)
        palette = np.zeros((256, 4), np.uint8)
        raw = np.frombuffer(data[at:at + 4 * n], np.uint8)
        palette[:len(raw) // 4] = raw[:len(raw) // 4 * 4].reshape(-1, 4)
    elif bits == 16:
        layout = 555
        if compression == BI_BITFIELDS:
            r, g, b = struct.unpack_from("<III", data + bytes(12), at)
            layout = {(0x7C00, 0x3E0, 0x1F): 555, (0xF800, 0x7E0, 0x1F): 565}.get((r, g, b))
            if layout is None:
                raise UnsupportedBmp(f"16-bit BMP bitfields {r:#x}/{g:#x}/{b:#x} are not supported "
                                     "(5-5-5 and 5-6-5 only).")
    return offset, width, height, bits, compression, palette, layout


def _rle(data: bytes, pos: int, width: int, height: int, bits: int) -> np.ndarray:
    """RLE8 or RLE4 palette indexes, (height, width) from the first stored
    row (the bottom one for a bottom-up file), as OpenCV's reader fills them:
    the pixels a delta skips, and the rest of a line after an end-of-line
    escape or of the image after an end-of-bitmap escape, are index 0. An
    RLE8 run that ends its line moves to the next one, and an end-of-line
    right after it adds no blank line; a run or absolute block past its
    line's end is malformed. OpenCV's RLE4 reader moves a delta across its
    columns only (wrapping at the row's end), not down its rows."""
    flat = np.zeros(width * height, np.uint8)
    x = y = 0  # column and stored row of the next pixel
    n = len(data)

    def byte_pair():
        nonlocal pos
        if pos + 2 > n:
            raise ValueError("BMP RLE data ends before its end-of-bitmap escape.")
        pos += 2
        return data[pos - 2], data[pos - 1]

    def fill(count):
        """OpenCV's ``FillUniColor`` with index 0: ``count`` pixels, line
        after line; reaching a line's end moves to the next."""
        nonlocal x, y
        while True:
            step = min(count, width - x)
            count -= step
            x += step
            if x >= width:
                x, y = 0, y + 1
                if y >= height:
                    return
            if count <= 0:
                return

    wrapped = False  # RLE8: the last run ended its line and moved on
    while True:
        length, code = byte_pair()
        if length:  # a run of one index (RLE4: two, alternating)
            if x + length > width:
                raise ValueError("BMP RLE run passes the end of its line.")
            at = y * width + x
            if bits == 8:
                flat[at:at + length] = code
            else:
                flat[at:at + length] = np.where(np.arange(length) & 1, code & 15, code >> 4)
            x += length
            if bits == 8:
                wrapped = x >= width
                if wrapped:
                    x, y = 0, y + 1
                    if y >= height:
                        break
        elif code > 2:  # absolute: `code` indexes, padded to a whole word
            if x + code > width:
                raise ValueError("BMP RLE absolute block passes the end of its line.")
            size = code if bits == 8 else (code + 1) >> 1
            size += size & 1
            if pos + size > n:
                raise ValueError("BMP RLE data ends inside an absolute block.")
            raw = np.frombuffer(data, np.uint8, size, pos)
            pos += size
            if bits == 4:
                raw = np.stack([raw >> 4, raw & 15], 1).reshape(-1)
            flat[y * width + x:y * width + x + code] = raw[:code]
            x += code
            wrapped = False
        else:  # 0 end of line, 1 end of bitmap, 2 delta (dx, dy)
            count, rows = width - x, height - y
            if bits == 4 or code or not wrapped or count < width:
                if code == 2:
                    count, rows = byte_pair()
                    if bits == 4:
                        rows = 0  # OpenCV's RLE4 moves a delta's columns, not its rows
                if code:
                    count += rows * width
                fill(count)
                if y >= height:
                    break
            wrapped = False
    return flat.reshape(height, width)


def _gray_palette(palette: np.ndarray, bits: int) -> bool:
    """OpenCV's ``IsColorPalette`` negated: every one of the 2^bits entries
    has B = G = R."""
    p = palette[:1 << bits]
    return bool(np.all(p[:, 0] == p[:, 1]) and np.all(p[:, 0] == p[:, 2]))


def imdecode(data: bytes, device="cpu") -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` of a BMP: (H, W) uint8
    for gray-palette images, (H, W, 3) BGR, or (H, W, 4) BGRA for 32-bit
    ``BI_BITFIELDS``. ``device`` is accepted for the other codecs' interface:
    BMP has one route, numpy on the host."""
    data = bytes(data)
    offset, width, height, bits, compression, palette, layout = _header(data)
    rows = abs(height)
    if bits <= 8 and compression in (BI_RLE8, BI_RLE4):
        stored = _rle(data, offset, width, rows, bits)
    else:
        pitch = ((width * bits + 7) // 8 + 3) & ~3
        if offset + pitch * rows > len(data):
            raise ValueError(f"BMP pixel data is truncated ({len(data) - offset} of {pitch * rows} "
                             "bytes).")
        raw = np.frombuffer(data, np.uint8, pitch * rows, offset).reshape(rows, pitch)
        if bits < 8:
            stored = np.unpackbits(raw, axis=1)
            if bits == 4:
                stored = (stored.reshape(rows, -1, 4) * np.array([8, 4, 2, 1], np.uint8)).sum(2)
            stored = stored[:, :width].astype(np.uint8)
        elif bits == 8:
            stored = raw[:, :width]
        elif bits == 16:
            t = raw[:, :2 * width].copy().view("<u2").astype(np.uint16)
            b = (t << 3) & 0xF8
            g = ((t >> 2) if layout == 555 else (t >> 3)) & (0xF8 if layout == 555 else 0xFC)
            r = ((t >> 7) if layout == 555 else (t >> 8)) & 0xF8
            stored = np.stack([b, g, r], -1).astype(np.uint8)
        else:
            stored = raw[:, :width * bits // 8].reshape(rows, width, bits // 8)
            if bits == 32 and compression == BI_RGB:
                stored = stored[..., :3]
    if palette is not None:
        stored = palette[stored, 0] if _gray_palette(palette, bits) else palette[stored, :3]
    img = stored[::-1] if height > 0 else stored
    return np.ascontiguousarray(img)


# --------------------------------------------------------------------------- #
# Writing: cv2.imencode(".bmp", img)
# --------------------------------------------------------------------------- #


def _as_uint8(img) -> np.ndarray:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) as uint8, as cv2's
    ``convertTo(CV_8U)`` brings other dtypes: clipped, rounded half to
    even."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (3, 4)) \
            or not img.shape[0] or not img.shape[1]:
        raise ValueError(f"BMP frames are (H, W), (H, W, 1), (H, W, 3) BGR or (H, W, 4) BGRA, not "
                         f"{img.shape}.")
    if img.dtype == np.uint8:
        return img
    if img.dtype == np.bool_ or not np.issubdtype(img.dtype, np.number):
        raise ValueError(f"BMP frames are written from numbers, not {img.dtype}.")
    if np.issubdtype(img.dtype, np.floating):
        img = np.rint(img.astype(np.float64))
    return np.clip(img, 0, 255).astype(np.uint8)


_V5_MASKS = struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000) + b"BGRs"


def imencode(img, device="cpu") -> bytes:
    """``cv2.imencode(".bmp", img)[1].tobytes()``: the BMP of an (H, W) or
    (H, W, 1) gray, (H, W, 3) BGR or (H, W, 4) BGRA frame, as OpenCV writes
    it. ``device`` is accepted for the other codecs' interface."""
    img = _as_uint8(img)
    height, width = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    step = (width * channels + 3) & ~3
    info = 124 if channels == 4 else 40
    palette = 1024 if channels == 1 else 0
    offset = 14 + info + palette
    out = bytearray(b"BM" + struct.pack("<IHHI", offset + step * height, 0, 0, offset))
    out += struct.pack("<IiiHHIIiiII", info, width, height, 1, 8 * channels,
                       BI_BITFIELDS if channels == 4 else BI_RGB, 0, 0, 0, 0, 0)
    if channels == 4:
        out += _V5_MASKS + bytes(info - 40 - len(_V5_MASKS))
    if channels == 1:
        out += np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4).__mul__(
            np.array([1, 1, 1, 0], np.uint8)).tobytes()
    rows = np.zeros((height, step), np.uint8)
    rows[:, :width * channels] = img.reshape(height, -1)
    return bytes(out) + rows[::-1].tobytes()

