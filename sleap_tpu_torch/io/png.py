"""Decode PNG images from bytes, in Python and numpy (``zlib`` from the
standard library): the port's counterpart of ``cv2.imdecode`` for the PNG
frames embedded in ``.pkg.slp`` files, where ``cv2`` is not installed.

The subset is what ``cv2.imencode(".png", frame)`` writes for the uint8
frames of a video: 8-bit grayscale and 8-bit colour, not interlaced, with
any of the five row filters (None, Sub, Up, Average, Paeth). :func:`imdecode`
returns what ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` returns: (H, W)
for grayscale, (H, W, 3) in BGR order for colour. Other PNGs (16-bit,
palette, alpha, interlaced) raise ``ValueError`` naming the feature.

None, Sub and Up rows are vectorised a row at a time. Average and Paeth
depend on the pixel to the left as well as on the row above, so the rows from
the first to the last of them are decoded as a wavefront: pixel (y, x) needs
only (y, x-1), (y-1, x) and (y-1, x-1), so each anti-diagonal y + x = d is one
set of numpy steps, about H + W steps for the block instead of H * W Python
steps (PERF.md, section 6, gives the times).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3}
_COLOR_NAMES = {3: "palette", 4: "grayscale with alpha", 6: "RGB with alpha"}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left ``a``, above ``b`` and upper-left ``c``."""
    da, db = a - c, b - c  # p - b and p - a, where p = a + b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where(pa <= np.minimum(pb, pc), a, np.where(pb <= pc, b, c))


def _predict(kind: int, a: np.ndarray, b: np.ndarray, c: np.ndarray):
    """What a row of filter ``kind`` adds to its bytes."""
    if kind == 0:
        return 0
    if kind == 1:
        return a
    if kind == 2:
        return b
    return (a + b) >> 1 if kind == 3 else _paeth(a, b, c)


def _unfilter_wavefront(kinds: np.ndarray, lines: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Rows of any filters, ``lines`` (R, W * bpp) after the decoded row
    ``prev``, by anti-diagonals. Pixel (r, j) sits at (r + 1, j + 1) of a
    zero-bordered (R + 1, W + 1) grid, so a diagonal, and each of its left,
    above and upper-left neighbours, is a slice of the flat grid with step W.
    A diagonal across rows of several filters takes each row's prediction."""
    rows, width = lines.shape[0], lines.shape[1] // bpp
    grid = np.zeros((rows + 1, width + 1, bpp), np.int16)
    grid[0, 1:] = prev.reshape(width, bpp)
    flat = grid.reshape(-1, bpp)
    src = np.zeros_like(grid)
    src[1:, 1:] = lines.reshape(rows, width, bpp)
    src = src.reshape(-1, bpp)
    run = np.concatenate([[0], np.cumsum(kinds[1:] != kinds[:-1])]).tolist()
    kind_of = kinds.tolist()
    paeths = np.concatenate([[0], np.cumsum(kinds == 4)]).tolist()
    # A diagonal across runs: None, Sub, Up and Average rows predict
    # (ka * a + kb * b) >> ks, Paeth rows their own.
    ka = np.isin(kinds, (1, 3)).astype(np.int16)[:, None]
    kb = np.isin(kinds, (2, 3)).astype(np.int16)[:, None]
    ks = (kinds == 3).astype(np.int16)[:, None]
    is_paeth = (kinds == 4)[:, None]
    for d in range(rows + width - 1):
        lo, hi = max(0, d - width + 1), min(rows - 1, d)
        start = lo * width + width + d + 2
        at = slice(start, start + (hi - lo) * width + 1, width)
        a = flat[start - 1:at.stop - 1:width]
        b = flat[start - width - 1:at.stop - width - 1:width]
        c = flat[start - width - 2:at.stop - width - 2:width]
        if run[lo] == run[hi]:
            pred = _predict(kind_of[lo], a, b, c)
        else:
            k = slice(lo, hi + 1)
            pred = (ka[k] * a + kb[k] * b) >> ks[k]
            if paeths[hi + 1] > paeths[lo]:
                pred = np.where(is_paeth[k], _paeth(a, b, c), pred)
        flat[at] = (src[at] + pred) & 0xFF
    return grid[1:, 1:].reshape(rows, width * bpp).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A PNG's pixels as (H, W, C) uint8, channels in the file's order
    (gray, or R, G, B)."""
    data = bytes(data)
    if data[:8] != SIGNATURE:
        raise ValueError("Not a PNG stream (bad signature).")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind.decode(errors='replace')} fails its CRC.")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk.")
    width, height, depth, color, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{depth}-bit PNGs are not supported (8-bit only).")
    if color not in _COLOR_CHANNELS:
        raise ValueError(f"{_COLOR_NAMES.get(color, color)} PNGs are not supported.")
    if interlace:
        raise ValueError("Interlaced (Adam7) PNGs are not supported.")
    bpp = _COLOR_CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated.")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        y = int(np.argmax(kinds > 4))
        raise ValueError(f"PNG row {y} has an unknown filter type {kinds[y]}.")
    # Rows from the first Average or Paeth row to the last go as one wavefront.
    last = int(np.flatnonzero(kinds >= 3)[-1]) if (kinds >= 3).any() else -1
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    y = 0
    while y < height:
        kind, end = kinds[y], y + 1
        if kind >= 3:
            end = last + 1
            out[y:end] = _unfilter_wavefront(kinds[y:end], rows[y:end, 1:], prev, bpp)
        elif kind == 0:
            out[y] = rows[y, 1:]
        elif kind == 1:
            out[y] = np.cumsum(rows[y, 1:].reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:
            out[y] = rows[y, 1:] + prev
        prev = out[end - 1]
        y = end
    return out.reshape(height, width, bpp)


def imdecode(data: bytes) -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` for the PNGs
    :func:`decode` reads: (H, W) grayscale, or (H, W, 3) BGR."""
    img = decode(data)
    return img[..., 0] if img.shape[2] == 1 else np.ascontiguousarray(img[..., ::-1])
