"""Encode and decode PNG images, in Python and numpy (``zlib`` from the
standard library), with a compiled row unfilter on the card's route: the
port's counterpart of ``cv2.imencode(".png", ...)`` and ``cv2.imdecode``
for the frames of ``.pkg.slp`` files, ImgStores and image folders, where
``cv2`` is not installed.

Decoding (:func:`decode`, :func:`imdecode`): 8-bit PNGs, not interlaced,
with any of the five row filters (None, Sub, Up, Average, Paeth), of gray,
gray with alpha, RGB, RGB with alpha, or palette colour (expanded, with
alpha where a ``tRNS`` chunk gives it). :func:`imdecode` returns what
``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` returns: (H, W) for gray,
(H, W, 3) BGR, or (H, W, 4) BGRA (gray with alpha replicated to BGR).
16-bit, sub-byte and interlaced PNGs raise ``ValueError`` naming the feature.

Two routes unfilter the rows, by the ``device`` asked for:

- ``"cpu"``, the plain version: None, Sub and Up rows are vectorised a row
  at a time. Average and Paeth depend on the pixel to the left as well as
  on the row above, so the rows from the first to the last of them are
  decoded as a wavefront: pixel (y, x) needs only (y, x-1), (y-1, x) and
  (y-1, x-1), so each anti-diagonal y + x = d is one set of numpy steps,
  about H + W steps for the block instead of H * W Python steps.
- ``"cuda"``: ``sleap_png_unfilter`` in ``csrc/png.cu``, host C built into
  the kernel library, one sequential pass over the rows (PERF.md, section
  6, gives both routes' times). A failed build raises; there is no fallback.

Encoding (:func:`encode`, :func:`imencode`): (H, W), (H, W, 1) and
(H, W, 3) uint8, the last read as BGR as ``cv2.imencode`` reads it. Every
row is filtered with Sub and deflated at zlib level 1 with the run-length
strategy, as OpenCV's encoder sets libpng up (``IMWRITE_PNG_COMPRESSION``
1, ``IMWRITE_PNG_STRATEGY_RLE``): the same sizes as cv2's within a few
per cent, at zlib's fastest level, and Sub rows are the ones the plain
decoder vectorises whole.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

import torch

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_NAMES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale with alpha",
                6: "RGB with alpha"}


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


def unfilter_plain(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered rows -> (H, stride) bytes, in numpy."""
    height, stride = rows.shape[0], rows.shape[1] - 1
    width = stride // bpp
    kinds = rows[:, 0]
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
    return out


def unfilter_host(rows: np.ndarray, bpp: int) -> np.ndarray:
    """:func:`unfilter_plain` in host C (``sleap_png_unfilter``)."""
    from sleap_tpu_torch.ops import _build

    rows = np.ascontiguousarray(rows, np.uint8)
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    bad = _build.entry("sleap_png_unfilter")(rows.ctypes.data, rows.shape[0], rows.shape[1] - 1,
                                              bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type {rows[bad - 1, 0]}.")
    return out


@dataclass
class Png:
    """A PNG's filtered rows, (H, 1 + W * bpp) uint8 with each row's filter
    type first, and what expands them to pixels."""

    rows: np.ndarray
    width: int
    bpp: int
    color: int
    palette: Optional[np.ndarray]
    trns: Optional[np.ndarray]


def read(data: bytes) -> Png:
    """Check a PNG's chunks and inflate its image data into filtered rows."""
    data = bytes(data)
    if data[:8] != SIGNATURE:
        raise ValueError("Not a PNG stream (bad signature).")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind.decode(errors='replace')} fails its CRC.")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG stream has no IHDR chunk.")
    width, height, depth, color, _, _, interlace = header
    if color not in _COLOR_CHANNELS:
        raise ValueError(f"PNGs of colour type {color} are not supported.")
    if depth != 8:
        raise ValueError(f"{depth}-bit {_COLOR_NAMES[color]} PNGs are not supported (8-bit only).")
    if interlace:
        raise ValueError("Interlaced (Adam7) PNGs are not supported.")
    if color == 2 and trns is not None:
        raise ValueError("RGB PNGs with a tRNS transparent colour are not supported.")
    if color == 3 and palette is None:
        raise ValueError("Palette PNG has no PLTE chunk.")
    bpp = _COLOR_CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated.")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    return Png(rows, width, bpp, color, palette, trns)


def decode(data: bytes, device="cuda") -> np.ndarray:
    """A PNG's pixels as (H, W, C) uint8, channels in the file's order
    (gray, gray and alpha, R G B, or R G B A; palette colours expanded to
    R G B, and A where the file gives transparency). ``device`` "cuda"
    (the default, as for every entry point of the port) unfilters the rows
    in host C, "cpu" in numpy."""
    p = read(data)
    if torch.device(device).type == "cuda":
        out = unfilter_host(p.rows, p.bpp)
    else:
        kinds = p.rows[:, 0]
        if (kinds > 4).any():
            y = int(np.argmax(kinds > 4))
            raise ValueError(f"PNG row {y} has an unknown filter type {kinds[y]}.")
        out = unfilter_plain(p.rows, p.bpp)
    img = out.reshape(len(out), p.width, p.bpp)
    if p.color != 3:
        return img
    index = img[..., 0]
    if index.size and int(index.max()) >= len(p.palette):
        raise ValueError(f"PNG pixel indexes colour {int(index.max())} of a palette of "
                         f"{len(p.palette)}.")
    if p.trns is None:
        return p.palette[index]
    alpha = np.full(len(p.palette), 255, np.uint8)
    alpha[:min(len(p.trns), len(p.palette))] = p.trns[:len(p.palette)]
    return np.concatenate([p.palette, alpha[:, None]], 1)[index]


def imdecode(data: bytes, device="cuda") -> np.ndarray:
    """``cv2.imdecode(data, cv2.IMREAD_UNCHANGED)`` for the PNGs
    :func:`decode` reads: (H, W) gray, (H, W, 3) BGR, or (H, W, 4) BGRA."""
    img = decode(data, device)
    channels = img.shape[2]
    if channels == 1:
        return img[..., 0]
    if channels == 2:  # gray and alpha -> B = G = R = gray, A
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0, 3][:channels]
    return np.ascontiguousarray(img[..., order])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(img: np.ndarray) -> bytes:
    """A PNG of (H, W) or (H, W, 1) gray, or (H, W, 3) uint8 whose channels
    are written in the order given (R, G, B in the file)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoding takes uint8 images, not {img.dtype}.")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"PNG encoding takes (H, W), (H, W, 1) or (H, W, 3) images, not {img.shape}.")
    height, width, channels = img.shape
    if height == 0 or width == 0:
        raise ValueError("PNG encoding takes a non-empty image.")
    lines = img.reshape(height, width * channels)
    rows = np.empty((height, width * channels + 1), np.uint8)
    rows[:, 0] = 1  # Sub: each byte minus the byte one pixel to its left
    rows[:, 1:channels + 1] = lines[:, :channels]
    np.subtract(lines[:, channels:], lines[:, :-channels], out=rows[:, channels + 1:])
    deflate = zlib.compressobj(1, zlib.DEFLATED, 15, 8, zlib.Z_RLE)
    body = deflate.compress(rows.tobytes()) + deflate.flush()
    header = struct.pack(">IIBBBBB", width, height, 8, 0 if channels == 1 else 2, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", body) + _chunk(b"IEND", b"")


def imencode(ext: str, img: np.ndarray) -> Tuple[bool, np.ndarray]:
    """``cv2.imencode(".png", img)``: (True, the PNG's bytes as (n, 1)
    uint8), with (H, W, 3) images read as BGR."""
    if ext.lower() != ".png":
        raise ValueError(f"imencode writes .png only, not {ext!r}.")
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    return True, np.frombuffer(encode(img), np.uint8).reshape(-1, 1)
