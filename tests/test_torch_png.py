"""The port's PNG decoder (``sleap_tpu_torch.io.png``) against
``cv2.imdecode``: cv2-encoded gray and colour frames, and crafted streams
whose rows use each of the five filters. Decoding is exact."""

from __future__ import annotations

import struct
import zlib

import cv2
import numpy as np
import pytest

from sleap_tpu_torch.io import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img: np.ndarray, filters) -> bytes:
    """A PNG of (H, W, C) uint8 ``img`` whose row y uses filter
    ``filters[y % len(filters)]``, each applied as the PNG specification
    defines it."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int64)
    raw = b""
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][kind]
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0)
    return png.SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _frame(h, w, c, seed):
    """Smooth blobs plus noise: cv2 picks different filters row by row."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = 120 * np.exp(-((yy - h / 3) ** 2 + (xx - w / 2) ** 2) / (2 * 9.0**2))
    img = img[..., None] + rng.integers(0, 40, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size", [(48, 64), (31, 17)])
def test_imdecode_matches_cv2_on_cv2_encoded_frames(channels, size):
    img = _frame(*size, channels, seed=channels)
    ok, buf = cv2.imencode(".png", img if channels == 3 else img[..., 0])
    assert ok
    mine = png.imdecode(buf.tobytes())
    ref = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 3])
def test_each_row_filter_decodes_exactly(filters, channels):
    img = _frame(21, 19, channels, seed=7)
    data = _encode(img, filters)
    np.testing.assert_array_equal(png.decode(data), img)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(png.imdecode(data), ref)


@pytest.mark.parametrize("size", [(40, 7), (7, 40), (1, 9), (9, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_wavefront_blocks_decode_exactly(size, channels):
    """Average and Paeth rows amid the others, with vectorised rows before
    and after the block, on blocks taller and wider than they are long."""
    img = _frame(*size, channels, seed=size[0])
    filters = np.random.default_rng(size[1]).integers(0, 5, size[0]).tolist()
    filters[0], filters[-1] = 1, 2
    data = _encode(img, filters)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_imdecode_matches_cv2_on_adaptively_filtered_frames(mode, tmp_path):
    """Pillow picks each row's filter adaptively, Average and Paeth among
    them: the decoder equals cv2 on what it writes."""
    image = pytest.importorskip("PIL.Image")
    img = _frame(64, 80, 3, seed=11)
    path = tmp_path / "frame.png"
    image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
    data = path.read_bytes()
    np.testing.assert_array_equal(
        png.imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


def test_unsupported_pngs_raise_naming_the_feature():
    rgba = np.zeros((4, 4, 4), np.uint8)
    ok, buf = cv2.imencode(".png", rgba)
    with pytest.raises(ValueError, match="RGB with alpha"):
        png.decode(buf.tobytes())
    ok, buf = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.decode(buf.tobytes())
    data = bytearray(_encode(np.zeros((4, 4, 1), np.uint8), [0]))
    data[-20] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"\xff\xd8\xff")
