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


def _rows(img: np.ndarray, filters) -> bytes:
    """(H, W, C) uint8 ``img`` as PNG rows, row y filtered by
    ``filters[y % len(filters)]`` as the PNG specification defines it."""
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
    return raw


def _encode(img: np.ndarray, filters) -> bytes:
    """A PNG of (H, W, C) uint8 ``img`` whose row y uses filter
    ``filters[y % len(filters)]``, each applied as the PNG specification
    defines it."""
    h, w, c = img.shape
    return _crafted(w, h, {1: 0, 3: 2}[c], 8, _rows(img, filters))


def _crafted(w, h, color, depth, raw, interlace=0, extra=b""):
    """A PNG of IHDR fields and already filtered rows ``raw``."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", header) + extra + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


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
    mine = png.imdecode(buf.tobytes(), device="cpu")
    ref = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("channels", [1, 3])
def test_each_row_filter_decodes_exactly(filters, channels):
    img = _frame(21, 19, channels, seed=7)
    data = _encode(img, filters)
    np.testing.assert_array_equal(png.decode(data, device="cpu"), img)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(png.imdecode(data, device="cpu"), ref)


@pytest.mark.parametrize("size", [(40, 7), (7, 40), (1, 9), (9, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3])
def test_wavefront_blocks_decode_exactly(size, channels):
    """Average and Paeth rows amid the others, with vectorised rows before
    and after the block, on blocks taller and wider than they are long."""
    img = _frame(*size, channels, seed=size[0])
    filters = np.random.default_rng(size[1]).integers(0, 5, size[0]).tolist()
    filters[0], filters[-1] = 1, 2
    data = _encode(img, filters)
    np.testing.assert_array_equal(png.decode(data, device="cpu"), img)


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
        png.imdecode(data, device="cpu"), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


def test_unsupported_pngs_raise_naming_the_feature():
    for depth, color, name in ((4, 3, "4-bit palette"), (1, 0, "1-bit grayscale")):
        with pytest.raises(ValueError, match=name):
            png.decode(_crafted(8, 2, color, depth, b"\0\0\0\0" * 2), device="cpu")
    with pytest.raises(ValueError, match="Interlaced"):
        png.decode(_crafted(4, 4, 0, 8, b"\0" * 40, interlace=1), device="cpu")
    ok, buf = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.decode(buf.tobytes(), device="cpu")
    data = bytearray(_encode(np.zeros((4, 4, 1), np.uint8), [0]))
    data[-20] ^= 0xFF  # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data), device="cpu")
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"\xff\xd8\xff", device="cpu")


# --------------------------------------------------------------------------- #
# The encoder, and gray+alpha, RGBA and palette PNGs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(48, 64), (31, 17, 1), (31, 17, 3), (1, 1), (1, 40, 3),
                                   (40, 1)], ids=str)
def test_encoder_is_lossless_for_cv2_and_the_port(shape):
    img = _frame(shape[0], shape[1], shape[2] if len(shape) == 3 else 1, seed=3)
    img = img.reshape(shape) if len(shape) == 3 else img[..., 0]
    ok, buf = png.imencode(".png", img)
    assert ok and buf.dtype == np.uint8 and buf.shape[1] == 1
    want = img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img
    np.testing.assert_array_equal(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(png.imdecode(buf.tobytes(), device="cpu"), want)
    # encode writes the channels as given: R, G, B in the file.
    if img.ndim == 3 and img.shape[2] == 3:
        np.testing.assert_array_equal(png.decode(png.encode(img), device="cpu"), img)


@pytest.mark.parametrize("channels", [1, 3])
def test_encoder_sizes_are_cv2s_within_a_quarter(channels):
    """On frames as a camera gives them (blobs over noise, and a smooth
    gradient), the encoder's bytes are at most 1.25 times cv2's."""
    yy, xx = np.mgrid[:256, :320]
    smooth = (60 + 100 * (xx + yy) / 576)[..., None].repeat(channels, -1)
    for img in (_frame(256, 320, channels, seed=5), np.clip(smooth, 0, 255).astype(np.uint8)):
        img = img if channels == 3 else img[..., 0]
        mine = len(png.imencode(".png", img)[1])
        ref = len(cv2.imencode(".png", img)[1])
        assert mine <= 1.25 * ref, (mine, ref)


def test_encoder_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match="uint8"):
        png.encode(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        png.encode(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match=r"\.png"):
        png.imencode(".jpg", np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("filters", [[0], [1, 2, 3, 4]], ids=["none", "mixed"])
@pytest.mark.parametrize("color,channels", [(4, 2), (6, 4)], ids=["gray+alpha", "RGBA"])
def test_alpha_pngs_match_cv2(color, channels, filters):
    img = _frame(13, 11, channels, seed=color)
    data = _crafted(11, 13, color, 8, _rows(img, filters))
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    got = png.imdecode(data, device="cpu")
    assert got.shape == want.shape == (13, 11, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.decode(data, device="cpu"), img)


@pytest.mark.parametrize("trns", [None, bytes([10, 20, 0]), bytes(range(0, 250, 10))],
                         ids=["opaque", "short tRNS", "full tRNS"])
def test_palette_pngs_match_cv2(trns):
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 255, (25, 3), dtype=np.uint8)
    index = rng.integers(0, 25, (9, 14), dtype=np.uint8)
    raw = b"".join(b"\x02" + (row - (prev if k else 0)).astype(np.uint8).tobytes()
                   for k, (row, prev) in enumerate(zip(index.astype(np.int16),
                                                      np.vstack([index[:1], index[:-1]])
                                                      .astype(np.int16))))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    extra = chunk(b"PLTE", palette.tobytes()) + (chunk(b"tRNS", trns) if trns else b"")
    data = _crafted(14, 9, 3, 8, raw, extra=extra)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    got = png.imdecode(data, device="cpu")
    assert got.shape == want.shape == ((9, 14, 3) if trns is None else (9, 14, 4))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.decode(data, device="cpu")[..., :3], palette[index])


def test_gray_transparency_is_ignored_as_cv2_ignores_it():
    img = _frame(6, 7, 1, seed=2)
    raw = b"".join(b"\0" + row.tobytes() for row in img[..., 0])

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    data = _crafted(7, 6, 0, 8, raw, extra=chunk(b"tRNS", struct.pack(">H", int(img[0, 0, 0]))))
    np.testing.assert_array_equal(png.imdecode(data, device="cpu"),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))
