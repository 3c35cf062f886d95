"""The port's BMP codec (``sleap_tpu_torch.io.bmp``) against cv2 (OpenCV
5's ``grfmt_bmp.cpp``): encodes byte for byte ``cv2.imencode(".bmp",
img)``'s bytes for 1x1, odd and 3 x 1024 frames of uint8, and of uint16 and
float32 brought to 8 bits as cv2 brings them, with 1, 3 and 4 channels (and
hypothesis-drawn ones); decodes cv2's, PIL's and hand-built files (1-, 4-
and 8-bit palettes, gray and colour, 16-bit 5-5-5 and 5-6-5, 24- and 32-bit,
BITMAPINFOHEADER, V4 and V5 headers, RLE8 and RLE4 with deltas and early
escapes, bottom-up and top-down rows) to ``cv2.imdecode(buf,
cv2.IMREAD_UNCHANGED)``'s array; the committed fixtures
(``scripts/make_torch_still_fixtures.py``) to their recorded cv2 hashes;
and every refused feature raises naming itself. BMP has one route (numpy on
the host), so ``device="cuda"`` gives the same bytes here."""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu_torch.io import bmp

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "stills"
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_still_fixtures as fixtures  # noqa: E402

DECODED = json.loads((FIXTURES / "decoded.json").read_text())["stills"]
ENCODED = json.loads((FIXTURES / "encoded.json").read_text())["frames"]
GRAY_PALETTE = np.stack([np.arange(256)] * 3 + [np.zeros(256)], 1).astype(np.uint8)
COLOUR_PALETTE = np.random.default_rng(7).integers(0, 256, (256, 4)).astype(np.uint8)


def _frame(h, w, channels, dtype, seed):
    rng = np.random.default_rng(seed)
    img = fixtures.smooth(h, w, channels, seed, np.float32)
    if dtype == np.float32:  # past both ends, and halves: cv2 clips and rounds half to even
        return (img * 300 - 20 + rng.choice([0, 0.5], img.shape)).astype(np.float32)
    top = 1000 if dtype == np.uint16 else 255
    return np.clip(np.rint(img * top + rng.normal(0, 8, img.shape)), 0, top).astype(dtype)


def _cv2_encode(img) -> bytes:
    ok, buf = cv2.imencode(".bmp", img)
    assert ok
    return buf.tobytes()


def _assert_like_cv2(data: bytes):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert want is not None
    got = bmp.imdecode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("size", [(1, 1), (7, 33), (3, 1024), (29, 37)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_encode_equals_cv2(size, dtype, channels):
    img = _frame(*size, channels, dtype, seed=size[1] + channels)
    if channels == 1:
        img = img[..., 0]
    data = bmp.imencode(img)
    assert data == _cv2_encode(img) == bmp.imencode(img, "cuda")
    if dtype == np.uint8:
        np.testing.assert_array_equal(bmp.imdecode(data), img)


def test_hxwx1_frames_are_written_as_gray():
    img = _frame(5, 9, 1, np.uint8, 3)
    assert bmp.imencode(img) == _cv2_encode(img[..., 0]) == _cv2_encode(img)


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 200), channels=st.sampled_from([1, 3, 4]),
       seed=st.integers(0, 2**16))
def test_drawn_frames_encode_and_decode_like_cv2(h, w, channels, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels)).astype(np.uint8)
    if channels == 1:
        img = img[..., 0]
    data = _cv2_encode(img)
    assert bmp.imencode(img) == data
    _assert_like_cv2(data)


def _pil(img, mode) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "BMP")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_decode_of_pil_files_equals_cv2(mode):
    rgb = _frame(23, 41, 3, np.uint8, 5)
    _assert_like_cv2(_pil(np.concatenate([rgb, rgb[..., :1]], -1) if mode == "RGBA" else rgb, mode))


def _palette(bits, gray):
    if not gray:
        return COLOUR_PALETTE[:1 << bits]
    return GRAY_PALETTE[np.linspace(0, 255, 1 << bits).astype(int)]


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (13, 33)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_decode_of_palette_files_equals_cv2(size, bits, gray, top_down):
    idx = np.random.default_rng(bits).integers(0, 1 << bits, size)
    _assert_like_cv2(fixtures.bmp_bytes(idx, bits, _palette(bits, gray), top_down=top_down))


def test_short_palettes_count_as_gray_past_their_end():
    """OpenCV reads ``clrused`` entries into a zeroed table and asks all
    2^bits of them: a gray palette of two is gray, a colour one colour."""
    idx = np.random.default_rng(0).integers(0, 2, (6, 9))
    for bits in (4, 8):
        for palette in (GRAY_PALETTE[[0, 200]], COLOUR_PALETTE[:2]):
            _assert_like_cv2(fixtures.bmp_bytes(idx, bits, palette))


@pytest.mark.parametrize("header", [40, 108, 124])
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (13, 33)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_decode_of_direct_colour_files_equals_cv2(size, header):
    rng = np.random.default_rng(size[1])
    words = rng.integers(0, 65536, size)
    bgr = rng.integers(0, 256, size + (3,))
    bgra = rng.integers(0, 256, size + (4,))
    _assert_like_cv2(fixtures.bmp_bytes(bgr, 24, header=header))
    _assert_like_cv2(fixtures.bmp_bytes(bgr, 24, header=header, top_down=True))
    _assert_like_cv2(fixtures.bmp_bytes(bgra, 32, header=header))
    _assert_like_cv2(fixtures.bmp_bytes(bgra, 32, compression=3, header=header,
                                        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    _assert_like_cv2(fixtures.bmp_bytes(words, 16, header=header))
    if header == 40:  # OpenCV reads 16-bit masks only after a 40-byte header
        for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            _assert_like_cv2(fixtures.bmp_bytes(words, 16, compression=3, masks=masks))


def _rle8(rows):
    """Coded RLE8 from (count, value) pairs and escapes: ("eol",),
    ("eob",), ("delta", dx, dy), ("abs", [indexes])."""
    out = bytearray()
    for op in rows:
        if op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "eob":
            out += b"\0\1"
        elif op[0] == "delta":
            out += bytes([0, 2, op[1], op[2]])
        elif op[0] == "abs":
            out += bytes([0, len(op[1])]) + bytes(op[1]) + bytes(len(op[1]) & 1)
        else:
            out += bytes(op)
    return bytes(out)


RLE8_CASES = {
    "runs and eol": [(3, 1), (4, 2), ("eol",), (7, 3), ("eol",), (2, 4), (5, 5), ("eol",), ("eob",)],
    "early eol and eob": [(2, 1), ("eol",), (3, 2), ("eob",)],
    "delta across rows": [(2, 1), ("delta", 3, 1), (2, 2), ("eol",), ("eob",)],
    "delta within a row": [(1, 1), ("delta", 4, 0), (2, 3), ("eol",), (7, 4), ("eob",)],
    "runs ending rows, no eol": [(7, 1), (7, 2), (7, 3), (7, 4)],
    "run ending a row, then eol": [(7, 1), ("eol",), (7, 2), ("eol",), ("eob",)],
    "absolute blocks": [("abs", [1, 2, 3]), (4, 4), ("eol",), ("abs", [5, 6, 7, 8, 9, 10, 11]),
                        ("eol",), ("eob",)],
    "absolute to the row's end, then eol": [("abs", [1, 2, 3, 4, 5, 6, 7]), ("eol",), (1, 9), ("eob",)],
}


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("case", sorted(RLE8_CASES))
def test_decode_of_rle8_equals_cv2(case, gray):
    """Skipped pixels, the rest of a row after an end-of-line and of the
    image after an end-of-bitmap take palette entry 0; a run that ends its
    row moves to the next, and an end-of-line right after it adds none."""
    palette = GRAY_PALETTE if gray else COLOUR_PALETTE
    data = fixtures.bmp_bytes(np.zeros((4, 7), np.uint8), 8, palette[:16], compression=1,
                              rle=_rle8(RLE8_CASES[case]))
    _assert_like_cv2(data)


RLE4_CASES = {
    "runs and eol": [(3, 0x12), (4, 0x34), ("eol",), (7, 0x56), ("eol",), (6, 0x78), ("eol",),
                     ("eob",)],
    "odd absolute": [("abs", [0x12, 0x30]), (4, 0x45), ("eol",), ("eob",)],
    "delta": [(1, 0x11), ("delta", 3, 1), (2, 0x22), ("eol",), ("eob",)],
    "delta down and across": [(4, 0x11), ("delta", 5, 2), (2, 0x22), ("eol",), ("eob",)],
    "run to the row's end, then eol": [(7, 0x9A), ("eol",), (7, 0xBC), ("eol",), ("eob",)],
}


@pytest.mark.parametrize("case", sorted(RLE4_CASES))
def test_decode_of_rle4_equals_cv2(case):
    """As RLE8, but a run may not carry on to the next row and a delta
    moves across columns only, wrapping at the row's end. The coded rows
    are followed by 16 zero bytes: OpenCV 5 fails an RLE4 file whose data
    end within about 12 bytes of its end-of-bitmap escape (its stream reads
    ahead); the port reads only what the escapes ask for."""
    ops = [("abs_count", op[1]) if op[0] == "abs" else op for op in RLE4_CASES[case]]
    out = bytearray()
    for op in ops:
        if op[0] == "abs_count":
            # RLE4 absolute: a count of indexes, two to a byte, padded to a word
            packed = bytes(op[1])
            n = 3 if case == "odd absolute" else 2 * len(packed)
            out += bytes([0, n]) + packed + bytes(len(packed) & 1)
        else:
            out += _rle8([op])
    data = fixtures.bmp_bytes(np.zeros((4, 7), np.uint8), 4, COLOUR_PALETTE[:16], compression=2,
                              rle=bytes(out) + bytes(16))
    _assert_like_cv2(data)


def test_rle_runs_past_their_row_are_refused_as_opencv_refuses_them():
    """OpenCV fails these files (``decode_rle8_bad``); the port raises."""
    for bits, compression in ((8, 1), (4, 2)):
        data = fixtures.bmp_bytes(np.zeros((2, 4), np.uint8), bits, COLOUR_PALETTE[:16],
                                  compression=compression, rle=_rle8([(3, 1), (3, 2), ("eob",)]))
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(ValueError, match="end of its line"):
            bmp.imdecode(data)


@pytest.mark.parametrize("name", sorted(n for n in DECODED if n.endswith(".bmp")))
def test_committed_stills_decode_to_recorded_cv2_frames(name):
    data = (FIXTURES / name).read_bytes()
    want = DECODED[name]
    if "refused" in want:
        with pytest.raises(bmp.UnsupportedBmp, match=want["refused"]):
            bmp.imdecode(data)
        return
    img = bmp.imdecode(data)
    assert [list(img.shape), str(img.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(img, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("name", sorted(n for n in ENCODED if n.endswith(".bmp")))
def test_committed_write_cases_encode_to_recorded_cv2_bytes(name):
    from sleap_tpu_torch.io import stills

    base = name[:-len(".bmp")]
    img = stills.imdecode((FIXTURES / base.split("_crop_")[0]).read_bytes(), "cpu")
    if "_crop_" in base:
        w, h = (int(v) for v in base.split("_crop_")[1].split("x"))
        img = np.ascontiguousarray(img[1:1 + h, 1:1 + w])
    data = bmp.imencode(img)
    assert len(data) == ENCODED[name]["bytes"]
    assert hashlib.sha256(data).hexdigest() == ENCODED[name]["sha256"]


def test_refused_features_raise_naming_themselves():
    rgb = _frame(5, 7, 3, np.uint8, 1)
    words = np.random.default_rng(2).integers(0, 65536, (5, 7))
    core = b"BM" + struct.pack("<IHHI", 38, 0, 0, 26) + struct.pack("<IHHHH", 12, 2, 2, 1, 24) + bytes(12)
    cases = [
        (core, "OS/2"),
        (fixtures.bmp_bytes(rgb, 24, compression=4), "JPEG"),
        (fixtures.bmp_bytes(rgb, 24, compression=5), "PNG"),
        (fixtures.bmp_bytes(words, 16, compression=3, masks=(0xF00, 0xF0, 0xF)), "bitfields"),
        (fixtures.bmp_bytes(words, 16, compression=3, header=124, masks=(0xF800, 0x7E0, 0x1F, 0)),
         "bitfields"),
        (fixtures.bmp_bytes(rgb, 24, compression=1), "24-bit BMPs of compression 1"),
    ]
    for data, feature in cases:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None
        with pytest.raises(bmp.UnsupportedBmp, match=feature):
            bmp.imdecode(data)
    with pytest.raises(ValueError, match="Not a BMP"):
        bmp.imdecode(b"\x89PNG\r\n\x1a\n" + bytes(30))
    with pytest.raises(ValueError, match="truncated"):
        bmp.imdecode(_cv2_encode(rgb)[:-10])
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros((0, 4), np.uint8), np.zeros((2, 2), bool)):
        with pytest.raises(ValueError, match="BMP frames"):
            bmp.imencode(bad)
