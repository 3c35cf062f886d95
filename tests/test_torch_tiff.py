"""The port's TIFF codec (``sleap_tpu_torch.io.tiff``) against cv2 (OpenCV 5
on libtiff 4.7): encodes byte for byte ``cv2.imencode(".tif", img)``'s
bytes for 1x1, odd and 3 x 1024 frames of uint8, uint16 and float32 with
1, 3 and 4 channels (and hypothesis-drawn ones), with LZW's table resets
and compression-ratio checkpoints; decodes cv2's, PIL's and hand-built
files (tiles, planar-separate samples, both byte orders, every predictor
and compression) to ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)``'s array,
dtype included; the committed fixtures
(``scripts/make_torch_still_fixtures.py``) to their recorded cv2 hashes;
the host C codecs (``csrc/tiff.cu``, built with the system C++ compiler as
the kernel library binds it) equal the plain LZW and PackBits both ways;
the layouts once refused decode to cv2's array, and every feature still
refused (cv2 gives no frame for it) raises naming itself. The card's route is held
to the same records by ``chip_smoke.py`` phase 19."""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu_torch.io import tiff
from sleap_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "stills"
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_still_fixtures as fixtures  # noqa: E402

DECODED = json.loads((FIXTURES / "decoded.json").read_text())["stills"]
ENCODED = json.loads((FIXTURES / "encoded.json").read_text())["frames"]
DTYPES = (np.uint8, np.uint16, np.float32)


def _frame(h, w, channels, dtype, seed):
    """Smooth content with some noise, each channel its own."""
    rng = np.random.default_rng(seed)
    img = fixtures.smooth(h, w, channels, seed, np.float32)
    img = img + rng.normal(0, 0.03, img.shape).astype(np.float32)
    if dtype == np.float32:
        return img
    top = np.iinfo(dtype).max
    return np.clip(np.rint(img * top), 0, top).astype(dtype)


def _cv2_encode(img) -> bytes:
    ok, buf = cv2.imencode(".tif", img)
    assert ok
    return buf.tobytes()


def _cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def _assert_like_cv2(data: bytes, device="cpu"):
    want = _cv2_decode(data)
    got = tiff.imdecode(data, device)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("size", [(1, 1), (7, 33), (3, 1024), (29, 37)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_encode_equals_cv2(size, dtype, channels):
    img = _frame(*size, channels, dtype, seed=size[1] + channels)
    if channels == 1:
        img = img[..., 0]
    data = tiff.imencode(img, "cpu")
    assert data == _cv2_encode(img)
    np.testing.assert_array_equal(tiff.imdecode(data, "cpu"), img)


def test_encode_resets_its_table_as_libtiff_does():
    """Noise fills the LZW table (a clear code at 4094 entries); strips of
    more than 10000 bytes pass compression-ratio checkpoints, where runs
    and noise in turn make the ratio fall (a clear code) or rise."""
    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (40, 1024), np.uint8)
    wide = np.concatenate([rng.integers(0, 4, (2, 9000)), np.zeros((2, 9000), np.int64),
                           rng.integers(0, 256, (2, 9000))], 1).astype(np.uint8)
    gradient = (np.arange(3 * 7000) % 251).astype(np.uint16).reshape(1, -1).repeat(2, 0)
    for img in (noisy, wide, gradient, np.dstack([wide[:, :5000]] * 3), noisy.astype(np.uint16) * 257):
        assert tiff.imencode(img, "cpu") == _cv2_encode(img)


def test_hxwx1_frames_are_written_as_gray():
    img = _frame(5, 9, 1, np.uint8, 3)
    assert tiff.imencode(img, "cpu") == _cv2_encode(img[..., 0]) == _cv2_encode(img)


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 300), channels=st.sampled_from([1, 3, 4]),
       dtype=st.sampled_from(DTYPES), noise=st.booleans(), seed=st.integers(0, 2**16))
def test_drawn_frames_encode_and_decode_like_cv2(h, w, channels, dtype, noise, seed):
    img = _frame(h, w, channels, dtype, seed)
    if noise and dtype != np.float32:
        img = np.random.default_rng(seed).integers(0, np.iinfo(dtype).max, img.shape).astype(dtype)
    if channels == 1:
        img = img[..., 0]
    data = _cv2_encode(img)
    assert tiff.imencode(img, "cpu") == data
    _assert_like_cv2(data)


def _pil(img, mode, compression, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "TIFF", compression=compression, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                         "packbits"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_decode_of_pil_files_equals_cv2(mode, compression):
    """PIL (libtiff) writes strips of its own size, RGBA with unassociated
    alpha (which cv2's RGBA reader premultiplies) and every compression."""
    rgb = _frame(23, 41, 3, np.uint8, 5)
    rgba = np.concatenate([rgb, _frame(23, 41, 1, np.uint8, 6)], -1)
    _assert_like_cv2(_pil(rgba if mode == "RGBA" else rgb, mode, compression))


def test_decode_of_pil_16_bit_float_and_multipage_files_equals_cv2():
    from PIL import Image

    for img, kw in ((_frame(23, 41, 1, np.uint16, 7)[..., 0], {"compression": "tiff_lzw"}),
                    (_frame(23, 41, 1, np.float32, 8)[..., 0], {})):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "TIFF", **kw)
        _assert_like_cv2(buf.getvalue())
    pages = [Image.fromarray(_frame(9, 11, 3, np.uint8, 9 + i)) for i in range(3)]
    buf = io.BytesIO()
    pages[0].save(buf, "TIFF", save_all=True, append_images=pages[1:])
    _assert_like_cv2(buf.getvalue())  # page 0, as cv2.imread


LAYOUTS = {
    "strips of 4, big-endian": dict(order=">", rows=4),
    "deflate": dict(compression=8),
    "deflate, predictor 2": dict(compression=8, predictor=2),
    "deflate, predictor 2, big-endian": dict(order=">", compression=8, predictor=2, rows=5),
    "tiles 16x16, deflate": dict(compression=8, tile=(16, 16)),
    "tiles 32x16, predictor 2, big-endian": dict(order=">", compression=8, predictor=2, tile=(32, 16)),
    "planar, strips of 3": dict(planar=2, rows=3, compression=8),
    "planar tiles": dict(planar=2, tile=(16, 16), compression=8),
}


# cv2 returns unset memory for separate planes wider than 8 bits: the port
# refuses them (test_refused_features_raise_naming_themselves).
HAND_BUILT = [(np.dtype(d).name, c, layout) for d in DTYPES for c in (1, 3, 4) for layout in sorted(LAYOUTS)
              if not (LAYOUTS[layout].get("planar") == 2 and c > 1 and d != np.uint8)]


@pytest.mark.parametrize("dtype,channels,layout", HAND_BUILT)
def test_decode_of_hand_built_layouts_equals_cv2(dtype, channels, layout):
    kw = LAYOUTS[layout]
    img = _frame(29, 37, channels, np.dtype(dtype).type, channels)
    _assert_like_cv2(fixtures.tiff_bytes(img, **kw))


def test_decode_of_the_floating_point_predictor_equals_cv2():
    for channels in (1, 3):
        for order in ("<", ">"):
            img = _frame(17, 23, channels, np.float32, channels)
            _assert_like_cv2(fixtures.tiff_bytes(img, order=order, compression=8, predictor=3, rows=6))


@pytest.mark.parametrize("name", sorted(n for n in DECODED if n.endswith(".tif")))
def test_committed_stills_decode_to_recorded_cv2_frames(name):
    data = (FIXTURES / name).read_bytes()
    want = DECODED[name]
    if "refused" in want:
        with pytest.raises(tiff.UnsupportedTiff, match=want["refused"]):
            tiff.imdecode(data, "cpu")
        return
    img = tiff.imdecode(data, "cpu")
    assert [list(img.shape), str(img.dtype)] == [want["shape"], want["dtype"]]
    assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(img, _cv2_decode(data))


@pytest.mark.parametrize("name", sorted(n for n in ENCODED if n.endswith(".tif")))
def test_committed_write_cases_encode_to_recorded_cv2_bytes(name):
    base = name[:-len(".tif")]
    img = tiff.imdecode((FIXTURES / base.split("_crop_")[0]).read_bytes(), "cpu") \
        if base.split("_crop_")[0].endswith(".tif") else None
    if img is None:  # a BMP fixture's frame
        from sleap_tpu_torch.io import bmp

        img = bmp.imdecode((FIXTURES / base.split("_crop_")[0]).read_bytes())
    if "_crop_" in base:
        w, h = (int(v) for v in base.split("_crop_")[1].split("x"))
        img = np.ascontiguousarray(img[1:1 + h, 1:1 + w])
    data = tiff.imencode(img, "cpu")
    assert len(data) == ENCODED[name]["bytes"]
    assert hashlib.sha256(data).hexdigest() == ENCODED[name]["sha256"]


def _formerly_refused():
    """Layouts the port refused before it read every still cv2 reads."""
    gray = _frame(9, 13, 1, np.uint8, 1)
    rgb = _frame(9, 13, 3, np.uint8, 2)
    return {
        "JPEG-in-TIFF": _pil(rgb, "RGB", "jpeg"),
        "CCITT": _pil(rgb, "1", "group4"),
        "bilevel": _pil(rgb, "1", "raw"),
        "palette": _pil(rgb, "P", "raw"),
        "YCbCr": _pil(rgb, "YCbCr", "raw"),
        "CMYK": _pil(rgb, "CMYK", "raw"),
        "min-is-white": fixtures.tiff_bytes(gray, photometric=0),
        "signed 16": fixtures.tiff_bytes(gray.astype(np.int16)),
        "signed 32": fixtures.tiff_bytes(gray.astype(np.int32)),
        "32-bit integer": fixtures.tiff_bytes(gray.astype(np.uint32)),
        "64-bit": fixtures.tiff_bytes(gray.astype(np.float64)),
        "orientation": fixtures.tiff_bytes(gray, orientation=3),
    }


@pytest.mark.parametrize("feature", ("32-bit integer", "64-bit", "CCITT", "CMYK", "JPEG-in-TIFF", "YCbCr", "bilevel", "min-is-white", "orientation", "palette", "signed 16", "signed 32"))
def test_formerly_refused_layouts_equal_cv2(feature):
    _assert_like_cv2(_formerly_refused()[feature])


def test_refused_features_raise_naming_themselves():
    """What cv2 gives no frame for (None, or unset memory that differs read
    to read) stays refused, naming the feature; the layouts this test once
    held that cv2 reads are test_formerly_refused_layouts_equal_cv2's."""
    gray = _frame(9, 13, 1, np.uint8, 1)
    rgb = _frame(9, 13, 3, np.uint8, 2)
    cases = [
        (b"II+\0\x08\0\0\0" + bytes(16), "BigTIFF"),
        (fixtures.tiff_bytes(rgb.astype(np.uint16), planar=2), "planar-separate"),
        (fixtures.tiff_bytes(np.dstack([gray, gray])), "2 samples"),
        (fixtures.tiff_bytes(gray // 16, bits=4), "4-bit"),
        (fixtures.tiff_bytes(gray // 64, bits=2), "2-bit"),
        (fixtures.tiff_bytes(gray, tile=(16, 16)), "uncompressed tiles"),
        (fixtures.tiff_bytes(gray.astype(np.float16)), "16-bit floating-point"),
        (fixtures.tiff_bytes(gray.astype(np.uint16), photometric=3,
                             colormap=np.zeros((3, 65536), np.uint16)), "16-bit"),
        (fixtures.tiff_bytes(np.dstack([gray] * 4).astype(np.uint16), photometric=5), "16-bit"),
        (fixtures.tiff_bytes(np.dstack([gray] * 3), photometric=6, subsampling=(1, 4), rows=4),
         "subsampling"),
    ]
    for data, feature in cases:
        assert feature == "planar-separate" or _cv2_decode(data) is None  # planar: unset memory
        with pytest.raises(tiff.UnsupportedTiff, match=feature):
            tiff.imdecode(data, "cpu")
    with pytest.raises(tiff.UnsupportedTiff, match="old-style"):
        tiff.lzw_decode_plain(b"\x00\x01\x02", 4)
    with pytest.raises(ValueError, match="Not a TIFF"):
        tiff.imdecode(b"\x89PNG\r\n\x1a\n", "cpu")
    with pytest.raises(ValueError, match="LZW data ends"):
        tiff.lzw_decode_plain(tiff.lzw_encode_plain(bytes(range(200)))[:20], 200)
    for bad in (np.zeros((4, 4), np.int16), np.zeros((4, 4, 2), np.uint8), np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError, match="TIFF frames"):
            tiff.imencode(bad, "cpu")


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/tiff.cu`` built with the system C++ compiler, bound as the
    kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host TIFF codecs")
    lib = tmp_path_factory.mktemp("host") / "libtiffhost.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(Path(_build.CSRC) / "tiff.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))

    def entry(name):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    return entry


def _streams():
    rng = np.random.default_rng(4)
    img = _frame(64, 300, 1, np.uint8, 4).tobytes()
    return [b"", b"a", b"aab", bytes(40000), rng.integers(0, 256, 70000, np.uint8).tobytes(),
            rng.integers(0, 3, 30000, np.uint8).tobytes(), img,
            np.repeat(rng.integers(0, 256, 3000, np.uint8), rng.integers(1, 6, 3000)).tobytes()]


def test_host_codecs_equal_the_plain_ones_both_ways(host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    for data in _streams():
        lzw = tiff.lzw_encode_plain(data)
        assert tiff.lzw_encode_host(data) == lzw
        assert tiff.lzw_decode_host(lzw, len(data)) == tiff.lzw_decode_plain(lzw, len(data)) == data
        packed = tiff.packbits_encode_plain(data)
        assert tiff.packbits_encode_host(data) == packed
        assert tiff.packbits_decode_host(packed, len(data)) == data
        assert tiff.packbits_decode_plain(packed, len(data)) == data
        assert len(packed) <= len(data) + len(data) // 128 + 1
    # A stream longer than asked for is cut; a shorter one raises on both.
    lzw = tiff.lzw_encode_plain(bytes(range(100)))
    assert tiff.lzw_decode_host(lzw, 40) == tiff.lzw_decode_plain(lzw, 40) == bytes(range(40))
    for decode in (tiff.lzw_decode_host, tiff.lzw_decode_plain):
        with pytest.raises(ValueError, match="ends after 100 of 120"):
            decode(lzw, 120)
    for decode in (tiff.packbits_decode_host, tiff.packbits_decode_plain):
        with pytest.raises(ValueError, match="ends after"):
            decode(b"\x02ab", 3)


def test_card_route_equals_cv2_through_the_host_codecs(host_library, monkeypatch):
    """``device="cuda"`` codes LZW and PackBits in host C: the same bytes
    and frames as the CPU route's and cv2's."""
    monkeypatch.setattr(_build, "entry", host_library)
    for dtype in DTYPES:
        img = _frame(40, 70, 3, dtype, 11)
        assert tiff.imencode(img, "cuda") == _cv2_encode(img)
        _assert_like_cv2(_cv2_encode(img), "cuda")
    rgb = _frame(23, 41, 3, np.uint8, 12)
    for compression in ("tiff_lzw", "packbits"):
        _assert_like_cv2(_pil(rgb, "RGB", compression), "cuda")
    with pytest.raises(tiff.UnsupportedTiff, match="old-style"):
        tiff.lzw_decode_host(b"\x00\x01\x02", 4)
