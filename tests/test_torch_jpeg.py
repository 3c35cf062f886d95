"""The port's JPEG decoder (``sleap_tpu_torch.io.jpeg``), plain version,
against ``cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)`` (libjpeg-turbo): bitwise
(tolerance 0) on cv2-encoded gray and colour images of every supported
sampling, size class, quality, restart interval and Huffman-table kind, on
hypothesis-drawn sizes and qualities, on progressive files (cv2's and PIL's
scan scripts, restarts, scripts with scans left out that need no block
smoothing), and on the committed fixtures
(``scripts/make_torch_jpeg_fixtures.py``) against their recorded cv2
hashes; 4:4:0 and 4:1:1 sampling, RGB and CMYK/YCCK colour, and block
smoothing of incomplete progressive scripts too. Every feature still
refused (cv2 reads none of it) raises and names itself. The host entropy decoder
(``csrc/jpeg.cu``, built with the system C++ compiler) gives the plain
coefficients on baseline and progressive files. The card's route (host
entropy decoder, J1, J2) is held to the same hashes and to these plain
stages by ``chip_smoke.py`` phases 13b and 19a."""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu_torch.io import jpeg
from sleap_tpu_torch.ops import _build

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg"
RECORD = json.loads((FIXTURES / "decoded.json").read_text())
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
}


def _image(h, w, channels, seed):
    """Smooth shapes plus noise, colour channels that differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = 100 + 80 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
    img = base[..., None] + rng.integers(-30, 30, (h, w, channels))
    if channels == 3:
        img[..., 1] = 255 - img[..., 1]
        img[..., 2] = xx * 255 / max(w, 1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(img, params=()):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf


def _assert_like_cv2(buf):
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    got = jpeg.decode_plain(buf.tobytes())
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("size", [(72, 100), (29, 37), (8, 8), (17, 250), (50, 3), (9, 1)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", ["gray", "444", "422", "420"])
def test_plain_decoder_equals_cv2(kind, size, quality):
    """Widths of 1-4 leave a chroma plane 1-2 samples wide, which
    libjpeg-turbo replicates instead of upsampling fancily."""
    if kind == "gray":
        buf = _encode(_image(*size, 1, quality)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, quality])
    else:
        buf = _encode(_image(*size, 3, quality), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]])
    _assert_like_cv2(buf)


@pytest.mark.parametrize("interval", [1, 3, 7])
@pytest.mark.parametrize("channels", [1, 3])
def test_restart_intervals_equal_cv2(channels, interval):
    img = _image(40, 70, channels, interval)
    _assert_like_cv2(_encode(img if channels == 3 else img[..., 0],
                             [cv2.IMWRITE_JPEG_RST_INTERVAL, interval]))


@pytest.mark.parametrize("kind", ["gray", "444", "420"])
def test_optimised_huffman_tables_equal_cv2(kind):
    img = _image(33, 65, 1 if kind == "gray" else 3, 5)
    params = [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 85]
    if kind != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    _assert_like_cv2(_encode(img[..., 0] if kind == "gray" else img, params))


def test_saturated_and_flat_images_equal_cv2():
    """Edges of the range: the IDCT's clamp, and blocks of DC alone."""
    rng = np.random.default_rng(3)
    checker = (np.indices((48, 48)).sum(0) % 2 * 255).astype(np.uint8)
    for img in (checker, np.zeros((16, 24), np.uint8), np.full((9, 9, 3), 255, np.uint8),
                rng.choice([0, 255], (32, 40, 3)).astype(np.uint8)):
        _assert_like_cv2(_encode(img, [cv2.IMWRITE_JPEG_QUALITY, 100]))


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), quality=st.integers(1, 100),
       kind=st.sampled_from(["gray", "444", "422", "420"]), seed=st.integers(0, 2**16))
def test_drawn_sizes_and_qualities_equal_cv2(h, w, quality, kind, seed):
    if kind == "gray":
        buf = _encode(_image(h, w, 1, seed)[..., 0], [cv2.IMWRITE_JPEG_QUALITY, quality])
    else:
        buf = _encode(_image(h, w, 3, seed), [cv2.IMWRITE_JPEG_QUALITY, quality,
                                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]])
    _assert_like_cv2(buf)


@pytest.mark.parametrize("name", sorted(RECORD["stills"]))
def test_committed_stills_decode_to_recorded_cv2_frames(name):
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    want = RECORD["stills"][name]
    if "refused" in want:
        with pytest.raises(jpeg.UnsupportedJpeg, match=want["refused"]):
            jpeg.decode_plain(data)
        return
    img = jpeg.decode_plain(data)
    assert list(img.shape) == want["shape"]
    assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
    np.testing.assert_array_equal(img, cv2.imdecode(np.frombuffer(data, np.uint8),
                                                    cv2.IMREAD_UNCHANGED))


def _without_dht(data: bytes) -> bytes:
    """``data`` with its DHT segments cut out, as Motion-JPEG frames come."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


BASELINE_STANDARD_TABLES = sorted(
    n for n in RECORD["stills"] if "refused" not in RECORD["stills"][n]
    and "progressive" not in n and "optimized" not in n and not n.startswith("pil_"))


@pytest.mark.parametrize("name", BASELINE_STANDARD_TABLES)
def test_streams_without_dht_take_the_standard_tables(name, host_library, monkeypatch):
    """A JPEG without DHT decodes as libjpeg-turbo decodes it (its
    ``jinit_huff_decoder`` installs the Annex K.3 tables): on the committed
    baseline stills of every sampling, cut of their DHT segments, the plain
    route equals ``cv2.imdecode`` of the cut file and of the whole one, and
    the card route's host entropy decoder gives the plain coefficients."""
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    cut = _without_dht(data)
    assert b"\xff\xc4" not in cut[:cut.index(b"\xff\xda")] and len(cut) < len(data)
    want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want, cv2.imdecode(np.frombuffer(data, np.uint8),
                                                     cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(jpeg.decode_plain(cut), want)
    monkeypatch.setattr(_build, "entry", host_library)
    header = jpeg.parse(cut)
    np.testing.assert_array_equal(jpeg.coefficients_host(cut, header).numpy(),
                                  jpeg.coefficients_plain(cut, header))


def _segments(buf):
    """(marker, start of segment) of each marker segment before the scan."""
    data, pos, out = bytes(buf), 2, []
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        out.append((data[pos + 1], pos))
        pos += 2 + length
    return data, out


def _with_sof(buf, marker=None, precision=None):
    data, segs = _segments(buf)
    pos = next(p for m, p in segs if m in (0xC0, 0xC1, 0xC2))
    out = bytearray(data)
    if marker is not None:
        out[pos + 1] = marker
    if precision is not None:
        out[pos + 4] = precision
    return bytes(out)


def _with_app14(buf, transform):
    data = bytes(buf)
    body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) + body + data[2:]


def _without_jfif(buf):
    data = bytes(buf)
    assert data[2:4] == b"\xff\xe0"
    (length,) = struct.unpack_from(">H", data, 4)
    return data[:2] + data[4 + length:]


def _pil_cmyk(img):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG")
    return buf.getvalue()


def _with_ids(buf, ids):
    data, segs = _segments(buf)
    pos = next(p for m, p in segs if m in (0xC0, 0xC1))
    out = bytearray(data)
    for i, ident in enumerate(ids):
        out[pos + 10 + 3 * i] = ident
    # The scan header names components by id too.
    sos = data.index(b"\xff\xda")
    for i, ident in enumerate(ids):
        out[sos + 5 + 2 * i] = ident
    return bytes(out)


def _formerly_refused():
    """Streams the port refused before it read every JPEG cv2 reads."""
    colour = _encode(_image(16, 16, 3, 0))
    progressive = _encode(_image(16, 16, 3, 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    return {
        "block smoothing": _truncated(progressive, 3),
        "Adobe's RGB transform": _with_app14(_without_jfif(colour), 0),
        "RGB component ids": _with_ids(_without_jfif(colour), [82, 71, 66]),
        "4:1:1": _encode(_image(16, 40, 3, 0), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
        "4:4:0": _encode(_image(40, 16, 3, 0), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
        "CMYK": _pil_cmyk(_image(16, 24, 4, 1)),
    }


@pytest.mark.parametrize("feature", ("4:1:1", "4:4:0", "Adobe's RGB transform", "CMYK", "RGB component ids", "block smoothing"))
def test_formerly_refused_streams_equal_cv2(feature):
    _assert_like_cv2(np.frombuffer(bytes(_formerly_refused()[feature]), np.uint8))


def test_refused_features_raise_naming_themselves():
    """What cv2 gives no frame for stays refused, naming the feature (the
    "arithmetic" streams are Huffman data under a patched SOF: no real
    arithmetic-coded file is written here to hold cv2 to); the streams this
    test once held that cv2 reads are test_formerly_refused_streams_equal_cv2's."""
    colour = _encode(_image(16, 16, 3, 0))
    gray = _encode(_image(16, 16, 1, 0)[..., 0])
    progressive = _encode(_image(16, 16, 3, 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    cases = [
        (_with_sof(progressive, marker=0xCA), r"arithmetic-coded progressive JPEG \(SOF10\)"),
        (_with_sof(colour, marker=0xC9), "arithmetic-coded"),
        (_with_sof(colour, marker=0xC3), "lossless"),
        (_with_sof(gray, marker=0xC5), "differential"),
        (_with_sof(gray, precision=12), "12-bit"),
    ]
    for data, feature in cases[2:]:
        assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None
    for data, feature in cases:
        with pytest.raises(jpeg.UnsupportedJpeg, match=feature):
            jpeg.decode_plain(bytes(data))
    with pytest.raises(ValueError, match="SOI"):
        jpeg.decode_plain(b"\x89PNG\r\n")
    big = _encode(_image(64, 96, 3, 0))
    with pytest.raises(ValueError, match="ends before"):
        jpeg.decode_plain(bytes(big)[: len(big) - 200])


def test_adobe_ycbcr_transform_is_decoded():
    """An APP14 marker with transform 1 (YCbCr) changes nothing."""
    buf = _encode(_image(24, 24, 3, 2))
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(jpeg.decode_plain(_with_app14(buf, 1)), want)


def test_plain_stages_match_their_definitions():
    """The PyTorch stages on crafted inputs: a DC-only block is flat at
    DC * q / 8 + 128 (islow's scaling), and the colour stage maps neutral
    chroma to gray and clamps."""
    header = jpeg.parse(_encode(np.zeros((8, 8), np.uint8)).tobytes())
    coefs = torch.zeros((1, 64), dtype=torch.int16)
    coefs[0, 0] = 40
    quant = torch.full((1, 64), 2, dtype=torch.int32)
    samples = jpeg.idct_plain(coefs, quant, torch.zeros(1, dtype=torch.int64))
    assert torch.equal(samples, torch.full((1, 8, 8), 138, dtype=torch.uint8))
    coefs[0, 0] = 1000  # far past white: the clamp
    assert int(jpeg.idct_plain(coefs, quant, torch.zeros(1, dtype=torch.int64)).min()) == 255
    assert header.blocks == 1 and jpeg.planes_of(samples, header)[0].shape == (8, 8)


def test_card_wrappers_refuse_cpu_tensors():
    """J1 and J2 launch only on CUDA tensors; on the CPU the plain stages
    are the route."""
    header = jpeg.parse(_encode(_image(8, 8, 3, 1)).tobytes())
    with pytest.raises(ValueError, match="CUDA tensor"):
        jpeg.idct_cuda(torch.zeros((header.blocks, 64), dtype=torch.int16),
                       torch.ones((3, 64), dtype=torch.int32), header)
    with pytest.raises(ValueError, match="CUDA tensor"):
        jpeg.color_cuda(torch.zeros((header.blocks, 8, 8), dtype=torch.uint8), header)


def test_scan_geometry_of_the_samplings():
    """Blocks a frame needs: each component padded to whole MCUs, at its
    own offset, as libjpeg lays out its coefficient arrays."""
    for kind, blocks in (("444", 3 * 6 * 9), ("422", 6 * 10 + 2 * 6 * 5), ("420", 6 * 10 + 2 * 3 * 5)):
        buf = _encode(_image(41, 70, 3, 0), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]])
        header = jpeg.parse(buf.tobytes())
        assert header.blocks == blocks, kind
        assert [c.offset for c in header.components] == [
            0, header.components[0].blocks_w * header.components[0].blocks_h,
            header.blocks - header.components[2].blocks_w * header.components[2].blocks_h]


# --------------------------------------------------------------------------- #
# Progressive JPEG
# --------------------------------------------------------------------------- #


def _scan_starts(data: bytes):
    return [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]


def _truncated(data: bytes, scans: int) -> bytes:
    """``data`` cut before its ``scans``-th scan, with an EOI."""
    return data[:_scan_starts(data)[scans]] + b"\xff\xd9"


def _without_scans(data: bytes, drop) -> bytes:
    """``data`` with the scans numbered in ``drop`` taken out (their
    headers and entropy-coded data; the tables between scans stay)."""
    out, last = b"", 0
    for k, at in enumerate(_scan_starts(data)):
        if k in drop:
            (length,) = struct.unpack_from(">H", data, at + 2)
            out += data[last:at]
            last = jpeg._segment_end(data, at + 2 + length)
    return out + data[last:]


def _pil_progressive(img, quality, subsampling) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img[..., ::-1] if img.ndim == 3 else img).save(
        buf, "JPEG", progressive=True, optimize=True, quality=quality, subsampling=subsampling)
    return buf.getvalue()


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("size", [(72, 100), (29, 37), (50, 3), (8, 8), (1, 1)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("kind", ["gray", "444", "422", "420"])
def test_progressive_cv2_files_equal_cv2(kind, size, restart):
    """libjpeg's simple progression (spectral selection and successive
    approximation, DC scans interleaved, tables optimised per scan)."""
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if kind == "gray":
        buf = _encode(_image(*size, 1, restart)[..., 0], params)
    else:
        buf = _encode(_image(*size, 3, restart), params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]])
    assert jpeg.parse(buf.tobytes()).progressive
    _assert_like_cv2(buf)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", [(72, 100), (29, 37), (50, 3)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_progressive_pil_files_equal_cv2(size, subsampling):
    """PIL's ``progressive=True, optimize=True``: its own scan script and
    tables (4:4:4, 4:2:2, 4:2:0; gray too)."""
    for img, quality in ((_image(*size, 3, subsampling), 85), (_image(*size, 1, 7)[..., 0], 60)):
        _assert_like_cv2(np.frombuffer(_pil_progressive(img, quality, subsampling), np.uint8))


@settings(max_examples=20, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       kind=st.sampled_from(["gray", "444", "422", "420"]), restart=st.integers(0, 4),
       seed=st.integers(0, 2**16))
def test_drawn_progressive_files_equal_cv2(h, w, quality, kind, restart, seed):
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if kind == "gray":
        buf = _encode(_image(h, w, 1, seed)[..., 0], params)
    else:
        buf = _encode(_image(h, w, 3, seed), params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]])
    _assert_like_cv2(buf)


def test_progressive_scripts_that_need_no_smoothing_equal_cv2():
    """Scans left out of a script, where libjpeg-turbo's ``smoothing_ok``
    still says no: a DC refinement (the AC bands stay at full precision),
    or every DC scan (no DC at all turns smoothing off)."""
    gray = _encode(_image(72, 100, 1, 3)[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    colour = _encode(_image(72, 100, 3, 4), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    kinds = {k: [s.kind for s in jpeg.parse(d).scans] for k, d in (("gray", gray), ("colour", colour))}
    for name, data in (("gray", gray), ("colour", colour)):
        dc_refine = [i for i, kind in enumerate(kinds[name]) if kind == "dc_refine"]
        dc_first = [i for i, kind in enumerate(kinds[name]) if kind == "dc_first"]
        for drop in (dc_refine, dc_first):
            _assert_like_cv2(np.frombuffer(_without_scans(data, drop), np.uint8))


@pytest.mark.parametrize("scans", [1, 2, 4, 6])
def test_incomplete_progressive_scripts_raise_naming_block_smoothing(scans):
    """A file cut after its first scans: libjpeg-turbo smooths the blocks,
    and the port, which once refused such files naming block smoothing,
    smooths them as it does (``smooth_plain``): cv2's frame, bitwise."""
    data = _encode(_image(72, 100, 3, 5), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    cut = _truncated(data, scans)
    assert jpeg.parse(cut).smooth
    _assert_like_cv2(np.frombuffer(cut, np.uint8))


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       kind=st.sampled_from(["gray", "444", "422", "420", "411", "440"]), cut=st.integers(1, 9),
       seed=st.integers(0, 2**16))
def test_drawn_truncated_progressive_files_equal_cv2(h, w, quality, kind, cut, seed):
    """Block smoothing over drawn sizes, samplings, qualities and cut points
    (with DC interpolation where a component has no AC data yet)."""
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality]
    if kind == "gray":
        buf = _encode(_image(h, w, 1, seed)[..., 0], params).tobytes()
    else:
        flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{kind}")
        buf = _encode(_image(h, w, 3, seed), params + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]).tobytes()
    scans = len(_scan_starts(buf))
    _assert_like_cv2(np.frombuffer(_truncated(buf, cut % scans) if cut % scans else buf, np.uint8))


@pytest.mark.parametrize("hv", [0x12, 0x22, 0x13, 0x14, 0x21])
@pytest.mark.parametrize("size", [(37, 29), (29, 37), (72, 100), (41, 9)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_smoothing_of_a_lone_component_that_declares_its_sampling_equals_cv2(size, hv):
    """A gray file cut after its first scans whose frame header declares
    sampling ``hv``: libjpeg keeps ``v`` block rows an iMCU row, which
    smoothing's edge tests count, and reads the zeroed row past the last
    where the last iMCU row is short."""
    data = _encode(_image(*size, 1, hv)[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
    for scans in (1, 2):
        cut = bytearray(_truncated(data, scans))
        cut[cut.index(b"\xff\xc2") + 11] = hv
        assert jpeg.parse(bytes(cut)).smooth
        _assert_like_cv2(np.frombuffer(bytes(cut), np.uint8))


def test_invalid_progressive_parameters_raise():
    """``jdphuff.c``'s fatal checks: an AC scan of two components, a DC
    band past coefficient 0, a refinement whose Al is not Ah - 1."""
    data = bytearray(_encode(_image(16, 16, 3, 6), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes())
    header = jpeg.parse(bytes(data))
    refine = next(s for s in header.scans if s.kind == "ac_refine")
    at = refine.start - 1  # the scan header's Ah/Al byte
    data[at] = 0x20  # Ah 2, Al 0
    with pytest.raises(ValueError, match="progressive scan parameters"):
        jpeg.parse(bytes(data))


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/jpeg.cu``'s host C built with the system C++ compiler, bound
    as the kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host entropy decoder")
    lib = tmp_path_factory.mktemp("host") / "libjpeghost.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(Path(_build.CSRC) / "jpeg.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))

    def entry(name):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    return entry


@pytest.mark.parametrize("name", sorted(n for n in RECORD["stills"] if "refused" not in RECORD["stills"][n]
                                        and not n.endswith("1024")
                                        and not n.endswith("1024_progressive")))
def test_host_entropy_decoder_equals_the_plain_one(name, host_library, monkeypatch):
    """On every small committed still, baseline and progressive: the same
    coefficients as the plain decoder."""
    monkeypatch.setattr(_build, "entry", host_library)
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    header = jpeg.parse(data)
    np.testing.assert_array_equal(jpeg.coefficients_host(data, header).numpy(),
                                  jpeg.coefficients_plain(data, header))


def test_host_entropy_decoder_equals_the_plain_one_on_pil_scripts(host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    for subsampling in (0, 2):
        data = _pil_progressive(_image(41, 70, 3, subsampling), 80, subsampling)
        header = jpeg.parse(data)
        np.testing.assert_array_equal(jpeg.coefficients_host(data, header).numpy(),
                                      jpeg.coefficients_plain(data, header))
    with pytest.raises(ValueError, match="malformed"):
        data = _encode(_image(64, 96, 3, 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]).tobytes()
        cut = data[:_scan_starts(data)[4] - 60] + data[_scan_starts(data)[4]:]
        jpeg.coefficients_host(cut, jpeg.parse(cut))
