"""Every still cv2 reads, through both packages on the CPU (tolerance 0):

- each committed TIFF, BMP and JPEG fixture (``scripts/make_torch_still_fixtures.py``,
  ``scripts/make_torch_jpeg_fixtures.py``: orientations, signed and wide
  samples, min-is-white, palettes, bilevel and CCITT pages, YCbCr, CMYK,
  gray and alpha, JPEG-in-TIFF; 4:4:0 and 4:1:1 JPEGs, RGB, CMYK and YCCK
  JPEGs, progressive JPEGs that libjpeg-turbo smooths) read by the port's
  ``SingleImageVideo(..., device="cpu")`` gives the JAX package's
  ``SingleImageVideo`` frame (``cv2.imread``): dtype, shape and values;
- TIFFs drawn by hypothesis across orientation, sample type and channels
  decode to ``cv2.imdecode``'s frame, or are refused where cv2 returns
  nothing;
- the host CCITT decoder (``csrc/tiff.cu``, built with the system C++
  compiler as the kernel library binds it) equals the plain one on PIL's
  three CCITT compressions and on hand-built T.4 2-D and T.6 pages;
- J2's new colour modes and upsamplings (``color_plain``) and J6's plain
  version (``smooth_plain``) give hand-computed values.

The card's route is held to the same recorded frames by ``chip_smoke.py``
phase 22."""

from __future__ import annotations

import ctypes
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.io import jpeg, tiff
from sleap_tpu_torch.io import video as tvideo
from sleap_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "torch_data"
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_still_fixtures as fixtures  # noqa: E402

STILLS = json.loads((DATA / "stills" / "decoded.json").read_text())["stills"]
JPEGS = json.loads((DATA / "jpeg" / "decoded.json").read_text())["stills"]
READ = sorted([f"stills/{n}" for n, r in STILLS.items() if "refused" not in r]
              + [f"jpeg/{n}.jpg" for n in JPEGS])


@pytest.mark.parametrize("name", READ)
def test_single_image_video_matches_jax(name):
    """Orientations 5-8 of a frame that is not square: ``cv2.imread`` (the
    JAX package's reader) gives None where ``cv2.imdecode`` reads the file,
    and both packages raise the same KeyError."""
    path = str(DATA / name)
    if name.endswith(".tif") and tiff.transposed((DATA / name).read_bytes()):
        with pytest.raises(KeyError, match="Unable to read image"):
            jvideo.SingleImageVideo(filenames=[path]).get_frame(0)
        with pytest.raises(KeyError, match="Unable to read image"):
            tvideo.SingleImageVideo(filenames=[path], device="cpu").get_frame(0)
        return
    got = tvideo.SingleImageVideo(filenames=[path], device="cpu").get_frame(0)
    want = jvideo.SingleImageVideo(filenames=[path]).get_frame(0)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(n for n, r in STILLS.items() if "refused" in r))
def test_refused_stills_raise_where_cv2_reads_nothing(name):
    """The stills cv2 gives no frame for (None, or unset memory that differs
    read to read) stay refused on the port, naming their feature."""
    data = (DATA / "stills" / name).read_bytes()
    reads = [cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) for _ in range(3)]
    assert reads[0] is None or not all(np.array_equal(reads[0], r) for r in reads)
    with pytest.raises(ValueError, match=STILLS[name]["refused"]):
        tvideo.SingleImageVideo(filenames=[str(DATA / "stills" / name)], device="cpu").get_frame(0)


DTYPES = ("uint8", "int8", "uint16", "int16", "uint32", "int32", "float32", "float64")


@settings(max_examples=60, deadline=None)
@given(orientation=st.integers(1, 8), dtype=st.sampled_from(DTYPES), channels=st.integers(1, 4),
       photometric=st.sampled_from([None, 0, 1, 2]), predictor=st.sampled_from([1, 2]),
       h=st.integers(1, 12), w=st.integers(1, 12), seed=st.integers(0, 2**16))
def test_drawn_tiffs_decode_like_cv2(orientation, dtype, channels, photometric, predictor, h, w, seed):
    """The port's frame equals cv2's, or the port refuses what cv2 returns
    nothing for."""
    dt = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if dt.kind == "f":
        img = rng.normal(0, 100, (h, w, channels)).astype(dt)
        predictor = 1 if dt.itemsize == 8 else predictor
    else:
        info = np.iinfo(dt)
        img = rng.integers(info.min, info.max, (h, w, channels), dtype=np.int64, endpoint=True).astype(dt)
    data = fixtures.tiff_bytes(img if channels > 1 else img[..., 0], orientation=orientation,
                               photometric=photometric, predictor=predictor, compression=8)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if want is None:
        with pytest.raises(tiff.UnsupportedTiff):
            tiff.imdecode(data, "cpu")
        return
    got = tiff.imdecode(data, "cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# CCITT: host C against the plain decoder
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/tiff.cu`` built with the system C++ compiler, bound as the
    kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host CCITT decoder")
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


def _page(h, w, seed):
    """Shapes, rules and noise: runs of every length, long ones past 2560."""
    rng = np.random.default_rng(seed)
    page = fixtures.drawn_page(h, w) ^ (rng.random((h, w)) > 0.97)
    page[h // 3, :] = 1
    return page.astype(np.uint8)


def _pil_ccitt(bits, compression):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((1 - bits) * 255).convert("1").save(buf, "TIFF", compression=compression)
    return buf.getvalue()


CCITT_FILES = {
    "pil tiff_ccitt": lambda p: _pil_ccitt(p, "tiff_ccitt"),
    "pil group3": lambda p: _pil_ccitt(p, "group3"),
    "pil group4": lambda p: _pil_ccitt(p, "group4"),
    "T.4 2-D, k=2": lambda p: fixtures.tiff_bytes(p, bits=1, compression=3, photometric=0,
                                                  ccitt=(2, False), rows=13),
    "T.4 2-D, k=4, EOLs byte-aligned": lambda p: fixtures.tiff_bytes(p, bits=1, compression=3,
                                                                     photometric=0, ccitt=(4, True)),
    "T.4 2-D, fill order 2": lambda p: fixtures.tiff_bytes(p, bits=1, compression=3, photometric=0,
                                                           ccitt=(3, True), fill_order=2),
    "T.6, tiles": lambda p: fixtures.tiff_bytes(p, bits=1, compression=4, photometric=0, tile=(48, 32)),
    "MH": lambda p: fixtures.tiff_bytes(p, bits=1, compression=2, photometric=1),
}


@pytest.mark.parametrize("kind", sorted(CCITT_FILES))
@pytest.mark.parametrize("size", [(61, 83), (9, 3000)], ids=lambda s: f"{s[1]}x{s[0]}")
def test_host_ccitt_decoder_equals_the_plain_one(kind, size, host_library, monkeypatch):
    data = CCITT_FILES[kind](_page(*size, seed=size[0]))
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    lay = tiff._layout(*tiff.read_ifd(data))
    plain = tiff.samples_of(data, lay, "cpu")
    monkeypatch.setattr(_build, "entry", host_library)
    np.testing.assert_array_equal(tiff.samples_of(data, lay, "cuda"), plain)
    np.testing.assert_array_equal(tiff.imdecode(data, "cuda"), want)
    np.testing.assert_array_equal(tiff.imdecode(data, "cpu"), want)


def test_ccitt_decoders_refuse_malformed_data(host_library, monkeypatch):
    page = _page(20, 40, 1)
    coded = fixtures.ccitt_bytes(page, 4)
    monkeypatch.setattr(_build, "entry", host_library)
    for decode in (tiff.ccitt_decode_plain, tiff.ccitt_decode_host):
        with pytest.raises(ValueError, match="CCITT"):
            decode(coded[:len(coded) // 3], 40, 20, 4)
        with pytest.raises(ValueError, match="CCITT"):
            decode(b"\x00" * 8, 40, 2, 3)  # no EOL


# --------------------------------------------------------------------------- #
# J2's new modes and J6's plain version, by hand
# --------------------------------------------------------------------------- #


def _header(color, comps, height, width, **kw):
    """A Header of ``comps`` (h, v) sampling factors, laid out as parse lays
    them out."""
    components = [jpeg.Component(i + 1, h, v, 0, declared_v=v) for i, (h, v) in enumerate(comps)]
    jpeg._layout((height, width), components)
    quant = np.ones((len(comps), 64), np.uint16)
    return jpeg.Header(height, width, components, quant, [], color=color, **kw)


def _planes(header, values):
    """Planes of each component filled with ``values[i]`` (a constant or a
    (rows, cols) array at the top left)."""
    out = []
    for c, v in zip(header.components, values):
        p = torch.zeros((c.blocks_h * 8, c.blocks_w * 8), dtype=torch.uint8)
        v = torch.as_tensor(v, dtype=torch.uint8)
        if v.ndim:
            p[:v.shape[0], :v.shape[1]] = v
        else:
            p[:] = v
        out.append(p)
    return out


def test_color_plain_new_modes_by_hand():
    rgb = _header("rgb", [(1, 1)] * 3, 8, 8)
    assert jpeg.color_plain(_planes(rgb, [10, 20, 30]), rgb)[0, 0].tolist() == [30, 20, 10]
    # CMYK: each of C, M, Y becomes k - ((255 - v) * k >> 8), written B, G, R:
    # c=200, m=100, y=50, k=128 -> R 128-27, G 128-77, B 128-102.
    cmyk = _header("cmyk", [(1, 1)] * 4, 8, 8)
    assert jpeg.color_plain(_planes(cmyk, [200, 100, 50, 128]), cmyk)[3, 5].tolist() == [26, 51, 101]
    # YCCK: neutral YCbCr 128 is RGB 128, inverted to CMY 127; k=200 gives
    # 200 - (128 * 200 >> 8) = 100.
    ycck = _header("ycck", [(1, 1)] * 4, 8, 8)
    assert jpeg.color_plain(_planes(ycck, [128, 128, 128, 200]), ycck)[7, 7].tolist() == [100] * 3


def test_upsampling_of_440_and_411_by_hand():
    # 4:4:0: Y 1x2, chroma 1x1: h1v2 fancy, (3 * near + far + 1 or 2) >> 2,
    # the rows past the plane's edge replicated.
    h440 = _header("ycc", [(1, 2), (1, 1), (1, 1)], 4, 3)
    assert jpeg.upsampling(h440, h440.components[1]) == (1, 2, jpeg.H1V2)
    col = [[10, 10, 10], [50, 50, 50]]
    up = jpeg._upsample_plain(_planes(h440, [0, col, 0])[1], h440.components[1], h440)
    assert up[:, 0].tolist() == [(30 + 10 + 1) >> 2, (30 + 50 + 2) >> 2, (150 + 10 + 1) >> 2,
                                 (150 + 50 + 2) >> 2]
    # 4:1:1: Y 4x1, chroma 1x1: replicated four times across.
    h411 = _header("ycc", [(4, 1), (1, 1), (1, 1)], 2, 8)
    assert jpeg.upsampling(h411, h411.components[1]) == (4, 1, jpeg.REPLICATE)
    up = jpeg._upsample_plain(_planes(h411, [0, [[7, 9]], 0])[1], h411.components[1], h411)
    assert up[0].tolist() == [7, 7, 7, 7, 9, 9, 9, 9]
    # 4:2:2 and 4:2:0 keep their fancy upsamplers; a 2-sample plane replicates.
    assert jpeg.upsampling(_header("ycc", [(2, 1), (1, 1), (1, 1)], 8, 16),
                           jpeg.Component(2, 1, 1, 0, 8, 8)) == (2, 1, jpeg.H2V1)
    assert jpeg.upsampling(_header("ycc", [(2, 2), (1, 1), (1, 1)], 16, 3),
                           jpeg.Component(2, 1, 1, 0, 2, 8)) == (2, 2, jpeg.REPLICATE)


def _smooth_header(dcs, bits, quant):
    """One component, one row of blocks with DC values ``dcs``."""
    header = _header("gray", [(1, 1)], 8, 8 * len(dcs), coef_bits=[bits], smooth=True,
                     progressive=True)
    header.quant = np.ones((1, 64), np.uint16)
    for pos, q in quant.items():
        header.quant[0, pos] = q
    coefs = torch.zeros((len(dcs), 64), dtype=torch.int16)
    coefs[:, 0] = torch.tensor(dcs, dtype=torch.int16)
    return header, coefs


def test_smooth_plain_by_hand():
    # Coefficients 1-5 at Al 2, no change of DC. Block 2 of DCs 0 0 0 10 0:
    # AC01 = -7*0 + 50*0 - 50*10 + 7*0 = -500, times Q00 2 is -1000, over
    # Q01 4 << 8 with rounding (512 + 1000) // 1024 = 1: -1. AC02 = -0 +
    # 13*0 - 24*0 + 13*10 - 0 = 130, times 2 is 260: (128 + 260) // 256 = 1.
    # One row of blocks: the vertical estimates see equal rows, 0.
    header, coefs = _smooth_header([0, 0, 0, 10, 0], [0, 2, 2, 2, 2, 2, 0, 0, 0, 0], {0: 2, 1: 4})
    out = jpeg.smooth_plain(coefs, header)
    assert out[2, 1] == -1 and out[2, 2] == 1
    assert int(out[2].abs().sum()) == 2  # DC 0 and the rest stay
    # A coefficient already nonzero keeps its value.
    coefs[2, 1] = 5
    assert jpeg.smooth_plain(coefs, header)[2, 1] == 5
    # Al caps the estimate below 1 << Al: a step of 1000 would give -9 at Al 2.
    header, coefs = _smooth_header([0, 0, 0, 1000, 0], [0, 2, 2, 2, 2, 2, 0, 0, 0, 0], {0: 2, 1: 4})
    assert jpeg.smooth_plain(coefs, header)[2, 1] == -3
    # No AC data at all: DC interpolation. Equal DCs stay (the weights of the
    # DC estimate sum to 256) and every estimate is 0.
    header, coefs = _smooth_header([7] * 4, [1] + [-1] * 9, {0: 2})
    assert torch.equal(jpeg.smooth_plain(coefs, header), coefs)


def test_card_wrappers_of_this_slice_refuse_cpu_tensors():
    header, coefs = _smooth_header([0, 0, 0, 10, 0], [0, 2, 2, 2, 2, 2, 0, 0, 0, 0], {0: 2, 1: 4})
    with pytest.raises(ValueError, match="CUDA tensor"):
        jpeg.smooth_cuda(coefs, header)
