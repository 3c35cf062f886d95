"""MPEG-4 Part 2 on the port's card route (``io/mpeg4.py``, the AVI,
ISO-BMFF and Matroska demuxers, ``MediaVideo``), run here on the CPU with
the plain versions (the Python entropy decoder, ``mpeg4.intra_plain`` and
``mpeg4.inter_plain``).

The fixtures are ``tests/torch_data/mpeg4`` (``scripts/make_torch_mpeg4_fixtures.py``:
cv2's own ``FMP4``/``XVID``/``DIVX``/``mp4v`` streams in the three
containers, and ``scripts/write_mpeg4_fixture.py``'s random-syntax streams),
whose ``manifest.json`` records what OpenCV's FFmpeg backend reads from each.
Held here, bit for bit (tolerance 0):

- each demuxer's frame count, fps and readable frames equal cv2's, and the
  VOL is found where each container keeps it;
- every frame of every fixture, in order and at random, equals the recorded
  cv2 frame (BGR and the blue channel), and ``MediaVideo``'s card route
  equals the JAX package's ``MediaVideo.get_frame`` live, colour and gray,
  RGB and BGR; a frame that differs is reported by its first differing
  macroblock (:func:`sleap_tpu_torch.io.mpeg4.first_difference`), since an
  error drifts through its GOP;
- the host C entropy decoder (``csrc/mpeg4.cu`` built with the system C++
  compiler) equals the plain one on every VOP, refusals included;
- each tool the card route does not decode raises ``NotImplementedError``
  naming it, ``device='cpu'`` and ROADMAP.md item 3g;
- the trained top-down pair on the port's decoded frames against the JAX
  predictor on the JAX package's, within ``tests/test_torch_topdown.py``'s
  tolerances (0.01 px, 1e-4).

M1 and M2 themselves are held to their plain versions on the card by
``chip_smoke.py`` phase 26a.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.io import avi, mkv, mp4, mpeg4
from sleap_tpu_torch.io import video as tvideo
from sleap_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "mpeg4"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]
CLIP = "fmp4_gray_1024.avi"
SMALL = sorted(n for n in MANIFEST if n != CLIP)
sys.path.insert(0, str(REPO / "scripts"))
import write_mpeg4_fixture as writer  # noqa: E402

REFUSAL = r"is not decoded on the card \(device='cuda'\); read the video with device='cpu'.*ROADMAP.md item 3g"


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def random_order(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


@pytest.fixture(scope="module")
def decoded():
    """``decode_macroblocks``'s results and ``reconstruct``'s planes by what
    they were computed from, across this file's tests."""
    return {"macroblocks": {}, "planes": {}}


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


@pytest.fixture(autouse=True)
def decode_once(monkeypatch, decoded):
    """The plain entropy decoder memoised by its packet and headers, and M2
    and M1's plain versions (``mpeg4.reconstruct`` on the CPU) by the bytes
    of their inputs and reference: pure functions of what the key holds, so
    a read that seeks wrongly or decodes on a stale reference still gets
    what it computed. One thread for torch's small integer ops."""
    decode, reconstruct = mpeg4.decode_macroblocks, mpeg4.reconstruct
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def memo(data, vol, vop):
        key = (bytes(data), repr(vol), repr(vop))
        if key not in decoded["macroblocks"]:
            decoded["macroblocks"][key] = decode(data, vol, vop)
        return decoded["macroblocks"][key]

    def memo_planes(inputs, layout, ref, rounding, kernels=None, lap=mpeg4._no_lap):
        if kernels is not None or inputs[0].device.type != "cpu":
            return reconstruct(inputs, layout, ref, rounding, kernels, lap)
        key = (digest(inputs), None if ref is None else digest(ref), rounding, repr(layout))
        if key not in decoded["planes"]:
            decoded["planes"][key] = reconstruct(inputs, layout, ref, rounding, lap=lap)
        return [p.clone() for p in decoded["planes"][key]]

    monkeypatch.setattr(mpeg4, "decode_macroblocks", memo)
    monkeypatch.setattr(mpeg4, "reconstruct", memo_planes)
    yield
    torch.set_num_threads(threads)


OPENED = []  # the card-route readers a test made, closed after it


@pytest.fixture(autouse=True)
def close_readers():
    yield
    while OPENED:
        OPENED.pop().close()


def reader(name):
    OPENED.append(tvideo._card_reader(str(FIXTURES / name), "cpu"))
    return OPENED[-1]


def cv2_frame(path, i):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    cap.set(cv2.CAP_PROP_POS_FRAMES, i)
    ok, frame = cap.read()
    cap.release()
    assert ok
    return frame


def where_it_differs(name, i, got) -> str:
    """The first macroblock (column, row) where frame ``i`` differs from cv2's."""
    return f"{name} frame {i}: first differing macroblock " \
           f"{mpeg4.first_difference(got, cv2_frame(FIXTURES / name, i))}"


@pytest.fixture
def card_route(monkeypatch):
    """``MediaVideo(device="cuda")``'s reader built on the CPU: the card's
    route with the plain versions."""
    made, card_reader = [], tvideo._card_reader

    def build(filename, device):
        assert torch.device(device).type == "cuda"
        made.append(card_reader(filename, "cpu"))
        OPENED.append(made[-1])
        return made[-1]

    monkeypatch.setattr(tvideo, "_card_reader", build)
    return made


# --------------------------------------------------------------------------- #
# Containers and headers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_demuxer_count_fps_and_readable_frames_equal_cv2(name):
    want = MANIFEST[name]
    r = reader(name)
    demux = r.demux
    assert (demux.frames, demux.fps) == (want["frames"], want["fps"])
    decoder = r._decoder if isinstance(r, avi.AviReader) else r
    assert isinstance(decoder, mpeg4.Mpeg4Reader)
    decoder._frame_packet(want["readable"] - 1)
    with pytest.raises(KeyError, match="Unable to load frame"):
        decoder._frame_packet(want["readable"])  # cv2 reads no further
    h, w = want["shape"][:2]
    assert (decoder.width, decoder.height) == (w, h)


def test_each_container_keeps_the_vol_where_ffmpeg_reads_it():
    """In-band before each I-VOP in AVI; ``esds``'s DecoderSpecificInfo in
    ISO-BMFF; ``CodecPrivate`` in Matroska (the bytes past the
    BITMAPINFOHEADER for ``V_MS/VFW/FOURCC``, empty here: the VOL in-band)."""
    packets = avi.read_frames(str(FIXTURES / "fmp4_200x120.avi"))
    keys = [k for k, p in enumerate(packets) if b"\x00\x00\x01\x20" in p]
    assert keys == [0, 12, 24] and all(mpeg4.Stream().headers(packets[k]).kind == "I" for k in keys)
    mp4v = mp4.Mp4Video.open(str(FIXTURES / "mp4v_200x120.mp4"))
    assert (mp4v.kind, mp4v.codec) == ("mpeg4", "mp4v") and mp4v.config.startswith(b"\x00\x00\x01\xb0")
    stream = mpeg4.Stream(config=mp4v.config)
    assert (stream.vol.width, stream.vol.height, stream.vol.time_bits) == (200, 120, 5)
    assert stream.encoder.lavc_build == (62 << 16) + (28 << 8) + 101  # "Lavc62.28.101"
    for name, codec_id, fourcc in (("mp4v_200x120.mkv", "V_MPEG4/ISO/ASP", ""),
                                   ("sp_200x120.mkv", "V_MPEG4/ISO/SP", ""),
                                   ("vfw_fmp4_200x120.mkv", "V_MS/VFW/FOURCC", "FMP4")):
        video = mkv.MkvVideo.open(str(FIXTURES / name))
        assert (video.kind, video.codec_id, video.fourcc) == ("mpeg4", codec_id, fourcc)
        assert video.config == (b"" if fourcc else mp4v.config)
    with open(FIXTURES / "mp4v_200x120.mov", "rb") as f:
        assert tvideo.container_of(f.read(12)) == "isobmff"
    # An ES descriptor (ES_ID 1) holding a DecoderConfigDescriptor of MPEG-4
    # Visual without DecoderSpecificInfo, then one with it.
    config = bytes([4, 13, 0x20, 0x11]) + bytes(11)
    assert mp4.parse_esds(bytes(4) + bytes([3, 3 + len(config), 0, 1, 0]) + config, "x") == (0x20, b"")
    info = bytes([5, 3, 0, 0, 1])
    config = bytes([4, 13 + len(info), 0x20, 0x11]) + bytes(11) + info
    assert mp4.parse_esds(bytes(4) + bytes([3, 3 + len(config), 0, 1, 0]) + config, "x") == \
        (0x20, b"\x00\x00\x01")
    for tag in ("FMP4", "xvid", "DivX", "DX50", "MP4V", "M4S2", "mp4v", "3IV2"):
        assert tag.upper() in mpeg4.FOURCCS


def test_an_avi_whose_vol_is_in_strf_reads_as_cv2_reads_it(tmp_path):
    """Some writers put the VOL in ``strf``'s extradata, not before the
    I-VOPs: FFmpeg's avidec hands it to the decoder."""
    packets = writer.stream(48, 32, 8, 4, 11)
    vol = packets[0][:packets[0].index(b"\x00\x00\x01\xb6")]
    bare = [p[p.index(b"\x00\x00\x01\xb6"):] for p in packets]
    path = tmp_path / "strf_vol.avi"
    path.write_bytes(writer.avi_bytes(bare, 48, 32, extradata=vol))
    route, cap = tvideo._card_reader(str(path), "cpu"), cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    OPENED.append(route)
    for i in range(8):
        ok, want = cap.read()
        assert ok and np.array_equal(route.frame(i).numpy(), want), i
    cap.release()


def test_vop_headers_and_the_encoder_in_user_data():
    packets = avi.read_frames(str(FIXTURES / "fmp4_200x120.avi"))
    stream = mpeg4.Stream("FMP4")
    kinds = [stream.headers(p) for p in packets]
    assert "".join(v.kind for v in kinds) == ("I" + "P" * 11) * 3
    assert {v.rounding for v in kinds if v.kind == "P"} == {0, 1}  # vop_rounding_type alternates
    assert all(1 <= v.quant <= 31 and v.dc_threshold == 99 for v in kinds)  # libavcodec: thr 0
    enc = mpeg4.Encoder()
    for text, field, value in ((b"DivX503Build1820p", "divx_packed", True),
                               (b"XviD0050", "xvid_build", 50), (b"FFmpeg0.4.9b4752", "lavc_build", 4752),
                               (b"ffmpeg", "lavc_build", 4600), (b"Lavc58.1.2", "lavc_build", 3801346)):
        enc = mpeg4.Encoder()
        enc.read(text)
        assert getattr(enc, field) == value, text


# --------------------------------------------------------------------------- #
# Frames against cv2
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", SMALL)
def test_card_route_frames_equal_the_recorded_cv2_frames(name):
    want = MANIFEST[name]
    r = reader(name)
    for i in list(range(want["readable"])) + random_order(want["readable"]):
        got = r.frame(i, "bgr").numpy()
        assert sha(got) == want["bgr"][i], where_it_differs(name, i, got)
        assert sha(r.frame(i, "b").numpy()[..., 0]) == want["gray"][i], (name, i)
    with pytest.raises(KeyError, match="Unable to load frame"):
        r.frame(want["readable"])


def test_the_1024_clip_equals_the_recorded_cv2_frames():
    want = MANIFEST[CLIP]
    r = reader(CLIP)
    assert r.codec == "mpeg4" and (r.demux.width, r.demux.height) == (1024, 1024)
    for i in (0, 1, 13, 2):
        got = r.frame(i, "b").numpy()[..., 0]
        assert sha(got) == want["gray"][i], (CLIP, i)


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("grayscale,bgr", [(None, True), (False, False), (True, True)])
def test_media_video_card_route_equals_jax(name, grayscale, bgr, card_route):
    path = str(FIXTURES / name)
    mine = tvideo.MediaVideo(path, grayscale=grayscale, bgr=bgr)
    ref = jvideo.MediaVideo(filename=path, grayscale=grayscale, bgr=bgr)
    assert mine.device.type == "cuda" and (mine.frames, mine.fps) == (ref.frames, ref.fps)
    n = MANIFEST[name]["readable"]
    for i in list(range(n)) + random_order(n, 1):
        np.testing.assert_array_equal(mine.get_frame(i), ref.get_frame(i), err_msg=f"{name} {i}")
    assert (mine.is_grayscale, mine.channels, mine.height, mine.width) == \
        (ref.is_grayscale, ref.channels, ref.height, ref.width)


def test_reads_carry_the_decoder_forward_and_seek_from_the_i_vop():
    r = reader("fmp4_200x120.avi")._decoder
    r.timing = {}
    for i in range(14):
        r.frame(i)
    assert r.timing["vops"] == 14  # each VOP decoded once in order
    r.frame(13)
    assert r.timing["vops"] == 14  # the frame the reference holds
    r.frame(5)
    assert r.timing["vops"] == 20  # back: from the I-VOP at 0
    r.frame(30)
    assert r.timing["vops"] == 27  # past an I-VOP: from the one at 24
    r.frame(31)
    assert r.timing["vops"] == 28


def test_first_difference_names_the_first_macroblock_in_decoding_order():
    a = np.zeros((40, 50, 3), np.uint8)
    assert mpeg4.first_difference(a, a) is None
    b = a.copy()
    b[39, 2, 1] = 1
    b[20, 49, 0] = 1
    assert mpeg4.first_difference(b, a) == (3, 1)
    assert mpeg4.first_difference(b[..., 0], a[..., 0]) == (3, 1)


# --------------------------------------------------------------------------- #
# The plain versions by hand, and the host C decoder
# --------------------------------------------------------------------------- #


def test_plain_prediction_rounding_and_edges_by_hand():
    ref = torch.tensor([[0, 9], [4, 255]], dtype=torch.uint8)
    x = y = torch.zeros(1, dtype=torch.long)

    def one(mx, my, rounding, approx=False):
        return mpeg4.predict(ref, x, y, torch.tensor([mx]), torch.tensor([my]), rounding, approx)[0]

    assert one(0, 0, 0)[0, 0] == 0 and one(0, 0, 0)[7, 7] == 255  # clamped to the edge
    assert one(1, 0, 0)[0, 0] == 5 and one(1, 0, 1)[0, 0] == 4  # (a + b + 1 - r) >> 1
    assert one(0, 1, 0)[0, 0] == 2 and one(0, 1, 1)[0, 0] == 2
    assert one(1, 1, 0)[0, 0] == (0 + 9 + 4 + 255 + 2) >> 2 and one(1, 1, 1)[0, 0] == 67
    # MMXEXT's 8-wide no_rnd halves: the left sample lowered by one, and the
    # odd row of each pair, with saturation, before a rounding average.
    assert one(1, 0, 1, True)[0, 0] == (0 + 9 + 1) >> 1  # a = 0 stays 0
    assert one(-1, 0, 1, True)[0, 1] == (0 + 9 + 1) >> 1
    assert one(0, 1, 1, True)[0, 0] == (0 + 3 + 1) >> 1  # row 1 lowered
    assert one(0, 1, 1, True)[1, 0] == (3 + 4 + 1) >> 1  # output row 1: its own row lowered
    assert mpeg4.chroma_vector(5, -3) == (3, -1) and mpeg4.chroma_vector(2, 6) == (1, 3)


def test_intra_plain_is_the_simple_idct_without_the_level_shift():
    layout = mpeg4.Layout(1, 1)
    planes = layout.planes("cpu")
    coefs = torch.zeros((6, 64), dtype=torch.int16)
    coefs[:, 0] = torch.tensor([1024, 0, -8, 2047, 512, 800])
    jobs = torch.tensor([[k, k, 0, 0] for k in range(6)], dtype=torch.int32)
    mpeg4.intra_plain(planes, coefs, jobs, layout)
    assert (planes[0][:8, :8] == 128).all() and (planes[0][:8, 8:] == 0).all()
    assert (planes[0][8:, :8] == 0).all() and (planes[0][8:, 8:] == 255).all()
    assert (planes[1] == 64).all() and (planes[2] == 100).all()


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """``csrc/mpeg4.cu``'s host decoder built with the system C++ compiler,
    bound as the kernel library binds it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the host MPEG-4 decoder")
    lib = tmp_path_factory.mktemp("host") / "libmpeg4host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(Path(_build.CSRC) / "mpeg4.cu")], check=True, capture_output=True)
    cdll = ctypes.CDLL(str(lib))

    def entry(name):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    return entry


def host_vs_plain(packets, fourcc=""):
    stream, staging, vops = mpeg4.Stream(fourcc), None, 0
    for k, data in enumerate(packets):
        vop = stream.headers(data)
        if vop.kind == "N":
            continue
        n = stream.vol.mb_size[0] * stream.vol.mb_size[1]
        if staging is None or staging.coefs.shape[0] != 6 * n:
            staging = mpeg4.Staging(n, pin=False)
        plain = mpeg4.decode_macroblocks(data, stream.vol, vop)
        coefs, intra, inter = mpeg4.decode_macroblocks_host(data, stream.vol, vop, staging)
        np.testing.assert_array_equal(coefs.numpy(), plain.coefs, err_msg=f"VOP {k}")
        np.testing.assert_array_equal(intra.numpy(), plain.intra, err_msg=f"VOP {k}")
        np.testing.assert_array_equal(inter.numpy(), plain.inter, err_msg=f"VOP {k}")
        vops += 1
    return vops


@pytest.mark.parametrize("name", [n for n in SMALL if n.endswith(".avi")])
def test_host_decoder_equals_the_plain_one(name, host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    demux = avi.AviVideo.open(str(FIXTURES / name))
    assert host_vs_plain(avi.read_frames(demux.filename), demux.compression) == MANIFEST[name]["readable"]


@pytest.mark.parametrize("seed", range(6))
def test_host_decoder_equals_the_plain_one_on_random_syntax(seed, host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    size = ((32, 32), (80, 48), (112, 16), (48, 64), (16, 80), (64, 32))[seed]
    vol = ({}, {"quant_type": 1}, {"resync": True}, {"quant_type": 1, "resync": True,
           "inter_matrix": [255, 3, 0]}, {"resync": True}, {})[seed]
    packets = writer.stream(*size, 10, 5, 40 + seed, odds={"gray": seed == 3, "mv4": 0.3,
                                                             "packet": 0.4, "nvop": 0.2}, **vol)
    assert host_vs_plain(packets) == 10


# --------------------------------------------------------------------------- #
# What the card route refuses
# --------------------------------------------------------------------------- #


def vol_bytes(width=64, height=48, **vol) -> bytes:
    w = writer.BitWriter()
    writer.vol_headers(w, width, height, 25, **vol)
    w.stuff()
    return w.bytes()


@pytest.mark.parametrize("vol,what", [
    ({"interlaced": 1}, "Interlaced MPEG-4"), ({"ver_id": 2, "quarter_sample": 1}, "Quarter-pel"),
    ({"sprite": 1}, "static sprites"), ({"ver_id": 2, "sprite": 2}, r"GMC sprites \(S-VOPs\)"),
    ({"bits": 12}, "12-bit samples"), ({"complexity": 1}, "complexity estimation"), ({"data_partitioned": 1}, "data partitioning"),
    ({"ver_id": 2, "newpred": 1}, "NEWPRED"), ({"ver_id": 2, "reduced_res": 1}, "reduced-resolution"),
    ({"scalability": 1}, "Scalable"), ({"shape": 1}, "binary shape"), ({"shape": 3}, "grayscale shape"),
    ({"chroma_format": 2}, "chroma_format 2"), ({"vo_type": 14}, "Studio Profile"),
    ({"video_range": 1}, "Full-range"), ({"width": 66, "height": 47}, r"odd size \(66 x 47\)"),
])
def test_vol_tools_the_card_does_not_decode_raise_naming_them(vol, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*{REFUSAL}"):
        mpeg4.Stream().headers(vol_bytes(**vol))


def vop_packet(kind: int, coded: int = 1, user_data: bytes = b"", **vol) -> bytes:
    """A VOL (and user data) and a VOP header of coding type ``kind``."""
    w = writer.BitWriter()
    writer.vol_headers(w, 64, 48, 25, **vol)
    if user_data:
        w.start(0xB2)
        w.bits.append("".join(format(b, "08b") for b in user_data))
    w.start(0xB6)
    w.u(2, kind), w.u(1, 0), w.u(1, 1), w.u(5, 0), w.u(1, 1), w.u(1, coded)
    w.u(4, 0), w.u(5, 4), w.u(3, 1)
    w.stuff()
    return w.bytes()


@pytest.mark.parametrize("packet,fourcc,what", [
    (vop_packet(2), "FMP4", "B-VOPs"), (vop_packet(3), "FMP4", r"S\(GMC\)-VOPs"),
    (vop_packet(0, user_data=b"XviD0050"), "FMP4", "Xvid-encoded.*build 50"),
    (vop_packet(0, vo_type=0), "XVID", "Xvid-encoded.*build 0"),  # FFmpeg's guess from the tag
    (vop_packet(0, user_data=b"DivX503b1820p"), "DIVX", "packed MPEG-4 bitstream"),
    (vop_packet(0, user_data=b"DivX412Build1000"), "DIVX", "FF_BUG_EDGE"),
    (vop_packet(0, user_data=b"FFmpeg0.4.6b4600"), "FMP4", "FF_BUG_EDGE"),
    (vop_packet(0, vo_type=0), "DIVX", "FF_BUG_EDGE"),  # the tag: DivX 4
    (vop_packet(0) + b"\x00\x00\x01\xb6\x50\x50\x50", "FMP4", "Two VOPs in one packet"),
])
def test_vop_tools_and_encoders_the_card_does_not_decode_raise_naming_them(packet, fourcc, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*{REFUSAL}"):
        mpeg4.Stream(fourcc).headers(packet)


def test_an_xvid_fourcc_of_a_libavcodec_stream_is_decoded():
    """cv2's XVID AVI carries libavcodec's user data, so FFmpeg keeps its
    simple IDCT: the fixture decodes (test above), the guess only applies
    to streams that name no encoder."""
    stream = mpeg4.Stream("XVID")
    assert stream.headers(vop_packet(0, user_data=b"Lavc62.28.101")).kind == "I"


def test_mpeg_quantisation_matrices_load_as_ffmpeg_loads_them():
    """Up to 64 values in zigzag order, a 0 ending them early and the last
    repeated; a matrix not loaded is the default."""
    stream = mpeg4.Stream()
    stream.headers(vol_bytes(quant_type=1, inter_matrix=[9, 40, 200, 0]))
    assert stream.vol.intra_matrix == mpeg4.DEFAULT_INTRA_MATRIX
    want = [200] * 64
    want[0], want[1] = 9, 40
    assert list(stream.vol.inter_matrix) == want
    assert mpeg4.Stream().headers(vol_bytes()) is None and mpeg4.Stream(
        config=vol_bytes()).vol.intra_matrix is None


def test_not_coded_vops_give_no_frame():
    """cv2 counts the AVI's packets but reads one frame a coded VOP: frame
    ``i`` is the ``i``-th coded VOP; a not-coded one leaves the reference."""
    name = "syntax_nvop_64x48.avi"
    r = reader(name)._decoder
    packets = avi.read_frames(str(FIXTURES / name))
    stream = mpeg4.Stream()
    kinds = "".join(stream.headers(p).kind for p in packets)
    assert kinds.count("N") == MANIFEST[name]["frames"] - MANIFEST[name]["readable"] > 0
    coded = [k for k, kind in enumerate(kinds) if kind != "N"]
    assert [r._frame_packet(i) for i in range(len(coded))] == coded


def bad_packet_stream(prefix: int, mb: int):
    """An I-VOP of two macroblocks whose VOL enables resync markers, a video
    packet header of a ``prefix``-zero marker and macroblock ``mb`` between
    them."""
    w = writer.BitWriter()
    writer.vol_headers(w, 32, 16, 25, resync=True)
    w.start(0xB6)
    w.u(2, 0), w.u(1, 0), w.u(1, 1), w.u(5, 0), w.u(1, 1), w.u(1, 1)
    w.u(3, 0), w.u(5, 4)
    for k in range(2):
        if k:
            w.stuff()
            w.u(prefix, 0), w.u(1, 1)  # the resync marker
            w.u(1, mb), w.u(5, 4), w.u(1, 0)  # macroblock_number, quant_scale, HEC
        w.code(mpeg4.INTRA_MCBPC, 0)
        w.u(1, 0)  # ac_pred
        w.code(mpeg4.CBPY, 0)
        for n in range(6):
            w.code(mpeg4.DC_LUM if n < 4 else mpeg4.DC_CHROM, 0)
    w.stuff()
    return w.bytes()


@pytest.mark.parametrize("prefix,mb,what", [(17, 1, "17 zeros, not 16"),
                                            (16, 0, "macroblock 0, not 1")])
def test_a_wrong_video_packet_header_raises(prefix, mb, what, host_library, monkeypatch):
    data = bad_packet_stream(prefix, mb)
    stream = mpeg4.Stream()
    vop = stream.headers(data)
    with pytest.raises(ValueError, match=what):
        mpeg4.decode_macroblocks(data, stream.vol, vop)
    monkeypatch.setattr(_build, "entry", host_library)
    with pytest.raises(ValueError, match="video packet header"):
        mpeg4.decode_macroblocks_host(data, stream.vol, vop, mpeg4.Staging(2, pin=False))
    good = bad_packet_stream(16, 1)
    assert len(mpeg4.decode_macroblocks(good, stream.vol, stream.headers(good)).intra) == 12
    with pytest.raises(ValueError, match="staging for 1 macroblocks, the VOP has 2"):
        mpeg4.decode_macroblocks_host(good, stream.vol, vop, mpeg4.Staging(1, pin=False))


def test_an_mp4v_entry_of_other_video_and_other_codecs_raise(tmp_path):
    data = (FIXTURES / "mp4v_200x120.mp4").read_bytes()
    at = data.index(b"esds") + 4
    tag = data.index(b"\x04", at + 8)  # the DecoderConfigDescriptor
    oti = tag + 1 + next(k for k in range(4) if data[tag + 1 + k] < 0x80) + 1
    assert data[oti] == 0x20
    mpeg2 = tmp_path / "mpeg2.mp4"
    mpeg2.write_bytes(data[:oti] + b"\x61" + data[oti + 1:])
    with pytest.raises(NotImplementedError, match="objectTypeIndication 0x61"):
        reader(mpeg2)
    other = (FIXTURES / "vfw_fmp4_200x120.mkv").read_bytes().replace(
        struct.pack("<iiHH4s", 200, 120, 1, 24, b"FMP4"), struct.pack("<iiHH4s", 200, 120, 1, 24, b"HFYU"))
    assert other.count(b"HFYU") == 1
    (tmp_path / "hfyu.mkv").write_bytes(other)
    with pytest.raises(NotImplementedError, match="fourcc 'HFYU'"):
        reader(tmp_path / "hfyu.mkv")


def test_card_route_never_falls_back_to_cv2(monkeypatch):
    """Without a card the default device raises from torch (its pinned
    staging buffer), with cv2 absent: no frame comes from cv2."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    video = tvideo.MediaVideo(str(FIXTURES / "fmp4_gray_96x64.avi"))
    assert video.frames == 24 and video.fps == 25.0
    with pytest.raises(RuntimeError, match="pin_memory"):
        video.get_frame(0)
    video.reset()


# --------------------------------------------------------------------------- #
# The slice: sleap-track's top-down pair on decoded MPEG-4 frames
# --------------------------------------------------------------------------- #


def test_trained_topdown_pair_on_mpeg4_frames_matches_jax(card_route):
    """The trained pair (``.convergence_runs``) on the first two frames of
    the 1024^2 clip (an I-VOP and a P-VOP): the port's card route (plain
    versions) against the JAX package's frames and predictor."""
    import jax

    from sleap_tpu.inference import predictors as jp
    from sleap_tpu_torch.inference import predictors as tp

    runs = REPO / ".convergence_runs"
    centroid = str(runs / "minimal_instance.UNet.centroid")
    instance = str(runs / "minimal_instance.UNet.centered_instance")
    path = str(FIXTURES / CLIP)
    video = tvideo.MediaVideo(path)
    mine = np.stack([video.get_frame(i) for i in (0, 1)])
    ref_video = jvideo.MediaVideo(filename=path)
    ref = np.stack([ref_video.get_frame(i) for i in (0, 1)])
    np.testing.assert_array_equal(mine, ref)
    with jax.default_matmul_precision("highest"):
        jpred = jp.TopDownPredictor.from_trained_models(
            centroid_model_path=centroid, confmap_model_path=instance, peak_threshold=0.05,
            batch_size=2)
        want = jpred.predict(ref, make_labels=False)
    params = {p: jax.tree_util.tree_map(np.asarray, m.variables["params"])
              for p, m in ((centroid, jpred.centroid_model), (instance, jpred.confmap_model))}
    tpred = tp.load_model([centroid, instance], device="cpu", params=params, peak_threshold=0.05,
                          batch_size=2)
    got = tpred.predict(mine, make_labels=False)
    keys = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")
    got, want = ({k: np.concatenate([ex[k][:ex["n_valid"]] for ex in out]) for k in keys}
                 for out in (got, want))
    np.testing.assert_array_equal(got["centroid_mask"], want["centroid_mask"])
    assert got["centroid_mask"].sum() >= 2
    for key, tol in (("centroids", 0.01), ("instance_peaks", 0.01), ("centroid_vals", 1e-4),
                     ("instance_peak_vals", 1e-4)):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(want[key]))
        np.testing.assert_allclose(np.nan_to_num(got[key]), np.nan_to_num(want[key]), atol=tol,
                                   rtol=0, err_msg=key)
