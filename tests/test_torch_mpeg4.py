"""MPEG-4 Part 2 on the port's card route (``io/mpeg4.py``, the AVI,
ISO-BMFF and Matroska demuxers, ``MediaVideo``), run here on the CPU with
the plain versions (the Python entropy decoder, ``mpeg4.intra_plain``,
``mpeg4.inter_plain`` and ``mpeg4.bidir_plain``, with FFmpeg's simple IDCT
or Xvid's).

The fixtures are ``tests/torch_data/mpeg4`` (``scripts/make_torch_mpeg4_fixtures.py``:
cv2's own ``FMP4``/``XVID``/``DIVX``/``mp4v`` streams in the three
containers, and ``scripts/write_mpeg4_fixture.py``'s random-syntax streams:
I- and P-VOPs, B-VOPs of every kind, Xvid's and DivX's user data, packed
bitstreams, intra VOPs of chosen coefficients), whose ``manifest.json``
records what OpenCV's FFmpeg backend reads from each. Held here, bit for
bit (tolerance 0):

- each demuxer's frame count, fps and readable frames equal cv2's, and the
  VOL is found where each container keeps it;
- every frame of every fixture, in order and at random, equals the recorded
  cv2 frame (BGR and the blue channel), and ``MediaVideo``'s card route
  equals the JAX package's ``MediaVideo.get_frame`` live, colour and gray,
  RGB and BGR; a frame that differs is reported by its first differing
  macroblock (:func:`sleap_tpu_torch.io.mpeg4.first_difference`), since an
  error drifts through its GOP;
- frame ``i`` is the ``i``-th frame of cv2's sequential read
  (``mpeg4.Schedule``: FFmpeg's one-VOP delay, B-VOPs dropped without a past
  reference or out of time order, packed VOPs), and where cv2's seek gives
  another frame the manifest records it and a test pins it;
- the host C entropy decoder (``csrc/mpeg4.cu`` built with the system C++
  compiler) equals the plain one on every VOP (B-VOPs and the co-located
  macroblocks they read included), refusals included;
- each tool the card route does not decode raises ``NotImplementedError``
  naming it, ``device='cpu'`` and ROADMAP.md item 3g;
- the trained top-down pair on the port's decoded frames against the JAX
  predictor on the JAX package's, within ``tests/test_torch_topdown.py``'s
  tolerances (0.01 px, 1e-4).

M1, M2 and M3 themselves, in their simple and Xvid instantiations, are
held to their plain versions on the card by ``chip_smoke.py`` phase 26a.
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
from sleap_tpu_torch.io import avi, mkv, mp4, mpeg4, yuv
from sleap_tpu_torch.io import video as tvideo
from sleap_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "mpeg4"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]
CLIP = "fmp4_gray_1024.avi"
XVID_CLIP = "xvid_gray_1024.avi"  # I, P and B-VOPs, Xvid's IDCT
SMALL = sorted(n for n in MANIFEST if n not in (CLIP, XVID_CLIP))
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_container_fixtures as containers  # noqa: E402
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

    def memo(data, vol, vop, colocated=None):
        key = (bytes(data), repr(vol), repr(vop), None if colocated is None else colocated.tobytes())
        if key not in decoded["macroblocks"]:
            decoded["macroblocks"][key] = decode(data, vol, vop, colocated)
        return decoded["macroblocks"][key]

    def memo_planes(inputs, layout, ref, rounding, kernels=None, lap=mpeg4._no_lap, idct="simple"):
        if kernels is not None or inputs[0].device.type != "cpu":
            return reconstruct(inputs, layout, ref, rounding, kernels, lap, idct)
        refs = None if ref is None else [p for r in ref for p in (r if isinstance(r, list) else [r])]
        key = (digest(inputs), None if ref is None else digest(refs), rounding, repr(layout), idct)
        if key not in decoded["planes"]:
            decoded["planes"][key] = reconstruct(inputs, layout, ref, rounding, lap=lap, idct=idct)
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


def jax_form(frame, ref):
    """A cv2 BGR frame as the JAX ``MediaVideo`` ``ref`` returns its frames."""
    if ref.is_grayscale:
        return frame[..., 0][..., None]
    return frame[..., ::-1] if ref.bgr else frame


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


@pytest.mark.parametrize("clip,frames", [(CLIP, (0, 1, 13, 2)), (XVID_CLIP, (1, 0, 2))])
def test_the_1024_clip_equals_the_recorded_cv2_frames(clip, frames):
    want = MANIFEST[clip]
    r = reader(clip)
    assert r.codec == "mpeg4" and (r.demux.width, r.demux.height) == (1024, 1024)
    for i in frames:
        got = r.frame(i, "b").numpy()[..., 0]
        assert sha(got) == want["gray"][i], (clip, i)


@pytest.mark.parametrize("name", SMALL)
@pytest.mark.parametrize("grayscale,bgr", [(None, True), (False, False), (True, True)])
def test_media_video_card_route_equals_jax(name, grayscale, bgr, card_route):
    path = str(FIXTURES / name)
    mine = tvideo.MediaVideo(path, grayscale=grayscale, bgr=bgr)
    ref = jvideo.MediaVideo(filename=path, grayscale=grayscale, bgr=bgr)
    assert mine.device.type == "cuda" and (mine.frames, mine.fps) == (ref.frames, ref.fps)
    n = MANIFEST[name]["readable"]
    for i in list(range(n)) + random_order(n, 1):
        got = mine.get_frame(i)
        if "seek" in MANIFEST[name] and str(i) in MANIFEST[name]["seek"]:
            # cv2's seek gives another frame than its read here (pinned by
            # the next test): the JAX reader's frame is one or the other.
            try:
                want = ref.get_frame(i)
            except KeyError:  # past cv2's count its seek finds nothing
                assert i >= MANIFEST[name]["frames"]
                continue
            assert np.array_equal(got, want) or np.array_equal(
                want, jax_form(cv2_frame(FIXTURES / name, i), ref)), f"{name} {i}"
            continue
        np.testing.assert_array_equal(got, ref.get_frame(i), err_msg=f"{name} {i}")
    assert (mine.is_grayscale, mine.channels, mine.height, mine.width) == \
        (ref.is_grayscale, ref.channels, ref.height, ref.width)


@pytest.mark.parametrize("name", [n for n in SMALL if "seek" in MANIFEST[n]])
def test_where_cv2_seeks_elsewhere_the_port_follows_its_read(name):
    """A Simple VOL with B-VOPs: FFmpeg clears ``low_delay`` at the first
    B-VOP, so one P-VOP comes out twice and cv2 reads a frame more than
    the AVI counts; its seeks (``CAP_PROP_POS_FRAMES``, the JAX reader's)
    land one frame on, and past the count nowhere. The port gives the
    sequential read's frames at random too (ROADMAP.md queue 3, item 5)."""
    want = MANIFEST[name]
    assert want["readable"] > want["frames"] and want["seek"]
    cap = cv2.VideoCapture(str(FIXTURES / name), cv2.CAP_FFMPEG)
    r = reader(name)
    for i, seek in sorted(want["seek"].items(), key=lambda kv: int(kv[0])):
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, frame = cap.read()
        assert (sha(frame) if ok else None) == seek != want["bgr"][int(i)], i
        assert sha(r.frame(int(i)).numpy()) == want["bgr"][int(i)], i
    cap.release()


def test_b_vop_schedule_orders_frames_as_ffmpeg_outputs_them():
    """FFmpeg's one-VOP delay (the past reference comes out at each I- and
    P-VOP, a B-VOP's frame at once, the last reference at the end), B-VOPs
    before any past reference dropped (a closed GOV's leading ones), B-VOPs
    out of time order skipped, and a packed bitstream's second VOP decoded
    at the next packet, in place of its not-coded placeholder."""
    def schedule(name):
        r = reader(name)._decoder
        r.schedule.until(10 ** 6)
        return r.schedule

    s = schedule("bvop_64x48.avi")
    assert "".join(s.units[u].kind for u in s.frames) == "IBBPBBPBIBBPBBPP"
    assert [u.packet for u in s.units] == list(range(16))  # one VOP a packet, decoding order
    kinds = [s.units[u].kind for u in s.frames]
    assert all(s.units[s.units[u].past].kind in "IP" for u in s.frames if kinds[s.frames.index(u)] == "B")
    s = schedule("bvop_gov_closed_64x48.avi")
    assert len(s.frames) == MANIFEST["bvop_gov_closed_64x48.avi"]["frames"] - 2  # two leading B-VOPs
    s = schedule("bvop_packets_96x64.avi")
    assert len(s.units) == 12 < MANIFEST["bvop_packets_96x64.avi"]["frames"]  # two out of time
    s = schedule("divx_packed_64x48.avi")
    packed = [u for u in s.units if u.offset]
    assert packed and all(u.kind == "B" for u in packed)
    assert len(s.frames) == MANIFEST["divx_packed_64x48.avi"]["readable"] == 16
    s = schedule("bvop_simple_vol_48x32.avi")
    assert s.frames[1] == s.frames[4] and s.units[s.frames[1]].kind == "P"


def test_b_vop_fixtures_reach_every_half_pel_pair_of_both_directions():
    """FFmpeg averages two predictions with its ``avg_pixels`` forms, 16
    wide (a 16x16 macroblock's luma) and 8 wide (chroma, a four-vector
    direct macroblock's luma), whose SIMD forms may round otherwise than C:
    the fixtures (held to cv2 above) reach every forward x backward half-pel
    (x, y) pair at both widths, in interpolated and direct macroblocks."""
    seen = set()
    for name in SMALL:
        if not name.startswith(("bvop", "xvid_bvop", "divx_packed", "xvid_packed")):
            continue
        colocated = {}
        for u, unit, data, vop in mpeg4.scheduled_vops(avi.read_frames(str(FIXTURES / name))):
            mbs = mpeg4.decode_macroblocks(data, unit.vol, vop, colocated.get(unit.future))
            if vop.kind != "B":
                colocated[u] = mbs.colocated
                continue
            for job in mbs.bidir:
                mode = mpeg4.B_MODES[mbs.modes[job[0] // 6]]
                if job[6] == 3:
                    wide = 8 if job[0] % 6 > 3 or mode == "direct 8x8" else 16
                    seen.add((mode.split()[0], wide, *(int(v) & 1 for v in job[2:6])))
    for mode, widths in (("interpolated", (16, 8)), ("direct", (16, 8))):
        for wide in widths:
            pairs = {s[2:] for s in seen if s[:2] == (mode, wide)}
            assert len(pairs) == 16, (mode, wide, sorted(pairs))


def test_a_not_coded_b_vop_gives_no_frame_and_keeps_the_clock(tmp_path):
    """A not-coded B-VOP gives no frame, and FFmpeg's clock reads its time
    as a B-VOP's (from the past reference's base), not a reference's: the
    B-VOPs after it keep their frames. Against cv2 live."""
    packets = writer.bstream(48, 32, 10, 10, 2, 7, low_delay=0)
    w = writer.BitWriter()
    w.start(0xB6)
    w.u(2, 2), w.u(1, 0), w.u(1, 1), w.u(3, 1), w.u(1, 1), w.u(1, 0)  # B, time 1, not coded
    w.stuff()
    stream = mpeg4.Stream()
    k = [stream.headers(p).kind for p in packets].index("B")
    path = tmp_path / "not_coded_b.avi"
    path.write_bytes(writer.avi_bytes(packets[:k] + [w.bytes()] + packets[k + 1:], 48, 32))
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    route = reader(path)
    i = 0
    while True:
        ok, want = cap.read()
        if not ok:
            break
        assert np.array_equal(route.frame(i).numpy(), want), i
        i += 1
    cap.release()
    assert i == 9
    with pytest.raises(KeyError, match="Unable to load frame"):
        route.frame(i)


def test_xvid_idct_plain_equals_cv2_on_crafted_intra_blocks():
    """``xvid_idct_values`` (M1's Xvid form's plain version) on intra VOPs
    of chosen coefficients: one at each of the 64 positions at six
    magnitudes, saturating DCs, full blocks of +-2047 and dense random
    blocks, to cv2's frames; FFmpeg's simple IDCT gives other frames."""
    name = "xvid_idct_64x48.avi"
    want = MANIFEST[name]
    stream = mpeg4.Stream("XVID")
    layout = mpeg4.Layout(4, 3)
    differs = 0
    for k, data in enumerate(avi.read_frames(str(FIXTURES / name))):
        vop = stream.headers(data)
        assert (vop.kind, stream.idct) == ("I", "xvid")
        mbs = mpeg4.decode_macroblocks(data, stream.vol, vop)
        frames = {}
        for idct in ("xvid", "simple"):
            planes = layout.planes("cpu")
            mpeg4.intra_plain(planes, torch.from_numpy(mbs.coefs), torch.from_numpy(mbs.intra),
                              layout, idct)
            y, u, v = planes
            frames[idct] = sha(yuv.to_bgr(y, u[:24, :32], v[:24, :32], "420", False, "bgr").numpy())
        assert frames["xvid"] == want["bgr"][k], k
        differs += frames["simple"] != want["bgr"][k]
    assert differs >= len(want["bgr"]) // 2


def test_b_vops_in_iso_bmff_and_matroska_raise_naming_them(tmp_path):
    """B-VOPs in a track of presentation order: no fixture in those
    containers is held to cv2 yet (ROADMAP.md item 3g(7))."""
    packets = writer.bstream(48, 32, 8, 8, 2, 3, low_delay=0)
    config = packets[0][:packets[0].index(b"\x00\x00\x01\xb6")]
    bare = [p[p.index(b"\x00\x00\x01\xb6"):] for p in packets]
    path = tmp_path / "bvop.mkv"
    path.write_bytes(containers.mkv_bytes(bare, [40 * k for k in range(8)], 48, 32, "V_MPEG4/ISO/ASP",
                                          config, default_duration=40_000_000, duration=320.0,
                                          keys=[k == 0 for k in range(8)]))
    r = reader(path)
    r.frame(0)
    with pytest.raises(NotImplementedError, match=f"B-VOPs in an ISO-BMFF or Matroska track.*{REFUSAL}"):
        for i in range(8):
            r.frame(i)


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
    """Every VOP FFmpeg decodes (``mpeg4.Schedule``'s units) through both
    entropy decoders, a B-VOP with its future reference's co-located
    macroblocks: coefficients, jobs and co-located arrays equal. Returns
    the schedule."""
    schedule = mpeg4.Schedule(lambda k: packets[k], len(packets), fourcc)
    schedule.until(len(packets) + 2)
    staging, colocated = None, {}
    for u, unit, data, vop in mpeg4.scheduled_vops(packets, fourcc):
        n = unit.vol.mb_size[0] * unit.vol.mb_size[1]
        if staging is None or staging.coefs.shape[0] != 6 * n:
            staging = mpeg4.Staging(n, pin=False)
        col = colocated.get(unit.future) if vop.kind == "B" else None
        plain = mpeg4.decode_macroblocks(data, unit.vol, vop, col)
        host, host_col = mpeg4.decode_macroblocks_host(data, unit.vol, vop, staging, col)
        want = (plain.coefs, plain.bidir) if vop.kind == "B" else (plain.coefs, plain.intra,
                                                                   plain.inter)
        for got, ref in zip(host, want):
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"VOP {u} ({vop.kind})")
        if vop.kind != "B":
            np.testing.assert_array_equal(host_col, plain.colocated, err_msg=f"VOP {u}")
            colocated[u] = plain.colocated
    return schedule


@pytest.mark.parametrize("name", [n for n in SMALL if n.endswith(".avi")])
def test_host_decoder_equals_the_plain_one(name, host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    demux = avi.AviVideo.open(str(FIXTURES / name))
    schedule = host_vs_plain(avi.read_frames(demux.filename), demux.compression)
    assert len(schedule.frames) == MANIFEST[name]["readable"]
    assert set(schedule.frames) == set(range(len(schedule.units)))  # each VOP decoded comes out


@pytest.mark.parametrize("seed", range(6))
def test_host_decoder_equals_the_plain_one_on_random_syntax(seed, host_library, monkeypatch):
    monkeypatch.setattr(_build, "entry", host_library)
    size = ((32, 32), (80, 48), (112, 16), (48, 64), (16, 80), (64, 32))[seed]
    vol = ({}, {"quant_type": 1}, {"resync": True}, {"quant_type": 1, "resync": True,
           "inter_matrix": [255, 3, 0]}, {"resync": True}, {})[seed]
    packets = writer.stream(*size, 10, 5, 40 + seed, odds={"gray": seed == 3, "mv4": 0.3,
                                                             "packet": 0.4, "nvop": 0.2}, **vol)
    assert len(host_vs_plain(packets).units) == 10


@pytest.mark.parametrize("seed", range(6))
def test_host_decoder_equals_the_plain_one_on_random_b_vop_syntax(seed, host_library, monkeypatch):
    """B-VOPs of every MB_TYPE over co-located macroblocks of every kind,
    with video packets, MPEG quantisation and packed bitstreams."""
    monkeypatch.setattr(_build, "entry", host_library)
    size = ((32, 32), (80, 48), (112, 16), (48, 64), (16, 80), (64, 32))[seed]
    vol = ({}, {"quant_type": 1}, {"resync": True}, {"quant_type": 1, "resync": True,
           "inter_matrix": [255, 3, 0]}, {"resync": True}, {})[seed]
    packets = writer.bstream(*size, 12, 6, 1 + seed % 3, 60 + seed, packed=seed == 5,
                             user_data=b"DivX503b1393p" if seed == 5 else None, low_delay=0,
                             odds={"gray": seed == 3, "mv4": 0.3, "packet": 0.3, "skip": 0.3,
                                   "intra": 0.15}, **vol)
    schedule = host_vs_plain(packets)
    assert sum(u.kind == "B" for u in schedule.units) >= 3


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
    if kind == 2:  # intra_dc_vlc_thr, quantiser 4, fcode_forward and fcode_backward 1
        w.u(3, 0), w.u(5, 4), w.u(3, 1), w.u(3, 1)
    else:
        w.u(4, 0), w.u(5, 4), w.u(3, 1)
    w.stuff()
    return w.bytes()


@pytest.mark.parametrize("packet,fourcc,what", [
    (vop_packet(3), "FMP4", r"S\(GMC\)-VOPs"),
    (vop_packet(0, vo_type=0), "XVID", "Xvid build 0 .*guessed from the fourcc"),  # FFmpeg's guess
    (vop_packet(0), "XVID", "Xvid build 0 .*guessed from the fourcc"),  # whatever the object type
    # Old Xvid builds: cv2 decodes builds to 12 with FF_BUG_EDGE and to 32
    # with FF_BUG_DC_CLIP otherwise than from 33 on (the fixtures' maker
    # found the three groups on a stream of overflowing DCs and vectors
    # past the frame).
    (vop_packet(0, user_data=b"XviD0001"), "XVID", "Xvid build 1 .*FF_BUG_EDGE"),
    (vop_packet(0, user_data=b"XviD0012"), "FMP4", "Xvid build 12 .*FF_BUG_EDGE"),
    (vop_packet(0, user_data=b"XviD0032"), "XVID", "Xvid build 32 .*FF_BUG_DC_CLIP"),
    (vop_packet(0, user_data=b"DivX412Build1000"), "DIVX", "FF_BUG_EDGE"),
    (vop_packet(0, user_data=b"DivX412Build1000p"), "DIVX", "FF_BUG_EDGE"),  # packed DivX 4
    (vop_packet(0, user_data=b"FFmpeg0.4.6b4600"), "FMP4", "FF_BUG_EDGE"),
    (vop_packet(0, vo_type=0), "DIVX", "FF_BUG_EDGE"),  # the tag: DivX 4
])
def test_vop_tools_and_encoders_the_card_does_not_decode_raise_naming_them(packet, fourcc, what):
    with pytest.raises(NotImplementedError, match=f"{what}.*{REFUSAL}"):
        mpeg4.Stream(fourcc).headers(packet)


@pytest.mark.parametrize("packet,fourcc,kind,idct", [
    (vop_packet(2), "FMP4", "B", "simple"),
    (vop_packet(0, user_data=b"XviD0050"), "FMP4", "I", "xvid"),
    (vop_packet(0, user_data=b"XviD0033"), "XVID", "I", "xvid"),  # the first build without workarounds
    (vop_packet(1, user_data=b"XviD0064"), "DIVX", "P", "xvid"),  # Xvid named: not DivX 4
    (vop_packet(0, user_data=b"DivX503b1820p"), "DIVX", "I", "simple"),
    (vop_packet(2, user_data=b"DivX500Build1000"), "DX50", "B", "simple"),
    # A packed bitstream's second VOP is the reader's (mpeg4.Schedule).
    (vop_packet(0) + b"\x00\x00\x01\xb6\x50\x50\x50", "FMP4", "I", "simple"),
])
def test_b_vops_xvid_and_packed_streams_the_card_decodes(packet, fourcc, kind, idct):
    stream = mpeg4.Stream(fourcc)
    vop = stream.headers(packet)
    assert (vop.kind, stream.idct) == (kind, idct)
    assert packet[stream.vop_at - 4:stream.vop_at] == b"\x00\x00\x01\xb6"


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
