"""AVI files on the port's card route (``io/avi.py``'s demuxer, ``io/mjpeg.py``,
``io/yuv.py``, ``MediaVideo``), run here on the CPU with the plain versions
(the plain Huffman decoder and J5's plain version, ``mjpeg.idct_plain``).

The fixtures are ``tests/torch_data/avi`` (``scripts/make_torch_avi_fixtures.py``),
whose ``manifest.json`` records what OpenCV's FFmpeg backend reads from each.
Held here, bit for bit (tolerance 0):

- the demuxer's frame count, fps and readable frames equal cv2's on every
  fixture (OpenDML, no ``idx1``, ``LIST 'rec '`` with audio and absolute
  ``idx1`` offsets, zero-length chunks);
- every frame of every fixture, in order and at random, equals the recorded
  cv2 frame (BGR and the blue channel), and ``MediaVideo``'s card route
  equals the JAX package's ``MediaVideo.get_frame`` live, colour and gray,
  RGB and BGR, in order and at random; the IDCT probe clip pins FFmpeg's
  IDCT on 168 frames of single-coefficient and random sparse blocks;
- each of swscale's conversions (4:2:0, 4:2:2 and 4:4:4, full and limited
  range) on every (Y, U) and (Y, V) pair, through Motion-JPEG frames of
  constant blocks read by cv2;
- what the card route does not decode raises naming it: other codecs in
  AVI, odd-height 4:2:0 frames (swscale's scaler; the unscaled rule would
  differ from cv2 by up to 73 levels in 91 % of the values of
  ``opencv_mjpeg_37x29.avi``), interlaced and flagged frames, 12-bit
  samples;
- the trained top-down pair on the port's decoded AVI frames against the
  JAX predictor on the JAX package's, within ``tests/test_torch_topdown.py``'s
  tolerances (0.01 px, 1e-4).

cv2 5.0.0 corrupts its heap reading bottom-up 24-bit ``BI_RGB`` frames, so
that fixture is held to its written frames and never opened with cv2 here.
J5 itself is held to ``idct_plain`` on the card by ``chip_smoke.py`` phase 21a.
"""

from __future__ import annotations

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.io import avi, jpeg, mjpeg, yuv
from sleap_tpu_torch.io import video as tvideo

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "avi"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]
CV2_UNREADABLE = {"bgr24_bottomup_37x29.avi"}  # cv2 corrupts its heap on these frames
REFUSED = {"opencv_mjpeg_37x29.avi": "odd height"}  # swscale's scaler: not modelled
SMALL = sorted(n for n in MANIFEST if n != "gray_1024.avi")


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reader(name) -> avi.AviReader:
    return avi.AviReader(avi.AviVideo.open(str(FIXTURES / name)), "cpu")


def random_order(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_demuxer_count_fps_and_frames_equal_cv2(name):
    want = MANIFEST[name]
    video = avi.AviVideo.open(str(FIXTURES / name))
    assert (video.frames, video.fps, len(video.offsets)) == (want["frames"], want["fps"],
                                                            want["readable"])
    assert video.index == {"opendml_100x72.avi": "indx", "noidx1_64x48.avi": "movi"}.get(name, "idx1")
    with open(video.filename, "rb") as f:
        with pytest.raises(KeyError, match="Unable to load frame"):
            video.read(f, want["readable"])


@pytest.mark.parametrize("name", SMALL)
def test_card_route_frames_equal_the_recorded_cv2_frames(name):
    want = MANIFEST[name]
    r = reader(name)
    if name in REFUSED:
        with pytest.raises(NotImplementedError, match=REFUSED[name] + ".*ROADMAP.md item 3g"):
            r.frame(0)
        return
    for i in list(range(want["readable"])) + random_order(want["readable"]):
        assert sha(r.frame(i, "bgr").numpy()) == want["bgr"][i], (name, i)
        assert sha(r.frame(i, "b").numpy()[..., 0]) == want["gray"][i], (name, i)
    with pytest.raises(KeyError):
        r.frame(want["readable"])


def test_the_1024_clip_equals_the_recorded_cv2_frames():
    want = MANIFEST["gray_1024.avi"]
    r = reader("gray_1024.avi")
    assert r.codec == "mjpeg" and (r.demux.width, r.demux.height) == (1024, 1024)
    for i in (0, 5, 7, 2):
        assert sha(r.frame(i, "b").numpy()[..., 0]) == want["gray"][i]


@pytest.fixture
def card_route(monkeypatch):
    """``MediaVideo(device="cuda")``'s reader built on the CPU: the card's
    route with the plain versions."""
    made, card_reader = [], tvideo._card_reader

    def build(filename, device):
        assert torch.device(device).type == "cuda"
        made.append(card_reader(filename, "cpu"))
        return made[-1]

    monkeypatch.setattr(tvideo, "_card_reader", build)
    return made


@pytest.mark.parametrize("name", [n for n in SMALL if n not in CV2_UNREADABLE | set(REFUSED)
                                  and n != "idct_probe.avi"])
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
    assert isinstance(card_route[0], avi.AviReader)


def test_written_frames_of_the_file_cv2_cannot_read(card_route):
    """Bottom-up 24-bit frames come out as their 32-bit twins do in cv2."""
    name = "bgr24_bottomup_37x29.avi"
    video = tvideo.MediaVideo(str(FIXTURES / name), bgr=False)
    twin = jvideo.MediaVideo(filename=str(FIXTURES / "bgra32_37x29.avi"), bgr=False)
    for i in range(6):
        np.testing.assert_array_equal(video.get_frame(i), twin.get_frame(i))
        assert sha(video.get_frame(i)) == MANIFEST[name]["bgr"][i]


def test_zero_length_chunks_are_dropped_frames_as_in_cv2(card_route):
    path = str(FIXTURES / "zero_chunks_64x48.avi")
    mine, ref = tvideo.MediaVideo(path), jvideo.MediaVideo(filename=path)
    assert mine.frames == ref.frames == 11 and MANIFEST["zero_chunks_64x48.avi"]["readable"] == 8
    for i in (8, 10):
        for video in (mine, ref):
            with pytest.raises(KeyError, match=f"Unable to load frame {i}"):
                video.get_frame(i)


# --------------------------------------------------------------------------- #
# swscale's conversions on every (Y, U) and (Y, V) pair
# --------------------------------------------------------------------------- #

SAMPLING = {"420": ((2, 2), 2, 2), "422": ((2, 1), 1, 2), "444": ((1, 1), 1, 1)}


def seg(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def constant_blocks_jpeg(y, u, v, sampling, itu) -> bytes:
    """A baseline JPEG whose every block is one value (a DC-only block of
    DC 8 v - 1024 under a table of ones decodes to v exactly): ``y`` per
    luma block, ``u`` and ``v`` per chroma block, as (rows, cols) arrays."""
    (h, vv), _, _ = SAMPLING[sampling]
    comps = [jpeg.Component(1, h, vv, 0, 0, 0, y.shape[1], y.shape[0], 0),
             jpeg.Component(2, 1, 1, 0, 0, 0, u.shape[1], u.shape[0], y.size),
             jpeg.Component(3, 1, 1, 0, 0, 0, v.shape[1], v.shape[0], y.size + u.size)]
    frame = jpeg.Frame(8 * y.shape[0], 8 * y.shape[1], comps, u.shape[1], u.shape[0])
    coefs = np.zeros((y.size + u.size + v.size, 64), np.int16)
    coefs[:, 0] = 8 * np.concatenate([y.ravel(), u.ravel(), v.ravel()]).astype(np.int16) - 1024
    sof = struct.pack(">BHHB", 8, frame.height, frame.width, 3) + b"".join(
        bytes([c.ident, c.h << 4 | c.v, 0]) for c in comps)
    head = b"\xff\xd8" + (seg(0xFE, b"CS=ITU601\0") if itu else b"") + seg(0xDB, bytes(1) + bytes([1]) * 64) \
        + seg(0xC0, sof) + seg(0xC4, b"\x00" + jpeg.STD_HUFFMAN[0]) + seg(0xC4, b"\x10" + jpeg.STD_HUFFMAN[1]) \
        + seg(0xDA, b"\x03\x01\x00\x02\x00\x03\x00\x00\x3f\x00")
    return head + jpeg.encode_scan_plain(coefs, frame) + b"\xff\xd9"


@pytest.mark.parametrize("sampling", ["420", "422", "444"])
@pytest.mark.parametrize("itu", [False, True], ids=["full", "limited"])
def test_yuv_rules_equal_cv2_on_every_pair(sampling, itu, tmp_path):
    """Every U (and V = 255 - U) under every Y: each chroma block spans as
    many luma blocks as its sampling gives (4, 2 or 1), so the frame is
    laid out for 256 x 256 pairs."""
    _, rows, cols = SAMPLING[sampling]
    per = rows * cols  # luma blocks under one chroma block
    n_chroma = 256 * 256 // per
    width = 128 if per > 1 else 256  # chroma blocks a row
    c = (np.arange(n_chroma) // (256 // per)).reshape(-1, width).astype(np.uint8)
    y = np.zeros((c.shape[0] * rows, width * cols), np.uint8)
    k = (np.arange(n_chroma) % (256 // per)).reshape(c.shape) * per
    for dy in range(rows):
        for dx in range(cols):
            y[dy::rows, dx::cols] = k + dy * cols + dx
    data = constant_blocks_jpeg(y, c, 255 - c, sampling, itu)
    path = str(tmp_path / "sweep.avi")
    with avi.AviWriter(path, 8 * y.shape[1], 8 * y.shape[0], 25) as w:
        w.add(data)
    ok, got = cv2.VideoCapture(path, cv2.CAP_FFMPEG).read()
    assert ok
    frame = mjpeg.parse_frame(data)
    assert frame.sampling == sampling and frame.full_range is not itu
    planes = [torch.from_numpy(np.kron(p, np.ones((8, 8), np.uint8))) for p in (y, c, 255 - c)]
    want = yuv.to_bgr(*planes, sampling=sampling, full_range=not itu).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(mjpeg.decode(data, "cpu").numpy(), got)
    np.testing.assert_array_equal(yuv.to_bgr(*planes, sampling, not itu, "b").numpy()[..., 0],
                                  got[..., 0])


# --------------------------------------------------------------------------- #
# The IDCT and the refusals
# --------------------------------------------------------------------------- #


def test_idct_plain_is_the_simple_idct_on_hand_blocks():
    """A DC-only block is flat; the rows' DC shortcut and 16-bit saturation
    and the columns' 16-bit rounding show on blocks that overflow."""
    coefs = torch.zeros((3, 64), dtype=torch.int16)
    coefs[0, 0] = 8 * 200 - 1024
    coefs[1, 1] = -4080  # a row that saturates, then columns whose DC wraps
    coefs[1, 0] = 1008 - 1024
    coefs[2, 0] = 1000
    out = mjpeg.idct_plain(coefs, torch.ones((1, 64), dtype=torch.int32), torch.zeros(3, dtype=torch.long))
    assert (out[0] == 200).all()
    assert out[1, :, 4].eq(255).all() and out[1].sum() == 8 * 255  # cv2's decode of this block
    assert (out[2] == 16383 * (8 * 2024 + 32) >> 20).all()  # the DC shortcut, then W4


def test_other_codecs_formats_and_frames_raise_naming_them(tmp_path):
    # cv2's mp4v AVI is MPEG-4 Part 2, read on the card's route as cv2 reads
    # it (tests/test_torch_mpeg4.py); cv2's FFV1 AVI is refused naming it.
    path = str(tmp_path / "mpeg4.avi")
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for _ in range(3):
        writer.write(np.zeros((32, 32, 3), np.uint8))
    writer.release()
    mpeg4_reader = avi.AviReader(avi.AviVideo.open(path), "cpu")
    assert mpeg4_reader.codec == "mpeg4"
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG)
    for i in range(3):
        ok, want = cap.read()
        assert ok and np.array_equal(mpeg4_reader.frame(i).numpy(), want), i
    cap.release()
    path = str(tmp_path / "ffv1.avi")
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 10, (32, 32))
    for _ in range(3):
        writer.write(np.zeros((32, 32, 3), np.uint8))
    writer.release()
    with pytest.raises(NotImplementedError, match="codec 'FFV1'.*ROADMAP.md item 3g"):
        avi.AviReader(avi.AviVideo.open(path), "cpu")
    base = (FIXTURES / "cv2_mjpg_100x72.avi").read_bytes()
    for fourcc, bits, what in ((b"\0\0\0\0", 16, "16-bit uncompressed"), (b"H264", 24, "'H264'")):
        at = base.index(b"strf") + 8
        patched = bytearray(base)
        patched[at + 14:at + 20] = struct.pack("<H4s", bits, fourcc)
        (tmp_path / "x.avi").write_bytes(bytes(patched))
        with pytest.raises(NotImplementedError, match=what):
            avi.AviReader(avi.AviVideo.open(str(tmp_path / "x.avi")), "cpu")
    data = avi.read_frames(str(FIXTURES / "cv2_mjpg_100x72.avi"))[0]
    with pytest.raises(NotImplementedError, match="Interlaced Motion-JPEG"):
        mjpeg.parse_frame(data, container_height=144)
    with pytest.raises(NotImplementedError, match="comment b'AVID"):
        mjpeg.parse_frame(data[:2] + seg(0xFE, b"AVID\0") + data[2:])
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(NotImplementedError, match="12-bit"):
        mjpeg.decode(twelve, "cpu")
    with pytest.raises(FileNotFoundError):
        avi.AviVideo.open(str(tmp_path / "missing.avi"))


def test_card_route_picks_the_reader_by_leading_bytes(tmp_path, card_route):
    renamed = tmp_path / "clip.mp4"
    renamed.write_bytes((FIXTURES / "pil_gray_100x72.avi").read_bytes())
    video = tvideo.Video.from_filename(str(renamed))
    assert video.shape == (6, 72, 100, 1)
    assert isinstance(card_route[-1], avi.AviReader)
    assert sha(video.get_frame(3)[..., 0]) == MANIFEST["pil_gray_100x72.avi"]["gray"][3]


def test_card_route_never_falls_back_to_cv2(monkeypatch):
    """On a machine without a card the default device raises from torch
    (its pinned staging buffer), with cv2 absent or present: no frame comes
    from cv2, and the header reads without it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    video = tvideo.MediaVideo(str(FIXTURES / "pil_gray_100x72.avi"))
    assert video.frames == 6 and video.fps == 25.0
    with pytest.raises(RuntimeError, match="pin_memory"):
        video.get_frame(0)


# --------------------------------------------------------------------------- #
# The slice: sleap-track's top-down pair on decoded AVI frames
# --------------------------------------------------------------------------- #


def test_trained_topdown_pair_on_avi_frames_matches_jax(card_route):
    """The trained pair (``.convergence_runs``) on the first two frames of
    the 1024^2 clip: the port's card route (plain versions) against the JAX
    package's frames and predictor."""
    import jax

    from sleap_tpu.inference import predictors as jp
    from sleap_tpu_torch.inference import predictors as tp

    runs = Path(__file__).resolve().parent.parent / ".convergence_runs"
    centroid = str(runs / "minimal_instance.UNet.centroid")
    instance = str(runs / "minimal_instance.UNet.centered_instance")
    path = str(FIXTURES / "gray_1024.avi")
    mine = np.stack([tvideo.MediaVideo(path).get_frame(i) for i in (0, 1)])
    ref = np.stack([jvideo.MediaVideo(filename=path).get_frame(i) for i in (0, 1)])
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
