"""QuickTime/ISO-BMFF and Matroska files on the port's card route
(``io/mp4.py``'s and ``io/mkv.py``'s demuxers, ``io/mjpeg.py``'s
``MotionJpegReader``, the NVDEC reader, ``MediaVideo``), run here on the CPU
with the plain versions (the plain Huffman decoder and J5's plain version)
and, for H.264, ``tests/test_torch_media.py``'s stand-in for libnvcuvid.

The fixtures are ``tests/torch_data/containers``
(``scripts/make_torch_container_fixtures.py``), whose ``manifest.json``
records what OpenCV's FFmpeg backend reads from each. Held here, bit for bit
(tolerance 0):

- each demuxer's frame count, fps and readable frames equal cv2's on every
  fixture: edit lists (a trimmed start, an empty edit, two edits, version
  1, an edit between sync samples, on Motion-JPEG and H.264, and under
  ``ctts`` composition offsets on Motion-JPEG), Matroska with and without
  Cues, BlockGroups, unknown-size clusters, header stripping,
  the three lacings, ``V_MS/VFW/FOURCC``, a ``Duration`` one frame short of
  the frames and none at all;
- every frame, in order and at random, equals the recorded cv2 frame (BGR
  and the blue channel), and ``MediaVideo``'s card route equals the JAX
  package's ``MediaVideo.get_frame`` live, colour and gray, RGB and BGR;
  the H.264 packets of the Matroska and the trimmed ``.mp4`` files are the
  ``.mp4`` route's Annex-B bytes of the same samples, and decode through
  the stand-in to the JAX package's frames;
- the edit list changes the frames: without it (the parent's ordering by
  decoding time plus ``ctts`` alone) frame 0 of a trimmed file would be
  the untrimmed file's frame 0, where cv2 reads its frame 2;
- the route is picked by content, whatever the extension, and what the
  card does not read raises naming it and ``--video.device cpu``;
- the trained top-down pair on the ``.mov`` and ``.mkv`` clips against the
  JAX predictor on cv2's frames, within ``tests/test_torch_avi.py``'s
  tolerances (0.01 px for points, 1e-4 for values).

A Motion-JPEG frame is decoded once per distinct byte string here (most
fixtures hold the same JPEGs in other containers): :func:`mjpeg.decode` is a
function of its bytes, and its decoding is held by ``tests/test_torch_avi.py``.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.io import avi, mjpeg, mkv, mp4
from sleap_tpu_torch.io import video as tvideo

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_data" / "containers"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())["files"]
sys.path.insert(0, str(REPO / "scripts"))
import make_torch_container_fixtures as fixtures  # noqa: E402

H264 = sorted(n for n in MANIFEST if n.startswith("h264"))
CLIPS = ("gray_1024.mov", "gray_1024.mkv")
MJPEG = sorted(n for n in MANIFEST if n not in H264 and n not in CLIPS)
SEEK_DIFFERS = {n for n, rec in MANIFEST.items() if "seek" in rec}


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def random_order(n, seed=0):
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


def demuxer(name):
    path = str(FIXTURES / name)
    with open(path, "rb") as f:
        kind = tvideo.container_of(f.read(12))
    return {"avi": avi.AviVideo, "matroska": mkv.MkvVideo, "isobmff": mp4.Mp4Video}[kind].open(path)


@pytest.fixture(scope="module")
def decoded():
    """``mjpeg.decode``'s frames by its arguments, across this file's tests."""
    return {}


@pytest.fixture(autouse=True)
def decode_once(monkeypatch, decoded):
    """``mjpeg.decode`` memoised by its arguments."""
    decode = mjpeg.decode

    def memo(data, device="cuda", channels="bgr", container_height=None):
        key = (bytes(data), str(device), channels, container_height)
        if key not in decoded:
            decoded[key] = decode(data, device, channels, container_height)
        return decoded[key].clone()

    monkeypatch.setattr(mjpeg, "decode", memo)


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


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_demuxer_count_fps_and_readable_frames_equal_cv2(name):
    want = MANIFEST[name]
    video = demuxer(name)
    readable = len(video.offsets) if isinstance(video, avi.AviVideo) else video.readable
    assert (video.frames, video.fps, readable) == (want["frames"], want["fps"], want["readable"])
    with open(video.filename, "rb") as f:
        with pytest.raises(KeyError, match="Unable to load frame"):
            video.read(f, want["readable"])


def test_matroska_index_from_cues_or_a_walk():
    """A file with Cues and the same file without them index the same
    frames: the clusters are found by a walk of the segment either way."""
    cued, walk = demuxer("cv2_mjpg_100x72.mkv"), demuxer("nocues_100x72.mkv")
    np.testing.assert_array_equal(cued.sizes, walk.sizes)
    with open(cued.filename, "rb") as a, open(walk.filename, "rb") as b:
        assert [cued.read(a, i) for i in range(6)] == [walk.read(b, i) for i in range(6)]


@pytest.mark.parametrize("name", MJPEG)
def test_card_route_frames_equal_the_recorded_cv2_frames(name):
    want = MANIFEST[name]
    r = tvideo._card_reader(str(FIXTURES / name), "cpu")
    assert isinstance(r, avi.AviReader if name == "avi_named.mkv" else mjpeg.MotionJpegReader)
    for i in list(range(want["readable"])) + random_order(want["readable"]):
        assert sha(r.frame(i, "bgr").numpy()) == want["bgr"][i], (name, i)
        assert sha(r.frame(i, "b").numpy()[..., 0]) == want["gray"][i], (name, i)
    with pytest.raises(KeyError):
        r.frame(want["readable"])
    r.close()


@pytest.mark.parametrize("name", [n for n in MJPEG if n not in SEEK_DIFFERS])
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


def test_cv2_does_not_seek_a_matroska_file_without_duration(card_route):
    """Without ``Duration`` cv2 counts FFmpeg's unset duration as frames
    (a large negative count), clamps a seek to it and does not move: a read
    after a seek gives the frame after the last one read. The port gives
    the frame at that index (ROADMAP.md queue 3, item 5)."""
    name = "live_100x72.mkv"
    path = str(FIXTURES / name)
    mine = tvideo.MediaVideo(path, grayscale=False, bgr=False)
    ref = jvideo.MediaVideo(filename=path, grayscale=False, bgr=False)
    assert mine.frames == ref.frames == MANIFEST[name]["frames"] < 0
    for i in range(6):
        np.testing.assert_array_equal(mine.get_frame(i), ref.get_frame(i))
    seeks = MANIFEST[name]["seek"]
    ref.reset(grayscale=False)
    for k, i in enumerate(random_order(6)):  # each read at random gives cv2's next frame
        assert sha(ref.get_frame(i)) == MANIFEST[name]["bgr"][k] == seeks[str(i)]
        assert sha(mine.get_frame(i)) == MANIFEST[name]["bgr"][i]


def test_the_clips_hold_the_avi_clips_jpegs():
    """``gray_1024.mov`` and ``.mkv`` hold ``gray_1024.avi``'s JPEG bytes, so
    cv2 reads the same frames from all three."""
    avi_dir = REPO / "tests" / "torch_data" / "avi"
    want = fixtures.read_payloads(str(avi_dir / "gray_1024.avi"))
    avi_record = json.loads((avi_dir / "manifest.json").read_text())["files"]["gray_1024.avi"]
    for name in CLIPS:
        assert fixtures.read_payloads(str(FIXTURES / name)) == want
        assert MANIFEST[name]["bgr"] == avi_record["bgr"]
        r = tvideo._card_reader(str(FIXTURES / name), "cpu")
        assert (r.demux.width, r.demux.height) == (1024, 1024)
        assert sha(r.frame(3, "b").numpy()[..., 0]) == MANIFEST[name]["gray"][3]


def test_edit_lists_change_the_frames():
    """A trimmed start gives the untrimmed file's frames from frame 2, in
    cv2 and on the card's route; the parent's ordering (decoding time plus
    ``ctts``, the edit list ignored) gives sample 0 first."""
    for trimmed, whole in (("elst_trim2_100x72.mov", "cv2_mjpg_100x72.mov"),
                           ("elst_v1_trim2_100x72.mov", "cv2_mjpg_100x72.mov"),
                           ("h264_elst_trim2_64x48.mp4", "h264_64x48.mp4")):
        t, w = MANIFEST[trimmed], MANIFEST[whole]
        assert t["bgr"] == w["bgr"][2:] and t["frames"] == w["frames"] == len(w["bgr"])
        video = demuxer(trimmed)
        ignored = np.argsort(video.dts + video.cts, kind="stable")
        assert ignored[0] == 0 and video.packets[video.order[0]] == 2
        assert t["bgr"][0] != w["bgr"][0]
    two = demuxer("elst_two_100x72.mov")
    assert two.packets[two.order].tolist() == [0, 1, 3, 4, 5]
    between = demuxer("elst_between_sync_100x72.mov")
    # from the sync sample before the edit to the last sample: none after it is a sync sample
    assert between.packets.tolist() == [0, 1, 2, 3, 4, 5]
    assert between.rank.tolist() == [-1, -1, 0, 1, 2, -1]
    h = demuxer("h264_elst_trim2_64x48.mp4")  # decoding starts at the IDR before the edit
    assert h.sync_before(0) == 0 and h.rank[:3].tolist() == [-1, -1, 0]


def test_edit_lists_under_ctts_follow_cv2():
    """Under ``ctts`` an edit starts at the last sync sample presented at or
    before its media time. In ``ctts_between_sync`` sample 3 is decoded
    before the edit's start (frame 3) but presented after it, so decoding
    starts at sample 0 and cv2 reads samples 1-4; the rule without ``ctts``
    would start at sample 3. B-frame-like offsets keep the samples presented
    inside the edit, in decoding order (Motion-JPEG does not reorder)."""
    whole = MANIFEST["cv2_mjpg_100x72.mov"]["bgr"]
    for name, samples in (("ctts_shift_100x72.mov", [0, 1, 2, 3, 4, 5]),
                          ("ctts_between_sync_100x72.mov", [1, 2, 3, 4]),
                          ("ctts_reordered_100x72.mov", [1, 3, 4, 5])):
        video = demuxer(name)
        assert video.has_ctts and video.cts.any()
        assert MANIFEST[name]["bgr"] == [whole[k] for k in samples]
        assert video.packets[video.order].tolist() == samples
    v = demuxer("ctts_between_sync_100x72.mov")
    pts, media_time = v.dts + v.cts, v.edits[0][1]
    assert mp4._edit_start(v.dts, pts, v.sync, True, media_time) == 0
    assert mp4._edit_start(v.dts, pts, v.sync, False, media_time) == 3


def test_edit_list_rules_by_hand():
    """``edit_packets`` on hand tables: a repeated edit, an edit between
    sync samples with ``ctts`` (to the second sync sample after its end),
    an empty edit only, and media durations rescaled from the movie's
    timescale with rounding."""
    dts = np.arange(8) * 10
    sync = np.array([1, 0, 0, 1, 0, 0, 1, 0], bool)
    packets, keep, edit = mp4.edit_packets(dts, dts, sync, False, [(3, 0), (3, 0)], 10, 1)
    assert packets.tolist() == [0, 1, 2, 3, 0, 1, 2, 3] and keep.tolist() == [1, 1, 1, 0] * 2
    assert edit.tolist() == [0] * 4 + [1] * 4
    packets, keep, _ = mp4.edit_packets(dts, dts + 10, sync, True, [(2, 25)], 10, 1)
    assert packets.tolist() == [0, 1, 2, 3, 4, 5, 6] and keep.tolist() == [0, 0, 1, 1, 0, 0, 0]
    assert mp4.edit_packets(dts, dts, sync, False, [(5, -1)], 10, 1)[0].tolist() == []
    assert mp4.av_rescale(5, 10, 4) == 13 and mp4.av_rescale(-5, 10, 4) == -13
    assert mp4.av_reduce(1000000000, 33333333, 30000) == (30, 1)
    assert mp4.av_reduce(1000000000, 41708333, 30000) == (24000, 1001)


# --------------------------------------------------------------------------- #
# H.264 in Matroska and under an edit list, through the stand-in NVDEC
# --------------------------------------------------------------------------- #


def test_h264_packets_are_the_mp4_routes_annexb_bytes():
    base = demuxer("h264_64x48.mp4")
    with open(base.filename, "rb") as f:
        samples = [base.read_sample(f, k) for k in range(base.samples)]
    for name in ("h264_64x48.mkv", "h264_elst_trim2_64x48.mp4"):
        video = demuxer(name)
        assert video.kind == "h264" and (video.width, video.height) == fixtures.H264_SIZE
        assert (video.sps, video.pps) == (base.sps, base.pps)
        with open(video.filename, "rb") as f:
            for k, s in enumerate(video.packets):
                first = k == video.sync_before(max(0, int(video.rank[k])))
                assert video.to_annexb(video.read_packet(f, k), first) == \
                    base.to_annexb(samples[s], first), (name, k)
        assert video.sync.tolist() == base.sync.tolist()


@pytest.fixture
def stand_in_nvdec(monkeypatch):
    """The fixtures' NVDEC reader on the CPU against
    ``tests/test_torch_media.py``'s stand-in libnvcuvid."""
    import test_torch_media as media
    from sleap_tpu_torch.io import nvdec

    planes, (sps, pps, slices, sync) = fixtures.h264_planes()
    fake = media.FakeNvcuvid(sps, slices, planes)

    class HostReader(nvdec.NvdecReader):
        def __init__(self, demux, device="cuda"):
            super().__init__(demux, device="cpu")

        def _stream_handle(self):
            return None

        def _plane(self, ptr, rows, cols, pitch):
            import ctypes

            buf = (ctypes.c_ubyte * (pitch * rows)).from_address(ptr)
            return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(rows, pitch)[:, :cols])

    monkeypatch.setattr(nvdec, "_PrimaryContext", media.FakeContext)
    monkeypatch.setitem(nvdec._LIBS, "cuda", media.FakeCuda())
    monkeypatch.setitem(nvdec._LIBS, "nvcuvid", fake)
    monkeypatch.setattr(nvdec, "NvdecReader", HostReader)
    return fake


@pytest.mark.parametrize("name", H264)
def test_h264_fixtures_through_the_stand_in_equal_cv2(name, stand_in_nvdec):
    from sleap_tpu_torch.io import nvdec

    want = MANIFEST[name]
    path = str(FIXTURES / name)
    mine = tvideo.MediaVideo(path, grayscale=False, bgr=False)
    ref = jvideo.MediaVideo(filename=path, grayscale=False, bgr=False)
    assert (mine.frames, mine.fps) == (ref.frames, ref.fps) == (want["frames"], want["fps"])
    n = want["readable"]
    for i in list(range(n)) + random_order(n, 2):
        frame = mine.get_frame(i)
        np.testing.assert_array_equal(frame, ref.get_frame(i), err_msg=f"{name} {i}")
        assert sha(frame) == want["bgr"][i]
    with pytest.raises(KeyError, match=f"frame {n}"):
        mine.get_frame(n)
    fed = [ts for flags, ts in stand_in_nvdec.packets if not flags & nvdec.PKT_ENDOFSTREAM]
    if name == "h264_elst_trim2_64x48.mp4":  # the IDR and the frame after it, decoded and dropped
        assert fed[:3] == [-1, -1, 0]


# --------------------------------------------------------------------------- #
# Routing by content, and what the card does not read
# --------------------------------------------------------------------------- #


def test_route_by_content_whatever_the_extension(tmp_path, card_route):
    """cv2 reads a file by its content; so does the card's route (the parent
    sent an AVI named ``.mkv`` or ``.mj2`` to the MP4 demuxer, and refused an
    ISO-BMFF file not named ``.mp4``/``.mov``)."""
    cases = {"clip.mj2": "avi_named.mkv", "clip.mkv": "cv2_mjpg_100x72.mov",
             "clip.avi": "nocues_100x72.mkv", "clip.mov": "matroska_named.mov"}
    for renamed, name in cases.items():
        shutil.copyfile(FIXTURES / name, tmp_path / renamed)
        video = tvideo.MediaVideo(str(tmp_path / renamed), grayscale=False, bgr=False)
        assert sha(video.get_frame(1)) == MANIFEST[name]["bgr"][1]
    kinds = [type(r).__name__ + ":" + type(r.demux).__name__ for r in card_route]
    assert kinds == ["AviReader:AviVideo", "MotionJpegReader:Mp4Video",
                     "MotionJpegReader:MkvVideo", "MotionJpegReader:MkvVideo"]
    assert tvideo.container_of(b"\0\0\0\x14ftypqt  ") == "isobmff"
    assert tvideo.container_of(b"\0\0\0\x08wide\0\0\0\0") == "isobmff"
    assert tvideo.container_of(b"RIFF\0\0\0\0WAVE") is None


def retag(name, old, new, tmp_path, out):
    data = (FIXTURES / name).read_bytes()
    assert data.count(old) >= 1
    (tmp_path / out).write_bytes(data.replace(old, new, 1))
    return str(tmp_path / out)


def test_what_the_card_does_not_read_raises_naming_it(tmp_path):
    mov = "cv2_mjpg_100x72.mov"
    cases = [
        (retag(mov, b"jpeg", b"mjpb", tmp_path, "b.mov"), "'mjpb'"),
        (retag(mov, b"jpeg", b"mjp2", tmp_path, "c.mj2"), "Motion JPEG 2000"),
        # ContentCompAlgo 3 (header stripping) -> 0 (zlib), and 5 (encryption)
        (retag("header_stripping_100x72.mkv", b"\x42\x54\x81\x03", b"\x42\x54\x81\x00", tmp_path,
               "z.mkv"), "compressed with zlib"),
        (retag("header_stripping_100x72.mkv", b"\x50\x33\x81\x00", b"\x50\x33\x81\x01", tmp_path,
               "e.mkv"), "encrypted"),
        (retag("cv2_mjpg_100x72.mkv", b"V_MJPEG", b"V_THEOR", tmp_path, "t.mkv"), "'V_THEOR'"),
        (retag("cv2_mjpg_100x72.mkv", b"matroska", b"notmatro", tmp_path, "d.mkv"), "DocType"),
        (retag("vfw_mjpg_100x72.mkv", b"MJPG", b"H264", tmp_path, "v.mkv"), "fourcc 'H264'"),
    ]
    # cv2's mp4v .mov is MPEG-4 Part 2, read as cv2 reads it
    # (tests/test_torch_mpeg4.py); cv2's FFV1 .mkv is refused naming it.
    path = str(tmp_path / "mp4v.mov")
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for _ in range(3):
        writer.write(np.zeros((32, 32, 3), np.uint8))
    writer.release()
    cap, route = cv2.VideoCapture(path, cv2.CAP_FFMPEG), tvideo._card_reader(path, "cpu")
    for i in range(3):
        ok, want = cap.read()
        assert ok and np.array_equal(route.frame(i).numpy(), want), i
    cap.release()
    path = str(tmp_path / "ffv1.mkv")
    writer = cv2.VideoWriter(path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"FFV1"), 10, (32, 32))
    for _ in range(3):
        writer.write(np.zeros((32, 32, 3), np.uint8))
    writer.release()
    cases.append((path, "FFV1"))
    no_rate = tmp_path / "rate.mkv"
    no_rate.write_bytes(fixtures.mkv_bytes(fixtures.read_payloads(str(FIXTURES / "nocues_100x72.mkv")),
                                           [100 * k for k in range(6)], 100, 72, default_duration=0))
    cases.append((str(no_rate), "without DefaultDuration"))
    (tmp_path / "x.mkv").write_bytes(b"RIFF" + bytes(60))
    cases.append((str(tmp_path / "x.mkv"), "leading bytes"))
    for path, what in cases:
        with pytest.raises(NotImplementedError, match=f"{what}.*--video.device cpu"):
            tvideo._card_reader(path, "cpu")
    elst = b"elst" + bytes(4) + (1).to_bytes(4, "big")
    rate = retag(mov, elst, elst, tmp_path, "r.mov")
    data = bytearray(Path(rate).read_bytes())
    at = data.index(elst) + len(elst) + 8
    data[at:at + 4] = b"\x00\x02\x00\x00"  # an edit at rate 2
    Path(rate).write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="rate 2.0"):
        mp4.Mp4Video.open(rate)
    with pytest.raises(ValueError, match="not an EBML"):
        mkv.MkvVideo.open(str(FIXTURES / mov))


def test_card_route_never_falls_back_to_cv2(monkeypatch):
    """Without a card the default device raises from torch (its pinned
    staging buffer), with cv2 blocked: no frame comes from cv2, and the
    headers read without it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("cv2_mjpg_100x72.mov", "cv2_mjpg_100x72.mkv"):
        video = tvideo.MediaVideo(str(FIXTURES / name))
        assert video.frames == 6 and video.fps == 10.0
        with pytest.raises(RuntimeError, match="pin_memory"):
            video.get_frame(0)


# --------------------------------------------------------------------------- #
# The slice: sleap-track's top-down pair on the .mov and .mkv clips
# --------------------------------------------------------------------------- #


def test_trained_topdown_pair_on_mov_and_mkv_frames_matches_jax(card_route):
    """The trained pair (``.convergence_runs``) on frame 0 of ``gray_1024.mov``
    and frame 1 of ``gray_1024.mkv``: the port's card route (plain versions)
    against the JAX package's frames (cv2) and predictor, points within
    0.01 px and values within 1e-4, as ``tests/test_torch_avi.py`` holds
    the AVI clip."""
    import jax

    from sleap_tpu.inference import predictors as jp
    from sleap_tpu_torch.inference import predictors as tp

    runs = REPO / ".convergence_runs"
    centroid = str(runs / "minimal_instance.UNet.centroid")
    instance = str(runs / "minimal_instance.UNet.centered_instance")
    picks = ((CLIPS[0], 0), (CLIPS[1], 1))
    mine = np.stack([tvideo.MediaVideo(str(FIXTURES / n)).get_frame(i) for n, i in picks])
    ref = np.stack([jvideo.MediaVideo(filename=str(FIXTURES / n)).get_frame(i) for n, i in picks])
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
