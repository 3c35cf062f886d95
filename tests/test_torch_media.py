"""H.264 ``.mp4`` reading in the port: the MP4 demuxer
(``sleap_tpu_torch.io.mp4``), the colour conversion (``io/yuv.py``) and the
card route of ``MediaVideo`` (``io/video.py``), on the CPU.

The fixtures come from ``scripts/write_h264_fixture.py``, whose decoded
frames are the written planes exactly. Held here:

- the demuxer's sample table equals the writer's (``stco``/``co64``,
  multi-entry ``stsc`` with bytes between chunks, ``stss``, ``ctts`` of
  versions 0 and 1, NAL length sizes 1, 2 and 4), and its frame count, fps
  and size equal the JAX ``MediaVideo``'s (cv2);
- its Annex-B output, written as a raw ``.h264``, decodes in cv2 to the
  ``.mp4``'s frames, from the start and from a mid-stream sync sample: the
  bytes NVDEC's parser is given;
- ``yuv.py`` equals cv2's conversion of ``.y4m`` planes bitwise (tolerance 0)
  on every (Y, U) and (Y, V) pair and on random planes, and the JAX
  ``MediaVideo``'s frames of the H.264 fixtures, gray and colour, bitwise;
- ``device="cuda"`` (the default) never falls back to cv2: without NVDEC
  it raises naming it, and other codecs (an AVI of MPEG-4 among them; AVI
  of Motion-JPEG or raw frames is read, ``tests/test_torch_avi.py``),
  formats and containers raise naming them; the device reaches every reader and is not written to
  ``.slp`` files;
- the NVDEC reader's logic (timestamps, seeking from sync samples, the
  NV12 surface's chroma offset and pitch, errors from the callbacks,
  reads from another thread) against a stand-in for libnvcuvid that
  decodes the writer's slices by content, and ``MediaVideo``'s card route
  through it against the JAX ``MediaVideo``, bitwise.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.core.instance import LabeledFrame
from sleap_tpu_torch.core.labels import Labels, load_file
from sleap_tpu_torch.data.providers import VideoReader
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.io import mp4, yuv
from sleap_tpu_torch.io import video as tvideo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import write_h264_fixture as writer  # noqa: E402

N = 12
MEDIA_SEEK_ORDER = (0, 7, 3, 3, 11, 1)  # chip_smoke.py phase 12a's seeking reads


def read_all(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def planes_of(seed=0, gray=False, width=100, height=72):
    return writer.moving_planes(N, width, height, seed=seed, gray=gray)


def want_frames(planes, channels):
    return yuv.yuv420_to_bgr(*(torch.from_numpy(p) for p in planes), channels=channels).numpy()


CONTAINERS = {
    "stco": {},
    "co64": {"co64": True},
    "chunks": {"chunks": [3, 3, 2, 4]},
    "co64+chunks+ctts": {"co64": True, "chunks": [5, 5, 1, 1], "ctts": [1] * N},
    "nal2": {"nal_length_size": 2},
    "reordered ctts v1": {"ctts": [0, 2, -1] * (N // 3)},
}


@pytest.mark.parametrize("name", list(CONTAINERS))
@pytest.mark.parametrize("idr_every", [0, 4])
def test_demuxer_reads_the_written_table(name, idr_every, tmp_path):
    path = str(tmp_path / "clip.mp4")
    table = writer.write_h264_mp4(path, *planes_of(), idr_every=idr_every, **CONTAINERS[name])
    m = mp4.Mp4Video.open(path)
    np.testing.assert_array_equal(m.sizes, table["sizes"])
    np.testing.assert_array_equal(m.offsets, table["offsets"])
    np.testing.assert_array_equal(m.sync, table["sync"])
    np.testing.assert_array_equal(m.cts, table["ctts"])
    np.testing.assert_array_equal(m.dts, np.arange(N) * table["delta"])
    assert (m.codec, m.frames, m.width, m.height, m.fps) == ("avc1", N, 100, 72, 30.0)
    assert m.nal_length_size == CONTAINERS[name].get("nal_length_size", 4)
    pts = m.dts + m.cts
    assert np.all(np.diff(pts[m.order]) >= 0) and sorted(m.order) == list(range(N))
    np.testing.assert_array_equal(m.rank[m.order], np.arange(N))
    syncs = np.flatnonzero(table["sync"])
    for i in range(N):
        assert m.sync_before(i) == syncs[syncs <= m.order[i]][-1]


def annexb(m, start):
    """The Annex-B bytes of the samples from decoding index ``start`` (a
    sync sample) on, as ``NvdecReader`` feeds them to NVDEC's parser."""
    with open(m.filename, "rb") as f:
        return [m.to_annexb(m.read_sample(f, k), k == start) for k in range(start, m.frames)]


def test_nal_length_size_1(tmp_path):
    """One-byte NAL lengths hold no I_PCM slice, so this stream is short
    filler NAL units (type 12) of every length up to 255, several a sample."""
    rng = np.random.default_rng(0)
    sps, pps = writer.sps_pps(32, 32)
    samples = [[bytes([12]) + rng.integers(1, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(0, 255, 3)] for _ in range(N)]
    path = str(tmp_path / "short.mp4")
    table = writer.write_mp4(path, sps, pps, samples, [True] + [False] * (N - 1), 32, 32,
                             nal_length_size=1, chunks=[4, 4, 4])
    m = mp4.Mp4Video.open(path)
    np.testing.assert_array_equal(m.sizes, table["sizes"])
    np.testing.assert_array_equal(m.offsets, table["offsets"])
    assert m.nal_length_size == 1 and m.sync.tolist() == table["sync"]
    out = annexb(m, 0)
    assert m.rank.tolist() == list(range(N))
    start = mp4.START_CODE
    assert out[0] == b"".join(start + nal for nal in [sps, pps] + samples[0])
    for data, nals in zip(out[1:], samples[1:]):
        assert data == b"".join(start + nal for nal in nals)
    with pytest.raises(ValueError, match="1-byte length"):
        writer.write_mp4(path, sps, pps, [[b"\x0c" * 256]], [True], 32, 32, nal_length_size=1)


@pytest.mark.parametrize("size", [(100, 72), (64, 48), (16, 16), (1024, 64)])
def test_sps_size_and_format(size):
    sps, _ = writer.sps_pps(*size)
    fmt = mp4.parse_sps(sps)
    assert (fmt["width"], fmt["height"]) == size
    assert (fmt["coded_width"], fmt["coded_height"]) == writer.coded_size(*size)
    assert (fmt["profile_idc"], fmt["chroma_format_idc"], fmt["bit_depth_luma"]) == (66, 1, 8)


@pytest.mark.parametrize("gray", [False, True])
def test_count_fps_and_size_match_the_jax_media_video(gray, tmp_path):
    path = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(path, *planes_of(gray=gray), idr_every=4, fps=25)
    m, ref = mp4.Mp4Video.open(path), jvideo.MediaVideo(filename=path)
    assert (m.frames, m.fps, m.height, m.width) == (ref.frames, ref.fps, ref.height, ref.width)
    assert ref.is_grayscale == gray


@pytest.mark.parametrize("start", [0, 4, 8])
@pytest.mark.parametrize("container", ["stco", "co64+chunks+ctts", "nal2"])
def test_annexb_decodes_in_cv2_like_the_mp4(start, container, tmp_path):
    """The demuxer's Annex-B bytes from sync sample ``start`` (SPS and PPS
    in front) decode in cv2 to the ``.mp4``'s frames ``start`` onwards."""
    path = str(tmp_path / "clip.mp4")
    table = writer.write_h264_mp4(path, *planes_of(seed=3), idr_every=4, **CONTAINERS[container])
    assert table["sync"][start]
    m = mp4.Mp4Video.open(path)
    raw = str(tmp_path / "clip.h264")
    with open(raw, "wb") as f:
        for data in annexb(m, start):
            f.write(data)
    whole = read_all(path)
    assert whole.shape == (N, 72, 100, 3)
    np.testing.assert_array_equal(read_all(raw), whole[start:])


def write_y4m_sweep(path, varying):
    """All 256 x 256 (Y, ``varying``) pairs, the other chroma plane at 128."""
    y = np.tile(np.repeat(np.arange(256, dtype=np.uint8), 2)[None], (512, 1))[None]
    c = np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 256))[None]
    flat = np.full_like(c, 128)
    planes = (y, c, flat) if varying == "u" else (y, flat, c)
    writer.write_y4m(path, *planes)
    return planes


@pytest.mark.parametrize("varying", ["u", "v"])
def test_yuv_equals_cv2_on_every_pair(varying, tmp_path):
    path = str(tmp_path / "sweep.y4m")
    planes = write_y4m_sweep(path, varying)
    got = read_all(path)
    np.testing.assert_array_equal(want_frames(planes, "bgr"), got)


def test_gray_rule_is_exact_on_every_luma_value(tmp_path):
    """U = V = 128: cv2's three channels are equal and are
    clip(floor((Y - 16) * 255 / 219)), which ``yuv.py``'s blue channel gives."""
    y = np.tile(np.repeat(np.arange(256, dtype=np.uint8), 2)[None], (16, 1))[None]
    c = np.full((1, 8, 256), 128, np.uint8)
    path = str(tmp_path / "gray.y4m")
    writer.write_y4m(path, y, c, c)
    got = read_all(path)[0]
    rule = np.clip(np.floor((np.arange(256) - 16) * 255 / 219), 0, 255).astype(np.uint8)
    assert np.array_equal(got[..., 0], got[..., 1]) and np.array_equal(got[..., 0], got[..., 2])
    np.testing.assert_array_equal(got[0, ::2, 0], rule)
    np.testing.assert_array_equal(want_frames((y, c, c), "b")[0, ..., 0], got[..., 0])


@pytest.mark.parametrize("size", [(100, 72), (94, 48), (18, 16), (46, 30), (256, 256)])
def test_yuv_equals_cv2_on_random_planes(size, tmp_path):
    w, h = size
    rng = np.random.default_rng(w * h)
    planes = (rng.integers(0, 256, (3, h, w), dtype=np.uint8),
              rng.integers(0, 256, (3, h // 2, w // 2), dtype=np.uint8),
              rng.integers(0, 256, (3, h // 2, w // 2), dtype=np.uint8))
    path = str(tmp_path / "random.y4m")
    writer.write_y4m(path, *planes)
    np.testing.assert_array_equal(want_frames(planes, "bgr"), read_all(path))
    np.testing.assert_array_equal(want_frames(planes, "rgb"), read_all(path)[..., ::-1])


def test_nv12_split_and_convert():
    y, u, v = (p[0] for p in planes_of(seed=5))
    uv = np.stack([u, v], -1).reshape(u.shape[0], -1)
    nv12 = torch.from_numpy(np.concatenate([y, uv]))
    got = [p.numpy() for p in yuv.split_nv12(nv12, y.shape[0])]
    for a, b in zip(got, (y, u, v)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(yuv.nv12_to_frame(nv12, y.shape[0], "bgr").numpy(),
                                  want_frames((y, u, v), "bgr"))


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("bgr", [True, False])
def test_jax_media_video_frames_are_yuv_of_the_written_planes(gray, bgr, tmp_path):
    """The JAX package's ``MediaVideo`` (cv2) on the H.264 fixture: its
    frames, in order and seeking, equal ``yuv.py`` over the writer's planes
    bitwise; gray keeps the blue channel."""
    path = str(tmp_path / "clip.mp4")
    planes = planes_of(seed=7, gray=gray)
    writer.write_h264_mp4(path, *planes, idr_every=4, co64=True, chunks=[6, 6])
    ref = jvideo.MediaVideo(filename=path, bgr=bgr)
    want = want_frames(planes, "b" if gray else ("rgb" if bgr else "bgr"))
    for i in [*range(N), 9, 2, 5]:
        np.testing.assert_array_equal(ref.get_frame(i), want[i])


def test_cpu_route_reads_the_h264_fixture_like_jax(tmp_path):
    path = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(path, *planes_of(seed=8), idr_every=4)
    mine = tvideo.load_video(path, device="cpu")
    ref = jvideo.load_video(path)
    assert mine.shape == ref.shape and mine.backend.fps == ref.backend.fps
    for i in (0, 5, 3, 11):
        np.testing.assert_array_equal(mine.get_frame(i), ref.get_frame(i))


def test_card_route_is_the_default_and_never_falls_back_to_cv2(tmp_path, monkeypatch):
    """Without NVDEC (no NVIDIA driver on a CPU-only machine), the default device raises
    naming it, even with cv2 importable: no frame comes from cv2."""
    path = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(path, *planes_of(), idr_every=4)
    video = tvideo.Video.from_filename(path)
    assert isinstance(video.backend, tvideo.MediaVideo) and video.backend.device.type == "cuda"
    with pytest.raises(RuntimeError, match="NVDEC"):
        video.get_frame(0)
    monkeypatch.setitem(sys.modules, "cv2", None)  # the card route must not need it
    for make in (lambda: tvideo.load_video(path), lambda: tvideo.MediaVideo(path, device="cuda")):
        with pytest.raises(RuntimeError, match="NVDEC.*device='cpu'"):
            make().get_frame(0)
    provider = tp._make_provider(path)
    with pytest.raises(RuntimeError, match="NVDEC"):
        next(iter(provider))


def test_other_codecs_and_containers_raise_naming_them(tmp_path):
    # MPEG-4 Part 2 (cv2's mp4v) in .mp4 and .avi reads on the card's route
    # (tests/test_torch_mpeg4.py) as cv2 reads it; a codec the route does not
    # decode, cv2's HuffYUV in an AVI, raises naming its fourcc.
    for name in ("mpeg4.mp4", "mpeg4.avi"):
        path = str(tmp_path / name)
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
        for _ in range(3):
            out.write(np.zeros((32, 32, 3), np.uint8))
        out.release()
        cap, route = cv2.VideoCapture(path), tvideo._card_reader(path, "cpu")
        for i in range(3):
            ok, want = cap.read()
            assert ok
            np.testing.assert_array_equal(route.frame(i).numpy(), want, err_msg=f"{name} {i}")
        cap.release()
    in_avi = str(tmp_path / "huffyuv.avi")
    out = cv2.VideoWriter(in_avi, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"HFYU"), 10, (32, 32))
    for _ in range(3):
        out.write(np.zeros((32, 32, 3), np.uint8))
    out.release()
    with pytest.raises(NotImplementedError, match="AVI of codec 'HFYU'.*ROADMAP.md"):
        tvideo.Video.from_filename(in_avi).get_frame(0)
    for ext in ("mkv", "mj2"):
        other = tmp_path / f"clip.{ext}"
        other.write_bytes(b"RIFF" + bytes(60))
        with pytest.raises(NotImplementedError, match=rf"\.{ext} container.*ROADMAP.md"):
            tvideo.Video.from_filename(str(other)).get_frame(0)
    renamed = tmp_path / "avi.mp4"
    renamed.write_bytes(b"RIFF" + bytes(60))
    with pytest.raises(NotImplementedError, match="AVI or Matroska"):
        mp4.Mp4Video.open(str(renamed))
    with pytest.raises(FileNotFoundError, match="missing.mp4"):
        tvideo.MediaVideo(str(tmp_path / "missing.mp4")).get_frame(0)


def test_device_is_threaded_and_not_written(tmp_path):
    path = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(path, *planes_of(), idr_every=4)
    ref = jvideo.Video.from_filename(path).to_dict()
    for device in ("cuda", "cpu", torch.device("cpu")):
        video = tvideo.Video.from_filename(path, device=device)
        assert video.backend.device == torch.device(device)
        assert video.to_dict() == ref
        assert tvideo.Video.from_dict(ref, device=device).backend.device == torch.device(device)
        assert tvideo.load_video(path, device=device).backend.device == torch.device(device)
        reader = VideoReader.from_filepath(path, device=device)
        assert reader.video.backend.device == torch.device(device)
    labels_path = str(tmp_path / "labels.slp")
    Labels([LabeledFrame(tvideo.Video.from_filename(path), 0)]).save(labels_path)
    assert load_file(labels_path).video.backend.device.type == "cuda"
    cpu = load_file(labels_path, device="cpu")
    assert cpu.video.backend.device.type == "cpu" and cpu.video.to_dict() == ref
    np.testing.assert_array_equal(cpu.video.get_frame(3), jvideo.Video.from_filename(
        path).get_frame(3))
    assert tp._make_provider(labels_path, device="cpu").labels.video.backend.device.type == "cpu"
    assert tp._make_provider(path, device="cpu").video.backend.device.type == "cpu"


# --------------------------------------------------------------------------- #
# The NVDEC reader's logic on the CPU, against a stand-in for libnvcuvid
# --------------------------------------------------------------------------- #


class FakeNvcuvid:
    """libnvcuvid's parser and decoder as the reader uses them, on the host.

    The parser calls back as NVDEC's does for a stream without reordering,
    fed whole pictures (``PKT_ENDOFPICTURE``) with display delay 0: a
    sequence callback at the first SPS after a reset, then for each slice a
    decode and a display callback carrying the packet's timestamp. An
    end-of-stream packet displays nothing more and resets. A slice is
    "decoded" by finding it among the writer's slices, so a frame's content
    comes from the bitstream, never from its timestamp. Mapped surfaces are
    NV12 in host memory with a pitch wider than the frame and the luma plane
    padded to an even height, as NVIDIA's samples read them."""

    def __init__(self, sps, slices, planes, pitch_pad=24, chroma_format=1):
        self.sps, self.slices, self.planes = sps, slices, planes
        self.pitch_pad, self.chroma_format = pitch_pad, chroma_format
        self.packets, self.mapped, self.sequences = [], {}, 0
        self.started = False

    def cuvidCtxLockCreate(self, lock, ctx):
        lock._obj.value = 1
        return 0

    def cuvidCreateVideoParser(self, parser, params):
        p = params._obj
        self.callbacks = (p.pfnSequenceCallback, p.pfnDecodePicture, p.pfnDisplayPicture)
        self.started = False
        parser._obj.value = 2
        return 0

    def cuvidCreateDecoder(self, decoder, info):
        self.surface_height = info._obj.ulTargetHeight
        decoder._obj.value = 3
        return 0

    def cuvidParseVideoData(self, parser, packet):
        from sleap_tpu_torch.io import nvdec

        pkt = packet._obj
        self.packets.append((pkt.flags, pkt.timestamp))
        if pkt.flags & nvdec.PKT_ENDOFSTREAM:
            self.callbacks[2](None, ctypes.POINTER(nvdec.ParserDispInfo)())
            self.started = False
            return 0
        data = ctypes.string_at(pkt.payload, pkt.payload_size)
        for nal in data.split(mp4.START_CODE)[1:]:
            kind = nal[0] & 31
            if kind == 7 and not self.started:
                fmt = mp4.parse_sps(nal)
                self.sequences += 1
                seq = nvdec.VideoFormat(
                    codec=nvdec.CODECS["H264"], chroma_format=self.chroma_format,
                    min_num_decode_surfaces=2, progressive_sequence=1,
                    coded_width=fmt["coded_width"], coded_height=fmt["coded_height"],
                    display_right=fmt["width"], display_bottom=fmt["height"])
                if not self.callbacks[0](None, ctypes.pointer(seq)):
                    return 999  # the parser fails the call when the callback does
                self.started = True
            elif kind in (1, 5) and self.started:
                index = self.slices.index(nal)
                if not self.callbacks[1](None, index):
                    return 999
                info = nvdec.ParserDispInfo(picture_index=index, progressive_frame=1,
                                            timestamp=pkt.timestamp)
                if not self.callbacks[2](None, ctypes.pointer(info)):
                    return 999
        return 0

    def cuvidDecodePicture(self, decoder, pic):
        return 0

    def cuvidMapVideoFrame64(self, decoder, index, ptr, pitch, proc):
        y, u, v = (p[index] for p in self.planes)
        h, w = y.shape
        p = w + self.pitch_pad
        luma_rows = (self.surface_height + 1) & ~1
        surface = np.full((luma_rows + (h + 1) // 2 + 3, p), 77, np.uint8)  # 77: padding
        surface[:h, :w] = y
        surface[luma_rows:luma_rows + u.shape[0], :w] = np.stack([u, v], -1).reshape(u.shape[0], w)
        self.mapped[surface.ctypes.data] = surface
        ptr._obj.value, pitch._obj.value = surface.ctypes.data, p
        return 0

    def cuvidUnmapVideoFrame64(self, decoder, ptr):
        del self.mapped[ptr]
        return 0

    def cuvidDestroyVideoParser(self, parser):
        return 0

    def cuvidDestroyDecoder(self, decoder):
        return 0

    def cuvidCtxLockDestroy(self, lock):
        return 0


class FakeCuda:
    def cuGetErrorName(self, result, name):
        name._obj.value = b"FAKE_ERROR"
        return 0


class FakeContext:
    def __init__(self, device):
        self.index, self.ctx = 0, 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def release(self):
        self.ctx = 0


@pytest.fixture
def fake_nvdec(monkeypatch):
    """``make(path, planes, **fake)``: the H.264 fixture at ``path`` and its
    stand-in decoder; ``NvdecReader`` then decodes on the CPU."""
    from sleap_tpu_torch.io import nvdec

    class HostReader(nvdec.NvdecReader):
        def __init__(self, demux, device="cuda"):
            super().__init__(demux, device="cpu")

        def _stream_handle(self):
            return None

        def _plane(self, ptr, rows, cols, pitch):
            buf = (ctypes.c_ubyte * (pitch * rows)).from_address(ptr)
            return torch.from_numpy(np.ctypeslib.as_array(buf).reshape(rows, pitch)[:, :cols])

    def make(path, planes, idr_every=4, **fake_kw):
        sps, pps, slices, sync = writer.encode(*planes, idr_every=idr_every)
        writer.write_mp4(path, sps, pps, [[s] for s in slices], sync, planes[0].shape[2],
                         planes[0].shape[1])
        fake = FakeNvcuvid(sps, slices, planes, **fake_kw)
        monkeypatch.setattr(nvdec, "_PrimaryContext", FakeContext)
        monkeypatch.setitem(nvdec._LIBS, "cuda", FakeCuda())
        monkeypatch.setitem(nvdec._LIBS, "nvcuvid", fake)
        monkeypatch.setattr(nvdec, "NvdecReader", HostReader)
        return fake

    return make


def test_reader_decodes_forward_and_seeks_from_sync_samples(fake_nvdec, tmp_path):
    from sleap_tpu_torch.io import nvdec

    path = str(tmp_path / "clip.mp4")
    planes = planes_of(seed=11)
    fake = fake_nvdec(path, planes)
    reader = nvdec.NvdecReader(mp4.Mp4Video.open(path))
    for i in range(N):  # in order: every sample fed once, no seek
        nv12 = reader.frame(i)
        for a, b in zip(yuv.split_nv12(nv12, 72), planes):
            np.testing.assert_array_equal(a.numpy(), b[i])
    assert [ts for _, ts in fake.packets] == list(range(N)) and fake.sequences == 1
    assert fake.packets[0][0] & nvdec.PKT_DISCONTINUITY and not fake.mapped
    assert reader.sequence["display"] == (0, 0, 100, 72)
    fake.packets.clear()
    seq = [reader.frame(i).clone() for i in range(N)]  # the last frame is kept; the rest seek
    fake.packets.clear()
    for i in MEDIA_SEEK_ORDER:
        assert torch.equal(reader.frame(i), seq[i])
    fed = [ts for flags, ts in fake.packets if not flags & nvdec.PKT_ENDOFSTREAM]
    assert fed == [0, 4, 5, 6, 7, 0, 1, 2, 3, 8, 9, 10, 11, 0, 1]
    assert sum(flags & nvdec.PKT_ENDOFSTREAM for flags, _ in fake.packets) == 5  # a seek each
    with pytest.raises(KeyError, match="frame 12"):
        reader.frame(N)
    reader.close()



@pytest.mark.parametrize("gray", [False, True])
def test_card_route_with_the_stand_in_decoder_matches_jax(gray, fake_nvdec, tmp_path):
    """``MediaVideo`` on the card's route (a stand-in NVDEC, ``yuv.py`` on
    the CPU) gives the JAX ``MediaVideo``'s (cv2) frames bitwise, in order,
    out of order, from another thread, with its gray detection."""
    import threading

    path = str(tmp_path / "clip.mp4")
    planes = planes_of(seed=12, gray=gray)
    fake_nvdec(path, planes)
    mine, ref = tvideo.MediaVideo(path), jvideo.MediaVideo(filename=path)
    assert mine.is_grayscale == gray == ref.is_grayscale
    assert (mine.frames, mine.fps, mine.height, mine.width, mine.channels) == (
        ref.frames, ref.fps, ref.height, ref.width, ref.channels)
    for i in [*range(N), *MEDIA_SEEK_ORDER]:
        np.testing.assert_array_equal(mine.get_frame(i), ref.get_frame(i))
    np.testing.assert_array_equal(mine.get_frame(2, grayscale=False),
                                  ref.get_frame(2, grayscale=False))
    got = {}
    thread = threading.Thread(target=lambda: got.update(frame=mine.get_frame(9)))
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    np.testing.assert_array_equal(got["frame"], ref.get_frame(9))
    mine.reset()


def test_reader_raises_what_the_callbacks_meet(fake_nvdec, tmp_path):
    """A sequence that is not 4:2:0 fails in the parser's callback; the
    error comes out of ``frame`` naming the format."""
    from sleap_tpu_torch.io import nvdec

    path = str(tmp_path / "clip.mp4")
    fake_nvdec(path, planes_of(seed=13), chroma_format=3)
    reader = nvdec.NvdecReader(mp4.Mp4Video.open(path))
    with pytest.raises(NotImplementedError, match="4:4:4"):
        reader.frame(0)
    reader.close()


def high_profile_sps(width_mbs, height_mbs, crop, chroma_format_idc=1, bit_depth=8):
    """A High-profile SPS (profile 100: chroma format, bit depths, a scaling
    matrix, pic_order_cnt_type 0), as x264 writes them."""
    b = writer.BitWriter()
    b.u(8, 100 if bit_depth == 8 and chroma_format_idc == 1 else 110)
    b.u(8, 0)
    b.u(8, 40)
    b.ue(0)
    b.ue(chroma_format_idc)
    if chroma_format_idc == 3:
        b.u(1, 0)
    b.ue(bit_depth - 8)
    b.ue(bit_depth - 8)
    b.u(1, 0)
    b.u(1, 1)  # seq_scaling_matrix_present_flag
    for i in range(8 if chroma_format_idc != 3 else 12):
        b.u(1, int(i in (0, 6)))  # lists 0 (4x4) and 6 (8x8) present
        if i in (0, 6):
            for _ in range(16 if i < 6 else 64):
                b.se(1)
    b.ue(0)  # log2_max_frame_num_minus4
    b.ue(0)  # pic_order_cnt_type 0
    b.ue(2)  # log2_max_pic_order_cnt_lsb_minus4
    b.ue(4)
    b.u(1, 0)
    b.ue(width_mbs - 1)
    b.ue(height_mbs - 1)
    b.u(1, 1)
    b.u(1, 1)
    b.u(1, 1)
    for offset in crop:
        b.ue(offset)
    b.u(1, 0)
    b.trailing()
    return writer.nal_unit(3, 7, b.take())


def test_high_profile_sps_and_formats_the_card_refuses(tmp_path):
    """x264's High-profile SPS (scaling lists, POC type 0) gives the display
    size; 10-bit or 4:4:4 H.264 is refused by the reader before NVDEC is
    touched, naming it."""
    from sleap_tpu_torch.io import nvdec

    fmt = mp4.parse_sps(high_profile_sps(120, 68, (0, 0, 0, 4)))
    assert (fmt["width"], fmt["height"], fmt["profile_idc"]) == (1920, 1080, 100)
    path = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(path, *planes_of(seed=14))

    demux = mp4.Mp4Video.open(path)
    for kw, name in (({"bit_depth": 10}, "10 bits"), ({"chroma_format_idc": 3}, "4:4:4")):
        demux.format = mp4.parse_sps(high_profile_sps(7, 5, (0, 6, 0, 4), **kw))
        with pytest.raises(NotImplementedError, match=f"{name}.*8-bit 4:2:0"):
            nvdec.NvdecReader(demux)


def test_hdf5_source_videos_decode_on_the_given_device(tmp_path):
    """A package's missing frame comes from its source video, a media file
    decoded on the device the labels were read for."""
    import h5py

    clip = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(clip, *planes_of(seed=15), idr_every=4)
    pkg = str(tmp_path / "pkg.slp")
    shutil.copy(os.path.join(REPO, "tests", "torch_data", "pkg.slp"), pkg)
    with h5py.File(pkg, "r+") as f:
        f["video0/source_video"].attrs["json"] = json.dumps(
            {"backend": {"filename": clip, "type": "MediaVideo", "grayscale": False}})
        missing = max(int(i) for i in f["video0/frame_numbers"][:]) + 1
    assert missing < N
    for device in ("cpu", "cuda"):
        video = load_file(pkg, device=device).video
        source = video.backend.source_video.backend
        assert isinstance(source, tvideo.MediaVideo) and source.device.type == device
    cpu = load_file(pkg, device="cpu").video
    np.testing.assert_array_equal(cpu.get_frame(missing), jvideo.MediaVideo(
        filename=clip, grayscale=False).get_frame(missing))
    with pytest.raises(RuntimeError, match="NVDEC"):
        video.get_frame(missing)


# --------------------------------------------------------------------------- #
# The decode device apart from the compute device; NVDEC's errors
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("argv, compute, decode", [
    ([], "cuda", "cuda"),
    (["--cpu"], "cpu", "cpu"),
    (["--video.device", "cpu"], "cuda", "cpu"),
    (["--cpu", "--video.device", "cuda"], "cpu", "cuda"),
])
def test_cli_decodes_media_on_the_video_device(argv, compute, decode, tmp_path, monkeypatch):
    """``--video.device`` picks where media videos are decoded, apart from
    where the networks run (``--cpu``): the card's NVDEC or the CPU's cv2."""
    from sleap_tpu_torch.cli import track, train
    from sleap_tpu_torch.training import trainer

    clip = str(tmp_path / "clip.mp4")
    writer.write_h264_mp4(clip, *planes_of(), idr_every=4)
    labels_path = str(tmp_path / "labels.slp")
    Labels([LabeledFrame(tvideo.Video.from_filename(clip), 0)]).save(labels_path)
    ns = track.make_parser().parse_args([clip, *argv])
    assert track._device(ns) == compute
    for data in (clip, labels_path):
        ns.data_path = data
        providers = track.make_provider_from_cli(ns)[0]
        assert providers[0].videos[0].backend.device.type == decode
    seen = {}
    monkeypatch.setattr(trainer.Trainer, "from_config",
                        classmethod(lambda cls, cfg, **kw: seen.update(kw)))
    profile = os.path.join(REPO, "sleap_tpu_torch", "training_profiles", "baseline.centroid.json")
    train.create_trainer_using_cli([profile, labels_path, *argv])
    assert seen["device"] == compute and (seen["video_device"] or compute) == decode


def test_decoder_errors_keep_their_call_and_result(monkeypatch):
    """A failed call raises ``CudaError`` with its call and CUresult; only
    an NVDEC call's CUDA_ERROR_OUT_OF_MEMORY names the refused capability."""
    from sleap_tpu_torch.io import nvdec

    monkeypatch.setitem(nvdec._LIBS, "cuda", FakeCuda())
    for call, result, hinted in (("cuvidCreateDecoder", 2, True),
                                 ("cuvidCreateDecoder", 1, False),
                                 ("cuvidGetDecoderCaps", 2, True), ("cuInit", 2, False)):
        with pytest.raises(nvdec.CudaError) as e:
            nvdec._check(result, call, " for clip.mp4")
        assert (e.value.call, e.value.result) == (call, result)
        assert str(e.value).startswith(f"{call} for clip.mp4 failed: CUresult {result} (FAKE_ERROR)")
        assert (nvdec.REFUSED_HINT in str(e.value)) == hinted
    nvdec._check(0, "cuInit")


def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


REFUSED_CAPS = {codec: {"call": "cuvidGetDecoderCaps", "result": 2, "error": "..."}
                for codec in ("H264", "HEVC", "MPEG4", "AV1")}
H264_CAPS = {"supported": 1, "max_width": 4096, "max_height": 4096}


@pytest.mark.parametrize("caps, capabilities, mode", [
    (REFUSED_CAPS, "compute,utility", "refused"),
    ({**REFUSED_CAPS, "H264": H264_CAPS}, "compute,utility", "decoded"),
    ({**REFUSED_CAPS, "H264": H264_CAPS}, "all", "decoded"),
    ({**REFUSED_CAPS, "H264": {**H264_CAPS, "max_width": 512}}, "all", None),
    (REFUSED_CAPS, "compute,video,utility", None),
    (REFUSED_CAPS, "all", None),
    (REFUSED_CAPS, None, None),
    ({**REFUSED_CAPS, "AV1": {"call": "cuvidGetDecoderCaps", "result": 1}}, "compute", None),
    ({**REFUSED_CAPS, "H264": {"error": "AttributeError: undefined symbol"}}, "compute", None),
])
def test_phase_12_takes_only_the_known_refusal_for_one(caps, capabilities, mode):
    """``chip_smoke.py`` holds the card route to a refusal only where the
    container lacks the 'video' capability and every caps call ran out of
    memory; any other error of the binding fails phase 12."""
    smoke = chip_smoke()
    if mode is None:
        with pytest.raises(RuntimeError, match="chip_smoke check failed"):
            smoke.nvdec_mode(caps, capabilities)
    else:
        assert smoke.nvdec_mode(caps, capabilities) == mode


def test_phase_12_refusal_is_create_decoder_out_of_memory():
    from sleap_tpu_torch.io import nvdec

    smoke = chip_smoke()
    assert smoke.is_refusal(nvdec.CudaError("cuvidCreateDecoder", 2, ""), nvdec)
    for e in (nvdec.CudaError("cuvidCreateDecoder", 1, "NVDEC"),
              nvdec.CudaError("cuvidDecodePicture", 2, "NVDEC"), RuntimeError("NVDEC")):
        assert not smoke.is_refusal(e, nvdec)
