"""The port's video writers (``sleap_tpu_torch.io.videowriter``) and its
AVI muxer (``sleap_tpu_torch.io.avi``): the OpenCV and imageio backends
round-trip as the JAX package's tests hold its own; with imageio and cv2
blocked, ``safe_builder`` writes a Motion-JPEG AVI for an ``.avi`` name and
raises naming both for any other; the AVI's chunks are ``cv2.imencode``'s
bytes, and cv2's reader opens it (count, shape, and the frames within the
difference of its own MJPEG decoder, which is ffmpeg's, not
libjpeg-turbo's); an OpenDML file written past a lowered RIFF limit opens
too."""

from __future__ import annotations

import struct
import sys

import cv2
import numpy as np
import pytest

from sleap_tpu_torch.io import avi, jpeg
from sleap_tpu_torch.io import videowriter as tw

#: cv2.VideoCapture decodes MJPEG through ffmpeg (its own IDCT and colour
#: conversion), so its frames differ from libjpeg-turbo's by a few levels.
CAPTURE_TOL = 12


def _frames(n=8, h=32, w=48, c=3):
    """Large flat patches, as the JAX package's writer tests use, plus a
    colour edge so that a channel swap shows."""
    frames = np.zeros((n, h, w, c), np.uint8)
    for i in range(n):
        frames[i, :, : w // 2] = 50 + 20 * (i % 2)
        frames[i, :, w // 2:] = 200 - 20 * (i % 2)
        if c == 3:
            frames[i, : h // 2, :, 2] = 240
    return frames


def _read(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return out


def _blocked(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)


def test_opencv_writer_roundtrip(tmp_path):
    path = str(tmp_path / "out.mp4")
    writer = tw.VideoWriterOpenCV(path, height=32, width=48, fps=30.0)
    for f in _frames():
        writer.add_frame(f, bgr=True)
    writer.close()
    frames = _read(path)
    assert len(frames) == 8 and frames[0].shape == (32, 48, 3)
    assert frames[0][:, :20].mean() < 120 < frames[0][:, 28:].mean()


def test_imageio_writer_roundtrip(tmp_path):
    """imageio writes GIFs with Pillow: frames come back, BGR turned to
    RGB."""
    import imageio

    path = str(tmp_path / "out.gif")
    writer = tw.VideoWriterImageio(path, height=32, width=48, fps=10.0)
    for f in _frames(4):
        writer.add_frame(f, bgr=True)
    writer.close()
    back = imageio.mimread(path)
    assert len(back) == 4 and back[0].shape[:2] == (32, 48)
    assert back[0][0, 0, 0] > 200 and back[0][-1, 0, 0] < 120  # red (BGR's last channel) on top


@pytest.mark.parametrize("channels", [1, 3])
def test_safe_builder_writes_mjpeg_where_neither_backend_imports(channels, tmp_path, monkeypatch):
    _blocked(monkeypatch)
    path = str(tmp_path / "x.avi")
    frames = _frames(c=channels)
    writer = tw.VideoWriter.safe_builder(path, height=32, width=48, fps=25.0, device="cpu")
    assert isinstance(writer, tw.VideoWriterMJPEG)
    for f in frames:
        writer.add_frame(f, bgr=True)
    writer.close()
    monkeypatch.undo()
    chunks = avi.read_frames(path)
    bgr = np.repeat(frames, 3, axis=-1) if channels == 1 else frames
    assert [c for c in chunks] == [cv2.imencode(".jpg", f)[1].tobytes() for f in bgr]
    back = _read(path)
    assert len(back) == 8 and back[0].shape == (32, 48, 3)
    assert max(np.abs(b.astype(int) - f).max() for b, f in zip(back, bgr)) <= CAPTURE_TOL


def test_safe_builder_refuses_other_names_without_a_backend(tmp_path, monkeypatch):
    _blocked(monkeypatch)
    with pytest.raises(ImportError, match="imageio.*cv2"):
        tw.VideoWriter.safe_builder(str(tmp_path / "x.mp4"), height=8, width=8)


def test_safe_builder_prefers_imageio_then_cv2(tmp_path, monkeypatch):
    """As the JAX package: imageio first (it cannot write .mp4 without its
    ffmpeg or PyAV plugin, blocked here), then OpenCV."""
    monkeypatch.setitem(sys.modules, "imageio_ffmpeg", None)
    monkeypatch.setitem(sys.modules, "av", None)
    writer = tw.VideoWriter.safe_builder(str(tmp_path / "x.mp4"), height=32, width=48)
    assert isinstance(writer, tw.VideoWriterOpenCV)
    writer.close()
    monkeypatch.setitem(sys.modules, "cv2", None)
    writer = tw.VideoWriter.safe_builder(str(tmp_path / "x.gif"), height=32, width=48)
    assert isinstance(writer, tw.VideoWriterImageio)
    writer.close()


def test_mjpeg_writer_takes_rgb_and_gray_as_the_other_backends_do(tmp_path):
    path = str(tmp_path / "x.avi")
    frames = _frames(2)
    writer = tw.VideoWriterMJPEG(path, 32, 48, 15.0, device="cpu")
    writer.add_frame(frames[0][..., ::-1])  # RGB, flipped to BGR
    writer.add_frame(frames[1][..., 0])  # (H, W) gray, replicated
    with pytest.raises(ValueError, match="frame"):
        writer.add_frame(np.zeros((10, 10, 3), np.uint8))
    writer.close()
    chunks = avi.read_frames(path)
    assert chunks[0] == jpeg.imencode(frames[0], "cpu")
    assert chunks[1] == jpeg.imencode(np.repeat(frames[1][..., :1], 3, axis=-1), "cpu")


def test_avi_header(tmp_path):
    path = str(tmp_path / "x.avi")
    assert avi.rate_scale(15.0) == (15, 1) and avi.rate_scale(29.97) == (2997, 100)
    with avi.AviWriter(path, 48, 32, 30000 / 1001) as w:
        for f in _frames(3):
            w.add(jpeg.imencode(f, "cpu"))
    data = open(path, "rb").read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI " and struct.unpack_from("<I", data, 4)[0] == len(data) - 8
    avih = data.index(b"avih") + 8
    us, _, _, flags, total = struct.unpack_from("<5I", data, avih)
    assert (us, total) == (33367, 3) and flags & avi.AVIF_HASINDEX
    strh = data.index(b"strh") + 8
    assert data[strh:strh + 8] == b"vidsMJPG"
    scale, rate = struct.unpack_from("<II", data, strh + 20)
    assert (rate, scale) == (30000, 1001)
    assert struct.unpack_from("<I", data, strh + 32)[0] == 3
    assert data[data.index(b"strf") + 8 + 16:][:4] == b"MJPG"
    movi = data.index(b"movi")
    idx1 = data.index(b"idx1")
    entries = [struct.unpack_from("<4sIII", data, idx1 + 8 + 16 * i) for i in range(3)]
    for fourcc, flags, offset, size in entries:
        assert fourcc == b"00dc" and flags == avi.AVIIF_KEYFRAME
        assert data[movi + offset:movi + offset + 4] == b"00dc"
        assert struct.unpack_from("<I", data, movi + offset + 4)[0] == size
    assert b"JUNK" in data[:movi] and b"indx" not in data


def test_opendml_past_a_lowered_limit(tmp_path, monkeypatch):
    monkeypatch.setattr(avi, "RIFF_LIMIT", 20000)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (12, 40, 56, 3), dtype=np.uint8)  # noise: ~6 KB a JPEG
    path = str(tmp_path / "big.avi")
    bufs = [jpeg.imencode(f, "cpu") for f in frames]
    with avi.AviWriter(path, 56, 40, 15.0) as w:
        for b in bufs:
            w.add(b)
    data = open(path, "rb").read()
    assert data.count(b"AVIX") >= 2 and data.count(b"ix00") == data.count(b"movi")
    assert b"indx" in data and b"dmlh" in data
    assert avi.read_frames(path) == bufs
    back = _read(path)
    assert len(back) == 12 and back[0].shape == (40, 56, 3)
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
    cap.release()


def test_imageio_reads_the_avi(tmp_path):
    """imageio reads AVIs through ffmpeg or PyAV; where neither plugin is
    installed it cannot open any AVI."""
    import imageio

    path = str(tmp_path / "x.avi")
    with avi.AviWriter(path, 48, 32, 15.0) as w:
        for f in _frames(5):
            w.add(jpeg.imencode(f, "cpu"))
    try:
        back = imageio.mimread(path)
    except ValueError as e:
        if "Could not find a backend" in str(e):
            pytest.skip("imageio has no AVI plugin here (imageio-ffmpeg and PyAV are absent)")
        raise
    assert len(back) == 5 and back[0].shape == (32, 48, 3)
