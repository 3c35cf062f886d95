"""``sleap-render`` (``sleap_tpu_torch.io.visuals``) against the JAX
package's (``sleap_tpu.io.visuals``), bitwise on the CPU route:
``render_frame`` on tracked and untracked projects, gray and colour, at
scale 1 and 0.5 (and on the committed JPEG package); the frames that
``save_labeled_video`` hands its writer, for each background, with a crop
inside the frame and one larger than it, captured on both sides by a
writer patched in at run time; the pipelined route against the serial one,
and errors raised in its threads reaching the caller; and ``main``, which
writes as many frames as the JAX package's ``main``, and with imageio and
cv2 blocked writes a Motion-JPEG AVI whose chunks are ``jpeg.imencode`` of
the frames ``render_frame`` draws."""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import sleap_tpu
from sleap_tpu.core import instance as jinstance
from sleap_tpu.core import labels as jlabels
from sleap_tpu.core import skeleton as jskeleton
from sleap_tpu.io import video as jvideo
from sleap_tpu.io import visuals as jv
from sleap_tpu_torch.core import instance as tinstance
from sleap_tpu_torch.core import labels as tlabels
from sleap_tpu_torch.core import skeleton as tskeleton
from sleap_tpu_torch.io import avi, jpeg
from sleap_tpu_torch.io import video as tvideo
from sleap_tpu_torch.io import visuals as tv

REPO = Path(__file__).resolve().parent.parent
JPEG_PKG = REPO / "tests" / "torch_data" / "jpeg_pkg.slp"
JAX = (jinstance, jlabels, jskeleton, jvideo)
PORT = (tinstance, tlabels, tskeleton, tvideo)


def _frames(n, h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 60 + 40 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    return np.clip(base[None, ..., None] + rng.normal(0, 10, (n, h, w, c)), 0, 255).astype(np.uint8)


def _points(n_frames, n_inst, h, w, seed):
    """(frames, instances, 5, 2): bodies inside and across the frame edge,
    some NaN points, half-pixel coordinates (rounded half to even)."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform([-6, -6], [w + 6, h + 6], (n_frames, n_inst, 1, 2))
    pts = centres + rng.uniform(-9, 9, (n_frames, n_inst, 5, 2))
    pts[rng.random(pts.shape[:3]) < 0.15] = np.nan
    half = rng.random(pts.shape) < 0.3
    pts[half] = np.floor(pts[half]) + 0.5
    return pts


def _project(pkg, frames, pts, tracked):
    instance, labels, skeleton, video = pkg
    sk = skeleton.Skeleton("render")
    for name in "ABCDE":
        sk.add_node(name)
    for a, b in ("AB", "BC", "CD", "DE", "AC"):
        sk.add_edge(a, b)
    vid = video.Video.from_numpy(frames)
    tracks = [instance.Track(spawned_on=0, name=f"t{i}") for i in range(pts.shape[1])] if tracked else []
    lfs = []
    for f, frame_pts in enumerate(pts):
        if f == 2:
            continue  # a frame with no labels renders as it is
        insts = [instance.Instance(skeleton=sk, points=p, track=tracks[k] if tracked else None)
                 for k, p in enumerate(frame_pts)]
        lfs.append(instance.LabeledFrame(video=vid, frame_idx=f, instances=insts))
    return labels.Labels(labeled_frames=lfs, tracks=tracks or None)


def _pair(channels, tracked, n=6, h=48, w=64, n_inst=9, seed=0):
    frames = _frames(n, h, w, channels, seed)
    pts = _points(n, n_inst, h, w, seed + 1)
    return _project(JAX, frames, pts, tracked), _project(PORT, frames, pts, tracked)


@pytest.mark.parametrize("scale", [1.0, 0.5])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("tracked", [True, False], ids=["tracked", "untracked"])
def test_render_frame_equals_jax(tracked, channels, scale):
    jl, tl = _pair(channels, tracked)
    for f in range(6):
        img = jl.video.get_frame(f)
        np.testing.assert_array_equal(tl.video.get_frame(f), img)
        if scale != 1.0:
            small = jv.resize_image(img, scale)
            np.testing.assert_array_equal(tv.resize_image(img, scale), small)
            img = small
        want = jv.render_frame(jl, img.copy(), f, scale=scale, line_width=1 + f % 3)
        got = tv.render_frame(tl, img.copy(), f, scale=scale, line_width=1 + f % 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_render_frame_on_the_jpeg_package_equals_jax(scale):
    jl = sleap_tpu.load_file(str(JPEG_PKG))
    tl = tlabels.Labels.load_file(str(JPEG_PKG), device="cpu")
    for f in (0, 7, 15):
        img = jl.video.get_frame(f)
        np.testing.assert_array_equal(tl.video.get_frame(f), img)
        want = jv.render_frame(jl, jv.resize_image(img, scale), f, scale=scale)
        np.testing.assert_array_equal(tv.render_frame(tl, tv.resize_image(img, scale), f, scale=scale), want)


class _Capture:
    """A writer that keeps what it is handed."""

    def __init__(self, sink, height, width):
        self.sink, self.shape = sink, (height, width)

    def add_frame(self, img, bgr=False):
        assert img.shape[:2] == self.shape and bgr
        self.sink.append(np.array(img))

    def close(self):
        self.sink.append("closed")


def _captured(module, monkeypatch, labels, **kwargs):
    sink = []
    monkeypatch.setattr(module.VideoWriter, "safe_builder", staticmethod(
        lambda filename, height, width, fps=30.0, **_: _Capture(sink, height, width)))
    module.save_labeled_video("unused.avi", labels, **kwargs)
    assert sink[-1] == "closed"
    return sink[:-1]


@pytest.mark.parametrize("crop", [None, (32, 24), (80, 60)], ids=["full", "crop", "crop_padded"])
@pytest.mark.parametrize("background", ["original", "black", "grey", "white"])
def test_save_labeled_video_frames_equal_jax(background, crop, monkeypatch):
    jl, tl = _pair(1, True)
    kwargs = dict(fps=10.0, scale=0.5 if crop else 1.0, crop_size_xy=crop, background=background)
    want = _captured(jv, monkeypatch, jl, **kwargs)
    got = _captured(tv, monkeypatch, tl, device="cpu", **kwargs)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pipelined_equals_serial_and_errors_propagate(monkeypatch):
    jl, tl = _pair(3, True, n=40)
    piped = _captured(tv, monkeypatch, tl, crop_size_xy=(40, 30), pipelined=True)
    serial = _captured(tv, monkeypatch, tl, crop_size_xy=(40, 30), pipelined=False)
    assert len(piped) == len(serial) == 39
    for a, b in zip(piped, serial):
        np.testing.assert_array_equal(a, b)
    for pipelined in (True, False):
        with pytest.raises(ValueError, match="Invalid background"):
            _captured(tv, monkeypatch, tl, background="purple", pipelined=pipelined)

    class Failing(_Capture):
        def add_frame(self, img, bgr=False):
            raise OSError("disk full")

    monkeypatch.setattr(tv.VideoWriter, "safe_builder", staticmethod(
        lambda filename, height, width, fps=30.0, **_: Failing([], height, width)))
    for _ in range(20):  # the workers may have ended, or be waiting, when the writer fails
        with pytest.raises(OSError, match="disk full"):
            tv.save_labeled_video("unused.avi", tl)
    with pytest.raises(ValueError, match="No frames"):
        tv.save_labeled_video("unused.avi", tl, frames=[])


def _count(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_main_writes_the_frames_jax_writes(tmp_path, monkeypatch):
    _, tl = _pair(1, True, n=8)
    path = str(tmp_path / "proj.slp")
    tl.save(path, with_images=True, embed_all_labeled=True)
    jv.main([path, "-o", str(tmp_path / "jax.avi"), "--frames", "0-5", "--crop", "40,30"])
    tv.main([path, "-o", str(tmp_path / "port.avi"), "--frames", "0-5", "--crop", "40,30", "--cpu"])
    jv.main([path])  # the default name, <data_path>.avi
    n = _count(str(tmp_path / "jax.avi"))
    assert n == _count(str(tmp_path / "port.avi")) == 5  # frame 2 is not in the package
    assert _count(path + ".avi") == 7
    # With neither imageio nor cv2, the port writes a Motion-JPEG AVI.
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = str(tmp_path / "mjpeg.avi")
    tv.main([path, "-o", out, "--frames", "0-5", "--scale", "0.5", "--cpu"])
    chunks = avi.read_frames(out)
    assert len(chunks) == n
    labels = tlabels.Labels.load_file(path, device="cpu")
    for chunk, f in zip(chunks, (0, 1, 3, 4, 5)):
        img = tv.resize_image(labels.video.get_frame(f), 0.5)
        assert chunk == jpeg.imencode(tv.render_frame(labels, img, f, scale=0.5), "cpu")


def test_rendered_hashes_recorded_for_the_card():
    """``rendered.json`` (the JAX package's ``render_frame`` of the JPEG
    package, recorded for the card) holds for the port's frames."""
    import hashlib
    import json

    record = json.loads((REPO / "tests" / "torch_data" / "jpeg" / "rendered.json").read_text())["scales"]
    tl = tlabels.Labels.load_file(str(JPEG_PKG), device="cpu")
    for scale in (1.0, 0.5):
        for f in (0, 9):
            img = tv.resize_image(tl.video.get_frame(f), scale)
            drawn = tv.render_frame(tl, img, f, scale=scale)
            assert hashlib.sha256(drawn.tobytes()).hexdigest() == record[str(scale)][f]["sha256"]
