"""Stores of frames, both ways between the port and the JAX package, all
exact (tolerance 0): the port's ImgStore directory store
(``sleap_tpu_torch.io.dirimgstore``, PNG through the port's codec,
``metadata.yaml`` through its YAML subset) read by ``sleap_tpu.io.dirimgstore``
and the reverse; its YAML writer and reader against PyYAML; ``ImgStoreVideo``
through ``Video.from_dict`` by original frame number and by position,
``to_imgstore`` and ``save_frame_data_imgstore`` against the JAX package's;
and folders of still images (``SingleImageVideo``) of PNG and JPEG against
the JAX package's cv2 reads, on the CPU routes."""

from __future__ import annotations

import json
import os
import sys
import types

import cv2
import numpy as np
import pytest
import yaml

from sleap_tpu.core.instance import Instance as JInstance
from sleap_tpu.core.instance import LabeledFrame as JLabeledFrame
from sleap_tpu.core.labels import Labels as JLabels
from sleap_tpu.core.skeleton import Skeleton as JSkeleton
from sleap_tpu.io import dirimgstore as jstore
from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io import dirimgstore as tstore
from sleap_tpu_torch.io import video as tvideo


def _frames(n, h, w, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, h, w, c), dtype=np.uint8)


def _fill(store_module, path, frames, numbers, **kwargs):
    store = store_module.new_for_format("png", mode="w", basedir=path,
                                        imgshape=frames.shape[1:], chunksize=3, **kwargs)
    for i, n in enumerate(numbers):
        store.add_image(frames[i], n, 100.0 + i)
    store.close()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stores_read_both_ways(writer, channels, tmp_path):
    frames = _frames(7, 12, 17, channels, seed=channels)
    numbers = [4, 9, 10, 11, 20, 21, 35]  # three chunks of 3 and one of 1
    path = str(tmp_path / "store")
    _fill(tstore if writer == "port" else jstore, path, frames, numbers)
    mine = tstore.new_for_filename(os.path.join(path, "metadata.yaml"), device="cpu")
    ref = jstore.new_for_filename(path)
    for s in (mine, ref):
        assert (s.frame_count, s.frame_min, s.frame_max) == (7, 4, 35)
    for i, n in enumerate(numbers):
        got, (fn, ft) = mine.get_image(frame_number=n)
        want, meta = ref.get_image(frame_number=n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.reshape(frames[i].shape), frames[i])
        assert (fn, ft) == meta == (n, 100.0 + i)
        np.testing.assert_array_equal(mine.get_image(frame_index=i)[0], got)
    # Sequential reads resume after the last one, and wrap.
    mine.get_image(frame_number=35)
    ref.get_image(frame_number=35)
    np.testing.assert_array_equal(mine.get_next_image()[0], ref.get_next_image()[0])
    with pytest.raises(ValueError, match="not in store"):
        mine.get_image(frame_number=5)
    with open(os.path.join(path, "metadata.yaml")) as fh:
        md = yaml.safe_load(fh)["__store"]
    assert md == {"chunksize": 3, "class": "DirectoryImgStore", "format": "png",
                  "imgdtype": "uint8", "imgshape": [12, 17, channels], "version": 1}


def test_jpeg_stores_are_read_as_jax_reads_them(tmp_path):
    """A directory store of JPEG frames (the JAX package writes them through
    cv2): the port's plain JPEG decoder reads cv2's frames; the port writes
    JPEG stores whose files are the bytes cv2 writes; BMP and TIFF stores
    are still refused, naming the ROADMAP item."""
    frames = _frames(3, 16, 24, 3, seed=8)
    path = str(tmp_path / "store")
    store = jstore.new_for_format("jpg", mode="w", basedir=path, imgshape=frames.shape[1:])
    for i, frame in enumerate(frames):
        store.add_image(frame, 10 + i, 0.0)
    store.close()
    mine, ref = tstore.new_for_filename(path, device="cpu"), jstore.new_for_filename(path)
    for n in (10, 11, 12):
        np.testing.assert_array_equal(mine.get_image(frame_number=n)[0],
                                      ref.get_image(frame_number=n)[0])
    mine_path = str(tmp_path / "mine")
    store = tstore.new_for_format("jpg", mode="w", basedir=mine_path, imgshape=frames.shape[1:],
                                  device="cpu")
    for i, frame in enumerate(frames):
        store.add_image(frame, 10 + i, 0.0)
    store.close()
    for name in ("000000.jpg", "000001.jpg", "000002.jpg"):
        with open(os.path.join(path, "000000", name), "rb") as a, \
                open(os.path.join(mine_path, "000000", name), "rb") as b:
            assert a.read() == b.read()
    back = jstore.new_for_filename(mine_path)
    np.testing.assert_array_equal(back.get_image(frame_number=11)[0], ref.get_image(frame_number=11)[0])
    with pytest.raises(NotImplementedError, match="'webp'"):
        tstore.new_for_format("webp", mode="w", basedir=str(tmp_path / "webp"))


def test_metadata_is_written_as_pyyaml_writes_it():
    md = {"__store": {"class": "DirectoryImgStore", "version": 1, "format": "png",
                      "chunksize": 1000, "imgshape": [1024, 1024, 1], "imgdtype": "uint8"}}
    assert tstore.yaml_dump(md) == yaml.safe_dump(md)
    odd = {"a": "yes: no", "b": None, "c": True, "d": 1.5, "e": "", "f": [], "g": {},
           "h": "-x", "i": "#hash", "j": "12", "k": "it's"}
    assert yaml.safe_load(tstore.yaml_dump(odd)) == odd


@pytest.mark.parametrize("text", [
    # loopbio's metadata, flow style, with user data and comments
    "__store: {chunksize: 200, class: DirectoryImgStore, encoding: null, format: png,\n"
    "  imgdtype: uint8, imgshape: [480, 640, 3], version: 1}\n",
    "# a store\n__store:\n  chunksize: 200   # frames a chunk\n  class: DirectoryImgStore\n"
    "  format: 'png'\n  imgshape:\n    - 480\n    - 640\n  imgdtype: \"uint8\"\n  version: 1\n"
    "  uuid: 0a1b-2c\n  created: 2016-03-01 10:20:30\n  fps: 30.0\n  note: ~\n"
    "  flags: {color: true, keep: False}\n  empty: []\nuser:\n  tag: x\n  list: [1, 2.5, -3, null]\n",
    "---\n__store:\n  imgshape: [12, 17]\n  format: png\n  chunksize: 3\n...\n",
])
def test_metadata_reader_matches_pyyaml(text):
    want = yaml.safe_load(text)
    if "created" in text:  # PyYAML reads a timestamp; the subset keeps the text
        want["__store"]["created"] = "2016-03-01 10:20:30"
    assert tstore.yaml_load(text) == want


@pytest.mark.parametrize("text,feature", [
    ("a: &anchor 1\nb: *anchor\n", "anchors"),
    ("a: |\n  two\n  lines\n", "block scalars"),
    ("a: !!int 3\n", "tags"),
    ("a:\n  - b: 1\n", "mappings inside block sequences"),
    ("a: [1, 2\n", "flow sequences must close"),
])
def test_metadata_reader_refuses_what_it_does_not_read(text, feature):
    with pytest.raises(ValueError, match=feature):
        tstore.yaml_load(text)


@pytest.mark.parametrize("by_original", [True, False])
def test_imgstore_video_from_dict_matches_jax(by_original, tmp_path):
    frames = _frames(14, 10, 14, 1, seed=4)
    numbers = [2, 3, 7, 8, 13]
    path = str(tmp_path / "store")
    mine = tvideo.Video.from_numpy(frames).to_imgstore(path, frame_numbers=numbers, device="cpu",
                                                       index_by_original=by_original)
    ref = jvideo.Video.from_numpy(frames).to_imgstore(str(tmp_path / "ref"), frame_numbers=numbers,
                                                      index_by_original=by_original)
    d = mine.to_dict()
    assert d == {**ref.to_dict(), "backend": {**ref.to_dict()["backend"], "filename": path}}
    again = tvideo.Video.from_dict(json.loads(json.dumps(d)), device="cpu")
    jagain = jvideo.Video.from_dict(d)
    assert type(again.backend).__name__ == "ImgStoreVideo"
    assert again.shape == jagain.shape == (5, 10, 14, 1)
    assert again.backend.last_frame_idx == jagain.backend.last_frame_idx
    idxs = numbers if by_original else range(5)
    for i, k in enumerate(idxs):
        np.testing.assert_array_equal(again.get_frame(k), jagain.get_frame(k))
        np.testing.assert_array_equal(again.get_frame(k), frames[numbers[i]])


def test_save_frame_data_imgstore_matches_jax(tmp_path):
    frames = _frames(6, 9, 11, 3, seed=5)
    skeleton, jskeleton = Skeleton("s"), JSkeleton("s")
    for s in (skeleton, jskeleton):
        s.add_node("A")
    video, jvid = tvideo.Video.from_numpy(frames), jvideo.Video.from_numpy(frames)
    labels = Labels([LabeledFrame(video, i, [Instance(skeleton, np.array([[1.0, 2.0]]))])
                     for i in (1, 4)])
    jlabels = JLabels(labeled_frames=[JLabeledFrame(jvid, i, [JInstance(
        skeleton=jskeleton, points=np.array([[1.0, 2.0]]))]) for i in (1, 4)])
    got = labels.save_frame_data_imgstore(str(tmp_path / "mine"), device="cpu")
    want = jlabels.save_frame_data_imgstore(str(tmp_path / "ref"))
    assert [os.path.basename(v.filename) for v in got] == ["frame_data_vid0"]
    assert len(want) == 1
    for i in (1, 4):
        np.testing.assert_array_equal(got[0].get_frame(i), want[0].get_frame(i))
    # Each reads the other's store.
    np.testing.assert_array_equal(
        jvideo.Video.from_dict(got[0].to_dict()).get_frame(4), frames[4])
    np.testing.assert_array_equal(
        tvideo.Video.from_dict(want[0].to_dict(), device="cpu").get_frame(1), frames[1])


def test_video_chunk_stores_raise_naming_the_roadmap(tmp_path, monkeypatch):
    """A store of video-file chunks opens through loopbio's ``imgstore``
    package (a stand-in here): the port hands it the metadata path, as the
    JAX package does; without the package, the error names it."""
    path = tmp_path / "store"
    path.mkdir()
    (path / "metadata.yaml").write_text("__store: {class: VideoImgStore, format: mjpeg/avi, "
                                        "chunksize: 100}\n")
    monkeypatch.setitem(sys.modules, "imgstore", None)
    with pytest.raises(ImportError, match="VideoImgStore.*imgstore package"):
        tstore.new_for_filename(str(path), device="cpu")
    frames = np.arange(3 * 4 * 5, dtype=np.uint8).reshape(3, 4, 5)
    opened = []

    class StandIn:
        frame_count, frame_max = 3, 12

        def get_next_image(self):
            return frames[0], (10, 0.0)

        def get_image(self, frame_number=None, frame_index=None):
            i = frame_index if frame_number is None else frame_number - 10
            return frames[i], (10 + i, 0.0)

    stub = types.ModuleType("imgstore")
    stub.new_for_filename = lambda p: opened.append(p) or StandIn()
    monkeypatch.setitem(sys.modules, "imgstore", stub)
    video = tvideo.Video.from_dict({"backend": {"type": "ImgStoreVideo", "filename": str(path)}},
                                   device="cpu")
    assert opened == [str(path / "metadata.yaml")]
    assert video.shape == (3, 4, 5, 1)
    np.testing.assert_array_equal(video.get_frame(11)[..., 0], frames[1])


# --------------------------------------------------------------------------- #
# Folders of still images
# --------------------------------------------------------------------------- #


def _write_stills(folder, kind, n=3):
    rng = np.random.default_rng(len(kind))
    yy, xx = np.mgrid[:30, :44]
    for i in range(n):
        img = np.clip(120 + 60 * np.sin(xx / 5.0 + i)[..., None] * np.cos(yy / 7.0)[..., None]
                      + rng.integers(-20, 20, (30, 44, 3)), 0, 255).astype(np.uint8)
        if kind.startswith("gray"):
            img = img[..., 0]
        if kind == "rgba":
            img = np.concatenate([img, rng.integers(0, 255, (30, 44, 1), dtype=np.uint8)], -1)
        ext = "jpg" if kind.endswith("jpg") else "jpeg" if kind.endswith("jpeg") else "png"
        cv2.imwrite(str(folder / f"img{i}.{ext}"), img)


@pytest.mark.parametrize("grayscale", [None, True])
@pytest.mark.parametrize("kind", ["gray", "colour", "rgba", "gray_jpg", "colour_jpg",
                                  "colour_jpeg"])
def test_single_image_folders_match_jax(kind, grayscale, tmp_path):
    _write_stills(tmp_path, kind)
    mine = tvideo.load_video(str(tmp_path), grayscale=grayscale, device="cpu")
    ref = jvideo.load_video(str(tmp_path), grayscale=grayscale)
    assert type(mine.backend).__name__ == "SingleImageVideo"
    assert mine.shape == ref.shape
    np.testing.assert_array_equal(mine[:], ref[:])
    assert mine.backend.is_grayscale == ref.backend.is_grayscale
    assert mine.to_dict() == ref.to_dict()


def test_other_still_formats_read_through_cv2_on_the_cpu_only(tmp_path):
    """BMP and TIFF stills read through the port's own codecs, as the JAX
    package's cv2 reads them; BMP has one route (numpy on the host), so the
    default device reads it here too."""
    img = np.random.default_rng(0).integers(0, 255, (12, 9, 3), dtype=np.uint8)
    for ext in ("bmp", "tif"):
        path = str(tmp_path / f"a.{ext}")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(tvideo.Video.from_filename(path, device="cpu").get_frame(0),
                                      jvideo.Video.from_filename(path).get_frame(0))
    np.testing.assert_array_equal(tvideo.Video.from_filename(str(tmp_path / "a.bmp")).get_frame(0),
                                  img[..., ::-1])