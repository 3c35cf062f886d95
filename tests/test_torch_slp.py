"""The port's ``.slp`` reader and writer (``sleap_tpu_torch.io.slp``) and
video backends (``sleap_tpu_torch.io.video``) against the JAX package's:
every ``.slp`` in the repository reads into the same labels (frames,
instance types, points bitwise, scores, tracks, ``from_predicted`` links,
skeletons, video entries, suggestions, provenance); what the port writes,
the JAX reader and h5py read back; the backends give the same frames."""

from __future__ import annotations

import glob
import json
import os
import shutil
import sys

import cv2
import h5py
import numpy as np
import pytest

from sleap_tpu.io import slp as jslp
from sleap_tpu.io import video as jvideo
from sleap_tpu_torch.core.instance import Instance, LabeledFrame, PredictedInstance, Track
from sleap_tpu_torch.core.labels import Labels, SuggestionFrame, load_file
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data.providers import LabelsReader, VideoReader
from sleap_tpu_torch.io import bmp, slp
from sleap_tpu_torch.io import video as tvideo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(REPO, "tests", "torch_data", n) for n in ("raw.slp", "pkg.slp")]
SLP_FILES = sorted(glob.glob(os.path.join(REPO, ".convergence_runs", "*", "*.slp"))) + FIXTURES


def _rel(path):
    return os.path.relpath(path, REPO)


def assert_same_labels(mine, ref) -> None:
    """The port's labels equal the JAX package's, object for object."""
    assert len(mine.labeled_frames) == len(ref.labeled_frames)
    assert [v.to_dict() for v in mine.videos] == [v.to_dict() for v in ref.videos]
    assert [(t.spawned_on, t.name) for t in mine.tracks] == [(t.spawned_on, t.name) for t in ref.tracks]
    assert len(mine.skeletons) == len(ref.skeletons)
    for a, b in zip(mine.skeletons, ref.skeletons):
        assert a.name == b.name and a.node_names == b.node_names
        assert [tuple(e) for e in a.edge_names] == [tuple(e) for e in b.edge_names]
        assert [tuple(s) for s in a.symmetry_names] == [tuple(s) for s in b.symmetry_names]
    assert [(mine.videos.index(s.video), s.frame_idx, s.group) for s in mine.suggestions] == \
        [(ref.videos.index(s.video), s.frame_idx, s.group) for s in ref.suggestions]
    assert mine.provenance == ref.provenance
    assert mine.negative_anchors == ref.negative_anchors

    def index(items, x):
        return None if x is None else next(i for i, y in enumerate(items) if y is x)

    mine_all = [i for lf in mine.labeled_frames for i in lf.instances]
    ref_all = [i for lf in ref.labeled_frames for i in lf.instances]
    for a, b in zip(mine.labeled_frames, ref.labeled_frames):
        assert index(mine.videos, a.video) == index(ref.videos, b.video)
        assert a.frame_idx == b.frame_idx
        assert len(a.instances) == len(b.instances)
        for x, y in zip(a.instances, b.instances):
            assert x.predicted == y.predicted
            assert x.points.dtype == y.points.dtype
            assert x.points.tobytes() == y.points.tobytes()
            assert index(mine.skeletons, x.skeleton) == index(ref.skeletons, y.skeleton)
            assert index(mine.tracks, x.track) == index(ref.tracks, y.track)
            assert index(mine_all, x.from_predicted) == index(ref_all, y.from_predicted)
            if x.predicted:
                assert x.score == y.score and x.tracking_score == y.tracking_score


@pytest.mark.parametrize("path", SLP_FILES, ids=_rel)
def test_read_labels_matches_jax(path):
    assert_same_labels(slp.read_labels(path), jslp.read_labels(path))


@pytest.mark.parametrize("path", SLP_FILES, ids=_rel)
def test_round_trip_through_the_port_writer(path, tmp_path):
    out = str(tmp_path / "copy.slp")
    original = jslp.read_labels(path)
    slp.write_labels(out, slp.read_labels(path))
    mine, ref = slp.read_labels(out), jslp.read_labels(out)
    assert_same_labels(mine, ref)
    assert_same_labels(mine, original)


def _port_project(frames):
    """Labels over an in-memory video: user and predicted instances, a
    from_predicted link, tracks, symmetries, a suggestion and provenance."""
    skel = Skeleton("chain")
    for n in ("a", "b", "c"):
        skel.add_node(n)
    skel.add_edge("a", "b")
    skel.add_edge("b", "c")
    skel.add_symmetry("a", "c")
    video = tvideo.Video.from_numpy(frames)
    tracks = [Track(0, "t0"), Track(2, "t1")]
    rng = np.random.default_rng(0)
    lfs = []
    for i in range(len(frames)):
        pred = PredictedInstance.from_arrays(rng.uniform(0, 30, (3, 2)), rng.random(3), 0.9,
                                             skel, track=tracks[i % 2], tracking_score=0.5)
        user = Instance(skel, rng.uniform(0, 30, (3, 2)), track=tracks[0])
        user.points["x"][1] = np.nan
        user.points["visible"][1] = False
        user.from_predicted = pred
        lfs.append(LabeledFrame(video, i, [pred, user] if i % 3 else [pred]))
    lfs.append(LabeledFrame(video, len(frames) - 1, []))  # an empty frame
    return Labels(lfs, suggestions=[SuggestionFrame(video, 1, 0)],
                  provenance={"model_paths": ["x"], "args": {"batch_size": 4, "cpu": True}})


def test_written_numpy_video_reads_back_in_both_packages(tmp_path):
    frames = np.random.default_rng(1).integers(0, 255, (5, 32, 24, 1), np.uint8)
    labels = _port_project(frames)
    path = str(tmp_path / "project.slp")
    labels.save(path)
    mine, ref = load_file(path), jslp.read_labels(path)
    assert_same_labels(mine, ref)
    assert mine.videos[0].backend.dataset == "video0_raw"
    np.testing.assert_array_equal(mine.video[:], frames)
    np.testing.assert_array_equal(ref.videos[0].get_frames(range(5)), frames)
    with h5py.File(path, "r") as f:  # h5py reads the bool fields as bool
        assert f["points"].dtype == np.dtype(
            [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?")])
        np.testing.assert_array_equal(f["video0_raw"][:], frames)
    assert [len(lf.instances) for lf in mine] == [len(lf.instances) for lf in labels]
    assert np.isnan(mine[1].instances[1].points["x"][1])
    assert mine[1].instances[1].from_predicted is mine[1].instances[0]


def test_append_merges_into_an_existing_file(tmp_path):
    """Labels read from the same file: videos unify by filename, skeletons
    by node names, and frames of one (video, index) merge."""
    frames = np.zeros((3, 16, 16, 1), np.uint8)
    path = str(tmp_path / "a.slp")
    first = _port_project(frames)
    first.save(path)
    extra = load_file(path)
    mine_base = load_file(path)
    ref_base = jslp.read_labels(path)
    slp.write_labels(str(tmp_path / "mine.slp"), mine_base)
    jslp.write_labels(str(tmp_path / "ref.slp"), ref_base)
    slp.write_labels(str(tmp_path / "mine.slp"), extra, append=True)
    jslp.write_labels(str(tmp_path / "ref.slp"), jslp.read_labels(path), append=True)
    assert_same_labels(slp.read_labels(str(tmp_path / "mine.slp")),
                       jslp.read_labels(str(tmp_path / "ref.slp")))


def test_pre_1_1_files_shift_user_points(tmp_path):
    path = str(tmp_path / "old.slp")
    shutil.copy(FIXTURES[0], path)
    with h5py.File(path, "a") as f:
        f["metadata"].attrs["format_id"] = 1.0
    mine, ref = slp.read_labels(path), jslp.read_labels(path)
    assert_same_labels(mine, ref)
    new = slp.read_labels(FIXTURES[0])
    np.testing.assert_allclose(mine[0].instances[0].numpy(), new[0].instances[0].numpy() - 0.5)


def test_embedding_frames_is_refused(tmp_path):
    """Embedding frames as JPEG, BMP or TIFF writes the rows the JAX
    package writes with cv2, byte for byte, and the JAX package reads them;
    embedding frames in a format the port does not write is refused naming
    the ones it does, and writes nothing."""
    rng = np.random.default_rng(5)
    frames = np.clip(rng.normal(120, 40, (4, 30, 44, 1)), 0, 255).astype(np.uint8)
    project = _port_project(frames)
    raw = str(tmp_path / "raw.slp")
    project.save(raw)  # the same project, read by the JAX package and embedded by it
    for fmt in ("jpg", "bmp", "tif"):
        path, ref = str(tmp_path / f"x.{fmt}.pkg.slp"), str(tmp_path / f"ref.{fmt}.pkg.slp")
        project.save(path, with_images=True, image_format=fmt, device="cpu")
        jslp.write_labels(ref, jslp.read_labels(raw), save_frame_data=True, image_format=fmt)
        with h5py.File(path, "r") as fm, h5py.File(ref, "r") as fr:
            np.testing.assert_array_equal(fm["video0/video"][()], fr["video0/video"][()])
            np.testing.assert_array_equal(fm["video0/frame_numbers"][()], fr["video0/frame_numbers"][()])
            assert fm["video0/video"].attrs["format"] in (fmt.encode(), fmt)
            assert fr["video0/video"].attrs["format"] == fmt
        video = jslp.read_labels(path).videos[0]
        assert video.backend.embedded_frame_inds == [1, 2]
        if fmt != "jpg":  # lossless
            np.testing.assert_array_equal(video.get_frame(2), frames[2])
    labels = _port_project(np.zeros((2, 8, 8, 1), np.uint8))
    with pytest.raises(NotImplementedError, match="'webp'"):
        labels.save(str(tmp_path / "y.pkg.slp"), with_images=True, image_format="webp", device="cpu")
    assert not (tmp_path / "y.pkg.slp").exists()


def test_labels_lookups():
    labels = _port_project(np.zeros((4, 8, 8, 1), np.uint8))
    video = labels.video
    assert [lf.frame_idx for lf in labels.find(video)] == [0, 1, 2, 3]
    assert labels.find(video, 2)[0] is labels[2]
    assert labels.find(video, 9) == [] and labels.find(video, [2, 9]) == [labels[2]]
    assert labels.find_first(video, 7) is None
    n = len(labels)
    labels.remove_empty_frames()
    assert len(labels) == n - 1


# --------------------------------------------------------------------------- #
# Video backends
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("path", FIXTURES, ids=_rel)
def test_hdf5_video_frames_match_jax(path):
    mine, ref = slp.read_labels(path, device="cpu").video, jslp.read_labels(path).videos[0]
    assert mine.shape == ref.shape
    assert mine.backend.has_embedded_images == ref.backend.has_embedded_images
    assert mine.backend.embedded_frame_inds == ref.backend.embedded_frame_inds
    assert mine.backend.last_frame_idx == ref.backend.last_frame_idx
    for i in range(mine.num_frames):
        a, b = mine.get_frame(i), ref.get_frame(i)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # A frame the file lacks: raw rows end, and an embedded package falls
    # back to its (here in-memory, so missing) source video, in both.
    errors = []
    for video in (mine, ref):
        with pytest.raises((IndexError, FileNotFoundError)) as err:
            video.get_frame(99)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


def test_hdf5_video_layouts_match_jax(tmp_path):
    path = str(tmp_path / "videos.h5")
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f.create_dataset("first", data=rng.integers(0, 255, (3, 3, 10, 12), np.uint8))
        f.create_dataset("unit", data=rng.random((2, 6, 5, 1)).astype("f4"))
    for dataset, fmt, convert in (("first", "channels_first", False), ("unit", "channels_last", True)):
        mine = tvideo.Video.from_filename(path, dataset=dataset, input_format=fmt, convert_range=convert)
        ref = jvideo.Video.from_filename(path, dataset=dataset, input_format=fmt, convert_range=convert)
        assert mine.shape == ref.shape
        np.testing.assert_array_equal(mine[:], ref[:])
        assert mine.to_dict() == ref.to_dict()
    with pytest.raises(KeyError, match="missing"):
        tvideo.Video.from_filename(path, dataset="missing").get_frame(0)


def _write_mp4(path, frames):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, frames.shape[2:0:-1])
    for f in frames:
        writer.write(f)
    writer.release()


def test_media_video_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    frames = np.zeros((6, 48, 64, 3), np.uint8)
    frames[:, 10:30, 20:40] = rng.integers(60, 200, (6, 1, 1, 3))
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, frames)
    mine, ref = tvideo.load_video(path, device="cpu"), jvideo.load_video(path)
    assert isinstance(mine.backend, tvideo.MediaVideo)
    assert mine.shape == ref.shape and mine.backend.fps == ref.backend.fps
    for i in (0, 3, 1, 5):  # out of order: seeks
        np.testing.assert_array_equal(mine.get_frame(i), ref.get_frame(i))
    assert mine.to_dict() == ref.to_dict()
    gray = tvideo.Video.from_filename(path, grayscale=True, device="cpu")
    np.testing.assert_array_equal(gray.get_frame(2), jvideo.Video.from_filename(
        path, grayscale=True).get_frame(2))
    # reset() without a grayscale argument detects it again from the file.
    gray.backend.reset()
    assert gray.backend.grayscale is None and gray.channels == 3


def test_single_image_video_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"img{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 255, (20, 30, 3), np.uint8))
    mine, ref = tvideo.load_video(str(tmp_path), device="cpu"), jvideo.load_video(str(tmp_path))
    assert mine.shape == ref.shape
    np.testing.assert_array_equal(mine[:], ref[:])
    assert mine.to_dict() == ref.to_dict()


def test_videos_from_dicts_match_jax(tmp_path):
    np.save(tmp_path / "frames.npy", np.arange(2 * 4 * 5, dtype=np.uint8).reshape(2, 4, 5))
    dicts = [
        {"backend": {"filename": "x.mp4", "grayscale": True, "bgr": True, "dataset": "",
                     "input_format": "", "type": "MediaVideo"}},
        {"backend": {"filename": "x.slp", "dataset": "video0/video", "input_format": "channels_last",
                     "convert_range": False}},
        {"backend": {"filename": "x.unknown"}},
        {"backend": {"filename": "", "height": 7, "width": 9, "frames": 3, "channels": 1,
                     "dummy": True}},
        {"backend": {"filename": "a.png", "filenames": ["a.png", "b.png"], "grayscale": None}},
        {"backend": {"filename": str(tmp_path / "frames.npy")}},
    ]
    for d in dicts:
        mine, ref = tvideo.Video.from_dict(json.loads(json.dumps(d))), jvideo.Video.from_dict(d)
        assert type(mine.backend).__name__ == type(ref.backend).__name__
        assert mine.to_dict() == ref.to_dict()
        assert mine.is_missing == ref.is_missing
    npy = tvideo.Video.from_dict(dicts[-1])
    np.testing.assert_array_equal(npy[:], jvideo.Video.from_dict(dicts[-1])[:])
    dummy = tvideo.Video.from_dict(dicts[3])
    assert dummy.shape == (3, 7, 9, 1) and not dummy.get_frame(0).any()
    # An ImgStore entry builds an ImgStoreVideo, which opens its store: a
    # missing one raises as in the JAX package.
    store = {"backend": {"filename": str(tmp_path / "store"), "type": "ImgStoreVideo"}}
    errors = []
    for build in (tvideo.Video.from_dict, jvideo.Video.from_dict):
        with pytest.raises(OSError) as err:
            build(store)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


def test_cv2_backends_without_cv2_raise_naming_it(tmp_path, monkeypatch):
    path = str(tmp_path / "clip.mp4")
    _write_mp4(path, np.zeros((2, 16, 16, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        tvideo.load_video(path, device="cpu").get_frame(0)
    # BMP stills, and PNG frames embedded in a .slp, decode without cv2.
    bmp_path = tmp_path / "a.bmp"
    bmp_path.write_bytes(bmp.imencode(np.full((3, 5, 3), 7, np.uint8)))
    assert tvideo.Video.from_filename(str(bmp_path), device="cpu").get_frame(0).shape == (3, 5, 3)
    assert slp.read_labels(FIXTURES[1], device="cpu").video.get_frame(3).shape == (384, 384, 1)


def test_size_matching_without_cv2_raises_naming_it(monkeypatch):
    """Frames of videos that differ in size are resized as the JAX package
    resizes them with cv2, and without cv2 too: inference and training no
    longer need it (the port's own ``resize_linear_uint8``; the bitwise
    sweep is ``tests/test_torch_resize.py``)."""
    from sleap_tpu.data.providers import resize_and_pad_example as jax_resize
    from sleap_tpu.training.trainer import size_match_image as jax_match
    from sleap_tpu_torch.data.providers import resize_and_pad_example
    from sleap_tpu_torch.training.trainer import size_match_image

    img = np.random.default_rng(0).integers(0, 255, (30, 40, 1), np.uint8)
    want = {resize_and_pad_example: jax_resize(img, (48, 48)),
            size_match_image: jax_match(img, (48, 48))}
    assert resize_and_pad_example(img, (30, 40))[0] is img
    monkeypatch.setitem(sys.modules, "cv2", None)
    for resize in (resize_and_pad_example, size_match_image):
        got = resize(img, (48, 48))
        np.testing.assert_array_equal(got[0], want[resize][0])
        assert got[1] == want[resize][1]


def test_fixup_path(tmp_path, monkeypatch):
    (tmp_path / "clip.mp4").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    for search in (None, [str(tmp_path)]):
        assert tvideo.fixup_path("/elsewhere/clip.mp4", search) == jvideo.fixup_path(
            "/elsewhere/clip.mp4", search)
    assert tvideo.fixup_path("/nowhere/other.mp4") == "/nowhere/other.mp4"


# --------------------------------------------------------------------------- #
# Providers
# --------------------------------------------------------------------------- #


def test_providers_select_frames():
    labels = slp.read_labels(FIXTURES[0])
    reader = LabelsReader(labels, example_indices=[5, 2])
    examples = list(reader)
    assert len(reader) == 2 and [ex["frame_ind"] for ex in examples] == [5, 2]
    assert examples[0]["instances"].shape == (2, 2, 2)
    np.testing.assert_array_equal(examples[0]["instances"][1], labels[5].instances[1].numpy())
    video = VideoReader.from_filepath(FIXTURES[0], example_indices=[1, 7], dataset="video0_raw")
    assert len(video) == 2 and [ex["frame_ind"] for ex in video] == [1, 7]
    np.testing.assert_array_equal(next(iter(video))["image"], labels.video.get_frame(1))


def test_unlabeled_suggestions_reader():
    labels = _port_project(np.zeros((4, 8, 8, 1), np.uint8))
    video = labels.video
    labels.suggestions = [SuggestionFrame(video, 3), SuggestionFrame(video, 1),
                          SuggestionFrame(video, 0)]
    reader = LabelsReader.from_unlabeled_suggestions(labels)
    # Frame 0 has only a prediction, 1 a user instance, 3 is labeled empty.
    assert [ex["frame_ind"] for ex in reader] == [3, 0]
    assert reader.videos == labels.videos


def test_trainer_reads_slp_paths():
    from sleap_tpu_torch.config import LabelsConfig
    from sleap_tpu_torch.training.trainer import DataReaders

    readers = DataReaders.from_config(LabelsConfig(), training=FIXTURES[0], validation=FIXTURES[1])
    assert len(readers.training_labels) == len(readers.validation_labels) == 8
    assert len(readers.training_labels.user_instances) == 16


@pytest.mark.parametrize("seed", [0, 3])
def test_user_instances_reader_matches_jax(seed):
    """``from_user_instances`` on the same seeded project in each package:
    the same frames, each with its training instances (user instances and
    unlabeled predictions), the same instances removed from the project,
    and ``is_from_multi_size_videos`` alike."""
    from sleap_tpu.data.providers import LabelsReader as JReader
    from test_torch_data_model import JAX, TORCH, make_project

    results = []
    for P, Reader in ((TORCH, LabelsReader), (JAX, JReader)):
        labels = make_project(P, seed, two_skeletons=False)
        reader = Reader.from_user_instances(labels)
        assert reader.user_instances_only
        frames = [(ex["video_ind"], ex["frame_ind"], ex["instances"]) for ex in reader]
        multi = [reader.is_from_multi_size_videos]
        labels.videos[1].backend.height = 32  # make the two videos differ in size
        multi.append(reader.is_from_multi_size_videos)
        results.append((list(reader.example_indices), len(labels), multi, frames))
    (mine_inds, mine_n, mine_multi, mine), (ref_inds, ref_n, ref_multi, ref) = results
    assert (mine_inds, mine_n, mine_multi) == (ref_inds, ref_n, ref_multi) and mine_multi == [False, True]
    assert len(mine) == len(ref) > 0
    for (gv, gf, gi), (wv, wf, wi) in zip(mine, ref):
        assert (gv, gf) == (wv, wf)
        np.testing.assert_array_equal(gi, wi)
