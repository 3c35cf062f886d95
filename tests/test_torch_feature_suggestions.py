"""The port's image-feature suggestions (``sleap_tpu_torch.info.feature_suggestions``)
against the JAX package's, as ``tests/test_feature_suggestions.py`` tests
the JAX ones, on the CPU:

- the gray conversion and the "raw" feature (32 x 32 pixels, and the
  ``scale`` resize before it) bitwise equal to cv2's ``COLOR_RGB2GRAY`` and
  ``cv2.resize``; the Sobel gradients of "hog" within 1e-5 of ``cv2.Sobel``
  and its 144-bin histogram within 1e-5 of the JAX package's, every pixel in
  the same bin;
- the suggestions of the three feature types, stride and random sampling,
  gray and RGB videos, equal to the JAX package's (same frames, same
  groups), with scikit-learn's PCA and k-means on both sides;
- ``ParallelFeaturePipeline.run`` on two HDF5 videos on disk (a forkserver
  pool whose workers rebuild each video on the parent's device, here the
  CPU) and on numpy videos (in process), equal to the JAX package's;
- the ``ImportError`` naming scikit-learn, or OpenCV for "brisk", where
  the package is absent.
"""

from __future__ import annotations

import sys
import warnings

import cv2
import h5py
import numpy as np
import pytest

from sleap_tpu.info import feature_suggestions as j_fs
from sleap_tpu.io.video import Video as JVideo
from sleap_tpu_torch.info import feature_suggestions as t_fs
from sleap_tpu_torch.io.video import Video as TVideo


def frames(seed: int, n: int = 12, hw=(32, 32), channels: int = 1) -> np.ndarray:
    """Seeded frames with a blob that moves, over noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    out = np.empty((n, h, w, channels), np.uint8)
    for i in range(n):
        cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        blob = 200 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (0.1 * w) ** 2))
        for c in range(channels):
            out[i, ..., c] = np.clip(blob * (1 - 0.2 * c) + rng.integers(0, 40, (h, w)), 0, 255)
    return out


def test_gray_conversion_is_bitwise_cv2():
    rng = np.random.default_rng(0)
    # Every (R, G, B) triple once, then seeded frames of odd sizes.
    grid = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"), -1).reshape(4096, 4096, 3)
    images = [grid.astype(np.uint8)] + [rng.integers(0, 256, (h, w, 3), np.uint8)
                                         for h, w in ((1, 1), (37, 41), (120, 97))]
    for img in images:
        np.testing.assert_array_equal(t_fs.rgb_to_gray_uint8(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.7, 1.25])
@pytest.mark.parametrize("shape", [(32, 32, 1), (45, 61, 3), (97, 33, 1), (20, 20, 3)])
def test_raw_feature_is_bitwise_cv2(shape, scale):
    img = frames(sum(shape), n=1, hw=shape[:2], channels=shape[2])[0]
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if shape[2] == 3 else img[..., 0]
    if scale != 1.0:
        gray = cv2.resize(gray, None, None, scale, scale)
    want = cv2.resize(gray, (32, 32)).ravel().astype("f4")
    got = t_fs.FeatureSuggestionPipeline(feature_type="raw", scale=scale)._frame_feature(img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_fs.FeatureSuggestionPipeline(feature_type="raw", scale=scale)
                                  ._frame_feature(img))


@pytest.mark.parametrize("seed", range(4))
def test_hog_feature_matches_cv2_and_jax(seed):
    img = frames(seed, n=1, hw=(48 + seed, 40 + 3 * seed), channels=1 + 2 * (seed % 2))[0]
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.shape[2] == 3 else img[..., 0]
    small = cv2.resize(gray, (32, 32)).astype("f4")
    gx, gy = t_fs.sobel_3x3(small, 1, 0), t_fs.sobel_3x3(small, 0, 1)
    ref_gx, ref_gy = cv2.Sobel(small, cv2.CV_32F, 1, 0), cv2.Sobel(small, cv2.CV_32F, 0, 1)
    np.testing.assert_allclose(gx, ref_gx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gy, ref_gy, rtol=0, atol=1e-5)

    def bins(x, y):
        return np.clip(((np.arctan2(y, x) % np.pi) / np.pi * 9).astype(int), 0, 8)

    np.testing.assert_array_equal(bins(gx, gy), bins(ref_gx, ref_gy))
    got = t_fs.FeatureSuggestionPipeline(feature_type="hog")._frame_feature(img)
    want = j_fs.FeatureSuggestionPipeline(feature_type="hog")._frame_feature(img)
    assert got.shape == want.shape == (144,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _keyed(videos, suggestions):
    # By identity: the JAX package's in-memory videos all compare equal once read.
    return [([v is s.video for v in videos].index(True), s.frame_idx, s.group) for s in suggestions]


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # k-means may find fewer distinct clusters
        return fn(*args, **kwargs)


PIPELINES = {
    "raw stride": dict(per_video=8, n_clusters=3, per_cluster=2, feature_type="raw"),
    "hog stride": dict(per_video=8, n_clusters=3, per_cluster=2, feature_type="hog"),
    "brisk stride": dict(per_video=8, n_clusters=3, per_cluster=2, feature_type="brisk"),
    "raw random scaled": dict(per_video=10, n_clusters=4, per_cluster=3, feature_type="raw",
                              sample_method="random", scale=0.5),
    "hog rgb": dict(per_video=12, n_clusters=2, per_cluster=4, feature_type="hog"),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_suggestions_match_jax(name):
    channels = 3 if "rgb" in name else 1
    data = [frames(7, n=12, hw=(40, 36), channels=channels), frames(8, n=9, hw=(40, 36), channels=channels)]
    results = []
    for mod, Video in ((t_fs, TVideo), (j_fs, JVideo)):
        videos = [Video.from_numpy(d) for d in data]
        pipeline = mod.FeatureSuggestionPipeline(**PIPELINES[name])
        got = _quiet(pipeline.get_suggestion_frames, videos)
        assert got and all(0 <= s.group < pipeline.n_clusters for s in got)
        results.append(_keyed(videos, got))
    assert results[0] == results[1]


def test_parallel_pipeline_on_disk_videos_matches_jax(tmp_path):
    paths = []
    for i in range(2):
        path = str(tmp_path / f"v{i}.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("video", data=frames(20 + i, n=10, hw=(32, 32)))
        paths.append(path)
    results = []
    for mod, make in ((t_fs, lambda p: TVideo.from_filename(p, dataset="video", device="cpu")),
                      (j_fs, lambda p: JVideo.from_filename(p, dataset="video"))):
        videos = [make(p) for p in paths]
        pipeline = mod.FeatureSuggestionPipeline(per_video=6, n_clusters=2, per_cluster=2)
        got = _quiet(mod.ParallelFeaturePipeline.run, pipeline, videos)
        # Group offsets separate the two videos' clusters, and the
        # suggestions hold the parent's video objects.
        groups = [{s.group for s in got if s.video is v} for v in videos]
        assert groups[0] and groups[1] and not groups[0] & groups[1]
        assert all(any(s.video is v for v in videos) for s in got)
        results.append(_keyed(videos, got))
    assert results[0] == results[1]


def test_parallel_pipeline_keeps_numpy_videos_in_process():
    results = []
    for mod, Video in ((t_fs, TVideo), (j_fs, JVideo)):
        videos = [Video.from_numpy(np.random.default_rng(i).integers(0, 255, (10, 24, 24, 1), np.uint8))
                  for i in range(2)]
        pipeline = mod.FeatureSuggestionPipeline(per_video=6, n_clusters=2, per_cluster=2)
        got = _quiet(mod.ParallelFeaturePipeline.run, pipeline, videos)
        assert len(got) >= 2
        results.append(_keyed(videos, got))
    assert results[0] == results[1]


def test_workers_rebuild_videos_on_the_parents_device(tmp_path, monkeypatch):
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("video", data=frames(3, n=6))
    jobs = []
    monkeypatch.setattr(t_fs, "_suggest_one_video", lambda job: jobs.append(job) or [])
    t_fs.ParallelFeaturePipeline.run(t_fs.FeatureSuggestionPipeline(),
                                     [TVideo.from_filename(path, dataset="video", device="cpu")])
    assert jobs[0][2:] == (path, {"dataset": "video", "device": "cpu"})


@pytest.mark.parametrize("missing", ["sklearn", "cv2"])
def test_absent_packages_are_named(missing, monkeypatch):
    names = ("sklearn", "sklearn.cluster", "sklearn.decomposition") if missing == "sklearn" else ("cv2",)
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)
    video = TVideo.from_numpy(frames(1, n=6))
    if missing == "sklearn":
        with pytest.raises(ImportError, match="scikit-learn"):
            t_fs.FeatureSuggestionPipeline(per_video=4, n_clusters=2).get_suggestion_frames([video])
    else:
        with pytest.raises(ImportError, match="OpenCV"):
            t_fs.FeatureSuggestionPipeline(feature_type="brisk")._frame_feature(video.get_frame(0))
        # The other features need no cv2.
        assert t_fs.FeatureSuggestionPipeline(feature_type="hog")._frame_feature(video.get_frame(0)).shape == (144,)
