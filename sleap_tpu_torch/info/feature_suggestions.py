"""Image-feature labeling suggestions: :mod:`sleap_tpu.info.feature_suggestions`
on the port's videos.

Frames are sampled from each video, each becomes a feature vector ("raw":
its 32 x 32 downsampled pixels; "hog": a 4 x 4-cell histogram of gradient
orientations of those; "brisk": the mean binary descriptor of its
keypoints), the vectors are reduced by PCA and clustered by k-means, and a
few frames of each cluster are suggested.

The gray conversion and the resizes are OpenCV's, bit for bit, without cv2:
``COLOR_RGB2GRAY``'s fixed-point rule (:func:`rgb_to_gray_uint8`) and
``INTER_LINEAR`` (:func:`sleap_tpu_torch.data.resizing.resize_linear_uint8`);
the gradients are ``cv2.Sobel``'s 3 x 3 kernels with ``BORDER_REFLECT_101``
in numpy (:func:`sobel_3x3`). Frames are uint8, as the port's videos give
them. "brisk" needs OpenCV's detectors and imports ``cv2`` inside; PCA and
k-means are scikit-learn's, imported inside, with the JAX package's calls,
so the suggestions are the same. Where either package is absent, the
function that needs it raises ``ImportError`` naming it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from sleap_tpu_torch.core.labels import SuggestionFrame
from sleap_tpu_torch.data.resizing import resize_linear_uint8
from sleap_tpu_torch.io.video import Video

logger = logging.getLogger(__name__)

# OpenCV's RGB -> gray weights for 8-bit pixels: 15-bit fixed point.
_GRAY_SHIFT = 15
_GRAY_RGB = (9798, 19235, 3735)


def rgb_to_gray_uint8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of a uint8 (H, W, 3) image:
    ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    x = img.astype(np.int32)
    r, g, b = _GRAY_RGB
    return ((x[..., 0] * r + x[..., 1] * g + x[..., 2] * b + (1 << (_GRAY_SHIFT - 1)))
            >> _GRAY_SHIFT).astype(np.uint8)


def sobel_3x3(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """``cv2.Sobel(img, cv2.CV_32F, dx, dy)`` of a float32 (H, W) image for
    (dx, dy) (1, 0) or (0, 1): the derivative ``[-1, 0, 1]`` along one axis
    and the smoothing ``[1, 2, 1]`` along the other, with the border
    reflected without repeating the edge (``BORDER_REFLECT_101``)."""
    p = np.pad(np.asarray(img, np.float32), 1, mode="reflect")
    if (dx, dy) == (1, 0):
        d = p[:, 2:] - p[:, :-2]
        return d[:-2] + np.float32(2) * d[1:-1] + d[2:]
    if (dx, dy) == (0, 1):
        s = p[:, :-2] + np.float32(2) * p[:, 1:-1] + p[:, 2:]
        return s[2:] - s[:-2]
    raise ValueError(f"sobel_3x3 takes (dx, dy) (1, 0) or (0, 1), not {(dx, dy)}.")


def hog_features(img: np.ndarray) -> np.ndarray:
    """The "hog" feature of a uint8 (H, W) image: its 32 x 32 resize, the
    Sobel gradients' magnitudes summed into 9 unsigned orientation bins in
    each of 4 x 4 cells of 8 x 8 pixels (144 values)."""
    resized = resize_linear_uint8(img, (32, 32)).astype("f4")
    gx = sobel_3x3(resized, 1, 0)
    gy = sobel_3x3(resized, 0, 1)
    mag = np.hypot(gx, gy)
    ang = (np.arctan2(gy, gx) % np.pi) / np.pi * 9
    bins = np.clip(ang.astype(int), 0, 8)
    feat = []
    for cy in range(4):
        for cx in range(4):
            m = mag[cy * 8:(cy + 1) * 8, cx * 8:(cx + 1) * 8]
            b = bins[cy * 8:(cy + 1) * 8, cx * 8:(cx + 1) * 8]
            feat.append(np.bincount(b.ravel(), m.ravel(), minlength=9))
    return np.concatenate(feat).astype("f4")


def _import_sklearn():
    try:
        from sklearn.cluster import KMeans
        from sklearn.decomposition import PCA
    except ImportError as e:
        raise ImportError(
            "Image-feature suggestions need scikit-learn for PCA and k-means "
            "(pip install scikit-learn)."
        ) from e
    return PCA, KMeans


@dataclass
class FrameItem:
    video: Video
    frame_idx: int


@dataclass
class FeatureSuggestionPipeline:
    """Sample, featurize, PCA, k-means, then the first ``per_cluster``
    frames of each cluster."""

    per_video: int = 20
    sample_method: str = "stride"  # "stride" | "random"
    scale: float = 1.0
    merge_video_features: str = "across all videos"
    feature_type: str = "raw"  # "raw" | "brisk" | "hog"
    brisk_threshold: int = 40
    vocab_size: int = 20
    n_components: int = 5
    n_clusters: int = 5
    per_cluster: int = 5

    def get_sample_idxs(self, video: Video) -> List[int]:
        n = video.num_frames
        count = min(self.per_video, n)
        if self.sample_method == "random":
            rng = np.random.default_rng(0)
            return sorted(rng.choice(n, size=count, replace=False).tolist())
        return np.linspace(0, n - 1, count).astype(int).tolist()

    def _frame_feature(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3 and img.shape[-1] == 3:
            img = rgb_to_gray_uint8(img)
        elif img.ndim == 3:
            img = img[..., 0]
        if self.scale != 1.0:
            img = resize_linear_uint8(img, fx=self.scale, fy=self.scale)
        if self.feature_type == "brisk":
            return self._brisk_feature(img)
        if self.feature_type == "hog":
            return hog_features(img)
        return resize_linear_uint8(img, (32, 32)).ravel().astype("f4")  # raw pixels

    @staticmethod
    def _brisk_feature(img: np.ndarray) -> np.ndarray:
        """The mean BRISK (else ORB) descriptor of the image's keypoints, as
        the JAX package computes it with OpenCV."""
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "The 'brisk' image feature needs OpenCV's keypoint detectors "
                "(pip install opencv-python-headless)."
            ) from e
        factory = getattr(cv2, "BRISK_create", None) or getattr(cv2, "ORB_create", None)
        if factory is None:
            return resize_linear_uint8(img, (32, 32)).ravel().astype("f4")
        _, descriptors = factory().detectAndCompute(img, None)
        if descriptors is None or len(descriptors) == 0:
            return np.zeros(32, "f4")
        return descriptors.mean(axis=0).astype("f4")

    def get_suggestion_frames(self, videos: List[Video], group_offset: int = 0) -> List[SuggestionFrame]:
        PCA, KMeans = _import_sklearn()

        items: List[FrameItem] = []
        feats: List[np.ndarray] = []
        for video in videos:
            for fi in self.get_sample_idxs(video):
                try:
                    img = video.get_frame(fi)
                except Exception:
                    continue
                items.append(FrameItem(video, fi))
                feats.append(self._frame_feature(np.asarray(img)))
        if not items:
            return []
        X = np.stack(feats)
        n_comp = min(self.n_components, X.shape[0], X.shape[1])
        if n_comp >= 1 and X.shape[0] > 1:
            X = PCA(n_components=n_comp).fit_transform(X)
        n_clusters = min(self.n_clusters, len(items))
        clusters = KMeans(n_clusters=n_clusters, n_init=3, random_state=0).fit_predict(X)

        suggestions = []
        for ci in range(n_clusters):
            for mi in np.where(clusters == ci)[0][: self.per_cluster]:
                suggestions.append(SuggestionFrame(video=items[mi].video, frame_idx=items[mi].frame_idx,
                                                   group=ci + group_offset))
        return suggestions


def _suggest_one_video(args) -> List[tuple]:
    """A pool worker: the pipeline on one video, rebuilt from its filename,
    as (video_idx, frame_idx, group) tuples."""
    pipeline_kwargs, video_idx, filename, video_kwargs = args
    pipeline = FeatureSuggestionPipeline(**pipeline_kwargs)
    video = Video.from_filename(filename, **video_kwargs)
    suggestions = pipeline.get_suggestion_frames([video], group_offset=video_idx * pipeline.n_clusters)
    return [(video_idx, s.frame_idx, s.group) for s in suggestions]


class ParallelFeaturePipeline:
    """The pipeline on each video in a pool of processes: each worker
    rebuilds its video from the filename, on the parent video's ``device``
    (so a CPU caller's workers never touch CUDA), and the parent makes the
    ``SuggestionFrame``s of its own videos. One job, videos with no file
    (numpy-backed) and parents that a worker cannot re-import (an
    interactive session) run in this process."""

    @classmethod
    def run(cls, pipeline: FeatureSuggestionPipeline, videos: List[Video],
            parallel: bool = True) -> List[SuggestionFrame]:
        pipeline_kwargs = dataclasses.asdict(pipeline)
        jobs, serial_idxs = [], []
        for vi, video in enumerate(videos):
            fn = getattr(video.backend, "filename", None)
            if parallel and isinstance(fn, str):
                kwargs = {}
                dataset = getattr(video.backend, "dataset", None)
                if dataset:
                    kwargs["dataset"] = dataset
                device = getattr(video.backend, "device", None)
                if device is not None:
                    kwargs["device"] = str(device)
                jobs.append((pipeline_kwargs, vi, fn, kwargs))
            else:
                serial_idxs.append(vi)

        tuples: List[tuple] = []
        if jobs:
            import __main__

            main_file = getattr(__main__, "__file__", None)
            spawnable = main_file is None or os.path.exists(main_file)
            if len(jobs) == 1 or not spawnable:
                for job in jobs:
                    tuples.extend(_suggest_one_video(job))
            else:
                # Forkserver, not fork: the parent may hold CUDA and torch
                # threads, and a forked child of a threaded parent can hang.
                import multiprocessing

                try:
                    ctx = multiprocessing.get_context("forkserver")
                except ValueError:  # a platform without forkserver
                    ctx = multiprocessing.get_context("spawn")
                with ctx.Pool(processes=min(len(jobs), 4)) as pool:
                    for result in pool.map(_suggest_one_video, jobs):
                        tuples.extend(result)
        suggestions = [SuggestionFrame(video=videos[vi], frame_idx=fi, group=g) for vi, fi, g in tuples]
        for vi in serial_idxs:
            suggestions.extend(pipeline.get_suggestion_frames([videos[vi]], group_offset=vi * pipeline.n_clusters))
        return suggestions
