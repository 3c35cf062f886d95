"""Labeling suggestions (port of :mod:`sleap_tpu.info.suggestions`).

Given a ``Labels`` project, propose frames worth labeling or proofreading
by one of six methods, each skipping frames already suggested:

- ``sample``: random or strided frames per video;
- ``image_features``: raw-image or feature PCA and k-means
  (:mod:`sleap_tpu_torch.info.feature_suggestions`; needs scikit-learn);
- ``prediction_score``: frames whose count of low-scoring predicted
  instances lies in a band;
- ``velocity``: frames where a node's displacement series spikes;
- ``frame_chunk``: an explicit 1-based [from, to] frame range;
- ``max_point_displacement``: frames whose mean per-track point
  displacement exceeds a threshold.

Host Python and numpy on the port's ``Labels``; ``sample`` draws from
Python's ``random``, as the JAX module does.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Union

import numpy as np

from sleap_tpu_torch.core.labels import Labels, SuggestionFrame
from sleap_tpu_torch.io.video import Video


class VideoFrameSuggestions:
    """Dispatch to a suggestion method by name."""

    @classmethod
    def suggest(cls, params: dict, labels: Labels = None) -> List[SuggestionFrame]:
        methods = {
            "sample": cls.basic_sample_suggestion_method,
            "image_features": cls.image_feature_based_method,
            "prediction_score": cls.prediction_score,
            "velocity": cls.velocity,
            "frame_chunk": cls.frame_chunk,
            "max_point_displacement": cls.max_point_displacement,
        }
        method = str(params["method"]).replace(" ", "_")
        if method not in methods:
            raise ValueError(
                f"No {method} method found for generating suggestions."
            )
        return methods[method](labels=labels, **params)

    # ------------------------------------------------------------------ #
    @classmethod
    def basic_sample_suggestion_method(
        cls,
        labels: Labels,
        videos: List[Video],
        per_video: int = 20,
        sampling_method: str = "random",
        **kwargs,
    ) -> List[SuggestionFrame]:
        """Random or strided frames per video, skipping existing suggestions."""
        existing = _existing_idx_by_video(labels)
        suggestions: List[SuggestionFrame] = []
        for video in videos:
            unique_idx = sorted(
                set(range(video.frames)) - set(existing.get(video, ()))
            )
            n = len(unique_idx)
            if n == 0:
                continue
            if sampling_method == "stride":
                step = max(1, n // per_video)
                picked = unique_idx[::step][:per_video]
            elif n == 1:
                picked = unique_idx
            else:
                picked = random.sample(unique_idx, min(per_video, n))
            group = labels.videos.index(video) if video in labels.videos else None
            suggestions.extend(
                SuggestionFrame(video, int(i), group) for i in picked
            )
        return suggestions

    @classmethod
    def image_feature_based_method(
        cls,
        labels: Labels,
        videos: List[Video],
        per_video: int,
        sample_method: str,
        scale: float,
        merge_video_features: str,
        feature_type: str,
        pca_components: int,
        n_clusters: int,
        per_cluster: int,
        **kwargs,
    ) -> List[SuggestionFrame]:
        """The image-feature pipeline (raw pixels, HOG or BRISK features,
        PCA, k-means; :mod:`sleap_tpu_torch.info.feature_suggestions`), over
        all videos at once or per video, less the frames already suggested."""
        from sleap_tpu_torch.info.feature_suggestions import (
            FeatureSuggestionPipeline,
            ParallelFeaturePipeline,
        )

        pipeline = FeatureSuggestionPipeline(
            per_video=per_video,
            scale=scale,
            sample_method=sample_method,
            feature_type=feature_type,
            brisk_threshold=kwargs.get("brisk_threshold", 80),
            vocab_size=kwargs.get("vocab_size", 20),
            n_components=pca_components,
            n_clusters=n_clusters,
            per_cluster=per_cluster,
        )
        if merge_video_features == "across all videos":
            proposed = pipeline.get_suggestion_frames(videos=videos)
        else:
            proposed = ParallelFeaturePipeline.run(pipeline, videos)
        return cls.filter_unique_suggestions(labels, videos, proposed)

    @classmethod
    def prediction_score(
        cls,
        labels: Labels,
        videos: List[Video],
        score_limit: float,
        instance_limit_upper: int,
        instance_limit_lower: int,
        **kwargs,
    ) -> List[SuggestionFrame]:
        """Frames whose count of instances scoring <= ``score_limit`` lies in
        [instance_limit_lower, instance_limit_upper]."""
        score_limit = float(score_limit)
        lo, hi = int(instance_limit_lower), int(instance_limit_upper)
        proposed: List[SuggestionFrame] = []
        for video in videos:
            idxs = []
            for lf in labels.find(video):
                scores = np.array(
                    [
                        inst.score
                        for inst in lf.instances_to_show
                        if hasattr(inst, "score")
                    ],
                    dtype=float,
                )
                n_low = int(np.nansum(scores <= score_limit))
                if lo <= n_low <= hi:
                    idxs.append(lf.frame_idx)
            proposed.extend(
                SuggestionFrame(video, int(i)) for i in sorted(idxs)
            )
        return cls.filter_unique_suggestions(labels, videos, proposed)

    @classmethod
    def velocity(
        cls,
        labels: Labels,
        videos: List[Video],
        node: Union[int, str],
        threshold: float,
        **kwargs,
    ) -> List[SuggestionFrame]:
        """Frames where the node displacement series rises more than
        ``threshold`` * range above its minimum."""
        from sleap_tpu_torch.info.summary import StatisticSeries

        if isinstance(node, str):
            node_name = node
        else:
            try:
                node_name = labels.skeletons[0].nodes[node].name
            except IndexError:
                node_name = ""
        proposed: List[SuggestionFrame] = []
        series = StatisticSeries(labels)
        for video in videos:
            disp = series.get_primary_point_displacement_series(
                video=video, reduction="sum", primary_node=node_name
            )
            disp = np.asarray(disp, dtype=float)
            if disp.size == 0:
                continue
            spread = np.ptp(disp)
            picked = np.argwhere(disp - disp.min() > spread * threshold)
            proposed.extend(
                SuggestionFrame(video, int(i)) for i in np.squeeze(picked, -1)
            )
        return cls.filter_unique_suggestions(labels, videos, proposed)

    @classmethod
    def max_point_displacement(
        cls,
        labels: Labels,
        videos: List[Video],
        displacement_threshold: float,
        **kwargs,
    ) -> List[SuggestionFrame]:
        """Frames whose mean per-track point displacement from the previous
        frame exceeds the threshold for any track."""
        proposed: List[SuggestionFrame] = []
        for video in videos:
            pts = labels.numpy(video=video, all_frames=True, untracked=False)
            if pts.shape[0] < 2:
                continue
            diff = pts[1:] - pts[:-1]  # (frames-1, tracks, nodes, 2)
            per_node = np.linalg.norm(diff, axis=-1)
            # nanmean without the all-NaN RuntimeWarning (empty tracks).
            valid = np.isfinite(per_node)
            per_track = np.where(
                valid.any(axis=-1),
                np.where(valid, per_node, 0.0).sum(axis=-1)
                / np.maximum(valid.sum(axis=-1), 1),
                np.nan,
            )  # (frames-1, tracks)
            hit = np.any(per_track > displacement_threshold, axis=-1)
            proposed.extend(
                SuggestionFrame(video, int(i) + 1)
                for i in np.argwhere(hit).flatten()
            )
        return cls.filter_unique_suggestions(labels, videos, proposed)

    @classmethod
    def frame_chunk(
        cls,
        labels: Labels,
        videos: List[Video],
        frame_from: int,
        frame_to: int,
        **kwargs,
    ) -> List[SuggestionFrame]:
        """1-based inclusive [frame_from, frame_to] chunk."""
        proposed: List[SuggestionFrame] = []
        if frame_from > frame_to:
            return proposed
        for video in videos:
            if frame_from > video.frames:
                continue
            stop = min(frame_to, video.frames)
            proposed.extend(
                SuggestionFrame(video, i) for i in range(frame_from - 1, stop)
            )
        return cls.filter_unique_suggestions(labels, videos, proposed)

    # ------------------------------------------------------------------ #
    @staticmethod
    def idx_list_to_frame_list(
        idx_list, video: Video, group: Optional[int] = None
    ) -> List[SuggestionFrame]:
        return [SuggestionFrame(video, int(i), group) for i in idx_list]

    @staticmethod
    def filter_unique_suggestions(
        labels: Labels,
        videos: List[Video],
        proposed_suggestions: List[SuggestionFrame],
    ) -> List[SuggestionFrame]:
        existing = _existing_idx_by_video(labels)
        return [
            s
            for s in proposed_suggestions
            if s.frame_idx not in existing.get(s.video, ())
        ]


def _existing_idx_by_video(labels: Labels) -> Dict[Video, set]:
    out: Dict[Video, set] = {}
    for s in labels.suggestions:
        out.setdefault(s.video, set()).add(s.frame_idx)
    return out
