"""Predicted instances and labeled frames: what ``predict`` returns.

The part of :mod:`sleap_tpu.core.instance` that predictions fill, with its
field names and semantics: points live in a structured array of the
``.slp`` predicted-point dtype (x, y, visible, complete, score), a point with
a NaN coordinate is missing and invisible, and ``numpy()`` gives (n_nodes, 2)
xy with invisible points as NaN. Multiclass predictors give each instance
the :class:`Track` of its class and a tracking score; the trackers of
:mod:`sleap_tpu_torch.tracking` set both, and read the point views below.
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, List, Optional

import numpy as np

from sleap_tpu_torch.core.skeleton import Skeleton

PRED_POINT_DTYPE = np.dtype(
    [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?"), ("score", "<f8")]
)


class Track:
    """An identity that persists across frames. Tracks compare by identity:
    two tracks of one name are two identities."""

    __slots__ = ("spawned_on", "name")

    def __init__(self, spawned_on: int = 0, name: str = ""):
        self.spawned_on = int(spawned_on)
        self.name = name

    def __repr__(self) -> str:
        return f"Track(spawned_on={self.spawned_on}, name={self.name!r})"


class PredictedInstance:
    """One predicted animal: a skeleton, its points and scores, and its
    track (identity) with the score of that assignment."""

    def __init__(
        self,
        skeleton: Skeleton,
        points: np.ndarray,
        score: float = 0.0,
        track: Optional[Track] = None,
        tracking_score: float = 0.0,
    ):
        if skeleton is None:
            raise TypeError("PredictedInstance requires a skeleton.")
        if points.dtype != PRED_POINT_DTYPE or len(points) != len(skeleton.nodes):
            raise ValueError(
                f"Expected {len(skeleton.nodes)} points of the predicted-point dtype, "
                f"got {len(points)} of {points.dtype}."
            )
        self.skeleton = skeleton
        self.points = points
        self.score = float(score)
        self.track = track
        self.tracking_score = float(tracking_score)

    @classmethod
    def from_arrays(
        cls,
        points: np.ndarray,
        point_confidences: np.ndarray,
        instance_score: float,
        skeleton: Skeleton,
        track: Optional[Track] = None,
        tracking_score: float = 0.0,
    ) -> "PredictedInstance":
        """From (n_nodes, 2) xy and (n_nodes,) confidences (NaN scores -> 0)."""
        points = np.asarray(points, dtype="f8")
        confs = np.asarray(point_confidences, dtype="f8").reshape(-1)
        pts = np.zeros(len(points), dtype=PRED_POINT_DTYPE)
        pts["x"] = points[:, 0]
        pts["y"] = points[:, 1]
        pts["visible"] = ~(np.isnan(points[:, 0]) | np.isnan(points[:, 1]))
        pts["score"] = np.where(np.isnan(confs), 0.0, confs)
        return cls(
            skeleton=skeleton, points=pts, score=instance_score, track=track,
            tracking_score=tracking_score,
        )

    def numpy(self) -> np.ndarray:
        """(n_nodes, 2) xy; invisible points NaN."""
        xy = np.stack([self.points["x"], self.points["y"]], axis=-1).astype("f8")
        xy[~self.points["visible"]] = np.nan
        return xy

    @property
    def points_array(self) -> np.ndarray:
        """(n_nodes, 2) xy with invisible points as NaN, as ``numpy()``."""
        return self.numpy()

    @property
    def scores(self) -> np.ndarray:
        """(n_nodes,) point confidences; NaN where a point is invisible."""
        s = self.points["score"].astype("f8")
        s[~self.points["visible"]] = np.nan
        return s

    @property
    def n_visible_points(self) -> int:
        return int(np.count_nonzero(self.points["visible"]))

    @property
    def centroid(self) -> np.ndarray:
        """Mean xy of the visible points."""
        return np.nanmean(self.numpy(), axis=0)

    @property
    def bounding_box(self) -> np.ndarray:
        """[y1, x1, y2, x2] over the visible points; all NaN, without a
        warning, when no point is visible."""
        pts = self.numpy()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            return np.array([np.nanmin(pts[:, 1]), np.nanmin(pts[:, 0]),
                             np.nanmax(pts[:, 1]), np.nanmax(pts[:, 0])])

    def __repr__(self) -> str:
        return (
            f"PredictedInstance(points={int(self.points['visible'].sum())}/{len(self.points)}, "
            f"score={self.score:.2f}, track={self.track})"
        )


class LabeledFrame:
    """The instances in one frame of one video. ``instances`` is a plain
    list, which trackers replace or cull in place."""

    def __init__(self, video: Any, frame_idx: int,
                 instances: Optional[Iterable[PredictedInstance]] = None):
        self.video = video
        self.frame_idx = int(frame_idx)
        self.instances: List[PredictedInstance] = list(instances or [])

    @property
    def image(self) -> np.ndarray:
        return self.video.get_frame(self.frame_idx)

    def __repr__(self) -> str:
        return f"LabeledFrame(frame_idx={self.frame_idx}, instances={len(self.instances)})"
