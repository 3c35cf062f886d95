"""User and predicted instances and labeled frames: what training reads and
``predict`` returns.

The part of :mod:`sleap_tpu.core.instance` that labels and predictions fill,
with its field names and semantics: points live in a structured array of the
``.slp`` point dtype (x, y, visible, complete; predictions add a score), a
point with a NaN coordinate is missing and invisible, and ``numpy()`` gives
(n_nodes, 2) xy with invisible points as NaN. A frame's user instances with
a visible point are its training instances. Multiclass predictors give each instance
the :class:`Track` of its class and a tracking score; the trackers of
:mod:`sleap_tpu_torch.tracking` set both, and read the point views below.
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, List, Optional

import numpy as np

from sleap_tpu_torch.core.skeleton import Skeleton

POINT_DTYPE = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?")])
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


class Instance:
    """One labeled animal: a skeleton, its points and its track, and the
    prediction it was corrected from, if any (``from_predicted``).

    ``points`` is a structured array of :data:`POINT_DTYPE` or an
    (n_nodes, 2) xy array, in which a point with a NaN coordinate is
    invisible.
    """

    predicted = False

    def __init__(
        self,
        skeleton: Skeleton,
        points: Any = None,
        track: Optional[Track] = None,
        from_predicted: Optional["PredictedInstance"] = None,
    ):
        if skeleton is None:
            raise TypeError("Instance requires a skeleton.")
        self.skeleton = skeleton
        self.track = track
        self.from_predicted = from_predicted
        n = len(skeleton.nodes)
        if isinstance(points, np.ndarray) and points.dtype == POINT_DTYPE:
            if len(points) != n:
                raise ValueError(f"Expected {n} points, got {len(points)}.")
            self.points = points.copy()
            return
        self.points = np.zeros(n, dtype=POINT_DTYPE)
        self.points["x"] = np.nan
        self.points["y"] = np.nan
        if points is not None:
            arr = np.asarray(points, dtype="f8")
            if arr.ndim != 2 or arr.shape[0] != n or arr.shape[1] < 2:
                raise TypeError(f"Cannot make {n} points from an array of shape {arr.shape}.")
            self.points["x"] = arr[:, 0]
            self.points["y"] = arr[:, 1]
            self.points["visible"] = ~(np.isnan(arr[:, 0]) | np.isnan(arr[:, 1]))

    def numpy(self) -> np.ndarray:
        """(n_nodes, 2) xy; invisible points NaN."""
        xy = np.stack([self.points["x"], self.points["y"]], axis=-1).astype("f8")
        xy[~self.points["visible"]] = np.nan
        return xy

    @property
    def n_visible_points(self) -> int:
        return int(np.count_nonzero(self.points["visible"]))

    def __repr__(self) -> str:
        return (
            f"Instance(points={self.n_visible_points}/{len(self.points)}, track={self.track})"
        )


class PredictedInstance:
    """One predicted animal: a skeleton, its points and scores, and its
    track (identity) with the score of that assignment."""

    predicted = True

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
        self.from_predicted = None

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

    def __init__(self, video: Any, frame_idx: int, instances: Optional[Iterable[Any]] = None):
        self.video = video
        self.frame_idx = int(frame_idx)
        self.instances: List[Any] = list(instances or [])

    @property
    def user_instances(self) -> List[Instance]:
        return [i for i in self.instances if not i.predicted]

    @property
    def predicted_instances(self) -> List["PredictedInstance"]:
        return [i for i in self.instances if i.predicted]

    @property
    def training_instances(self) -> List[Instance]:
        """User instances with at least one visible point."""
        return [i for i in self.user_instances if i.n_visible_points > 0]

    @property
    def has_user_instances(self) -> bool:
        return len(self.user_instances) > 0

    @property
    def image(self) -> np.ndarray:
        return self.video.get_frame(self.frame_idx)

    def __repr__(self) -> str:
        return f"LabeledFrame(frame_idx={self.frame_idx}, instances={len(self.instances)})"
