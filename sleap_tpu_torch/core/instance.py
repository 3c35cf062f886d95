"""Points, tracks, user and predicted instances, and labeled frames.

:mod:`sleap_tpu.core.instance` in plain Python and numpy, with its field
names and semantics: points live in a structured array of the ``.slp``
point dtype (x, y, visible, complete; predictions add a score), a point
with a NaN coordinate is missing, and ``numpy()`` gives (n_nodes, 2) xy
with invisible points as NaN. :class:`PredictedInstance` is an
:class:`Instance`, as in the JAX package. A frame keeps its instances in an
:class:`InstancesList`, which sets each member's ``frame``. Points are
aligned to the skeleton's nodes by identity: when the skeleton gains,
loses or reorders nodes, an instance's rows follow its nodes the next time
they are read. Multiclass predictors give each instance the
:class:`Track` of its class and a tracking score; the trackers of
:mod:`sleap_tpu_torch.tracking` set both.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from sleap_tpu_torch.core.skeleton import Node, Skeleton

POINT_DTYPE = np.dtype([("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?")])
PRED_POINT_DTYPE = np.dtype(
    [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?"), ("score", "<f8")]
)


def make_point(x: float = math.nan, y: float = math.nan, visible: bool = True,
               complete: bool = False) -> np.void:
    """One point record (a structured scalar of :data:`POINT_DTYPE`)."""
    return np.array([(x, y, visible, complete)], dtype=POINT_DTYPE)[0]


def make_pred_point(x: float = math.nan, y: float = math.nan, visible: bool = True,
                    complete: bool = False, score: float = 0.0) -> np.void:
    """One predicted point record (:data:`PRED_POINT_DTYPE`)."""
    return np.array([(x, y, visible, complete, score)], dtype=PRED_POINT_DTYPE)[0]


# The JAX package's names for the point factories.
Point = make_point
PredictedPoint = make_pred_point


def empty_points(n: int, predicted: bool = False) -> np.ndarray:
    """``n`` missing, invisible points."""
    pts = np.zeros(n, dtype=PRED_POINT_DTYPE if predicted else POINT_DTYPE)
    pts["x"] = np.nan
    pts["y"] = np.nan
    pts["visible"] = False
    return pts


class Track:
    """An identity that persists across frames. Tracks compare by identity:
    two tracks of one name are two identities."""

    __slots__ = ("spawned_on", "name")

    def __init__(self, spawned_on: int = 0, name: str = ""):
        self.spawned_on = spawned_on
        self.name = name

    def matches(self, other: "Track") -> bool:
        return self.name == other.name and self.spawned_on == other.spawned_on

    def __repr__(self) -> str:
        return f"Track(spawned_on={self.spawned_on}, name={self.name!r})"


class Instance:
    """One labeled animal: a skeleton, its points, its track, the
    prediction it was corrected from (``from_predicted``) and its frame.

    ``points`` takes a structured array of the point dtype, a dict of node
    (or node name) to xy or point record, or an (n_nodes, 2) xy array in
    which a point with a NaN coordinate is invisible.
    """

    predicted = False

    def __init__(
        self,
        skeleton: Skeleton,
        points: Optional[Union[np.ndarray, Dict[str, Any], Sequence]] = None,
        track: Optional[Track] = None,
        from_predicted: Optional["PredictedInstance"] = None,
        frame: Optional["LabeledFrame"] = None,
    ):
        if skeleton is None:
            raise TypeError("Instance requires a skeleton.")
        self.skeleton = skeleton
        self.track = track
        self.from_predicted = from_predicted
        self.frame = frame
        self.points = points

    # -- points, aligned to the skeleton's nodes by identity ---------------- #
    @property
    def points(self) -> np.ndarray:
        nodes = self.skeleton._node_tuple
        snap = self._nodes_snapshot
        if nodes is not snap and (len(nodes) != len(snap)
                                  or any(a is not b for a, b in zip(nodes, snap))):
            index = {id(n): i for i, n in enumerate(snap)}
            out = empty_points(len(nodes), predicted=self.predicted)
            for i, n in enumerate(nodes):
                j = index.get(id(n))
                if j is not None and j < len(self._points):
                    out[i] = self._points[j]
            self._points = out
        self._nodes_snapshot = nodes
        return self._points

    @points.setter
    def points(self, value) -> None:
        self._points = self._coerce_points(value)
        self._nodes_snapshot = self.skeleton._node_tuple

    def _point_dtype(self) -> np.dtype:
        return POINT_DTYPE

    def _coerce_points(self, points) -> np.ndarray:
        n = self.skeleton.n_nodes
        dtype = self._point_dtype()
        if points is None:
            return empty_points(n, predicted=self.predicted)
        if isinstance(points, np.ndarray) and points.dtype == dtype:
            if len(points) > n:
                raise ValueError(f"Point array length {len(points)} > n_nodes {n}.")
            if len(points) < n:  # nodes added since: missing points
                return np.concatenate([points, empty_points(n - len(points), self.predicted)])
            return points.copy()
        if isinstance(points, dict):
            pts = empty_points(n, predicted=self.predicted)
            names = self.skeleton.node_names
            for key, val in points.items():
                name = key.name if isinstance(key, Node) else key
                if name not in names:
                    raise KeyError(f"{name} is not a node in the skeleton.")
                i = names.index(name)
                if isinstance(val, np.void):
                    if val.dtype == dtype:
                        pts[i] = val
                    else:
                        for field in val.dtype.names:
                            if field in dtype.names:
                                pts[i][field] = val[field]
                else:
                    x, y = val[0], val[1]
                    pts[i] = ((x, y, True, False) if not self.predicted
                              else (x, y, True, False, val[2] if len(val) > 2 else 0.0))
            return pts
        arr = np.asarray(points, dtype="f8")
        if arr.ndim == 2 and arr.shape[0] == n and arr.shape[1] >= 2:
            pts = empty_points(n, predicted=self.predicted)
            pts["x"] = arr[:, 0]
            pts["y"] = arr[:, 1]
            pts["visible"] = ~(np.isnan(arr[:, 0]) | np.isnan(arr[:, 1]))
            return pts
        raise TypeError(f"Cannot construct points from {type(points)}.")

    # -- point access ------------------------------------------------------- #
    def __getitem__(self, node: Union[str, Node, int]) -> np.void:
        if isinstance(node, (list, tuple)):
            return np.array([self[n] for n in node], dtype=self.points.dtype)
        return self.points[self._node_index(node)]

    def __setitem__(self, node: Union[str, Node, int], value) -> None:
        i = self._node_index(node)
        if isinstance(value, np.void):
            self.points[i] = value
        else:
            self.points[i]["x"] = value[0]
            self.points[i]["y"] = value[1]
            self.points[i]["visible"] = not (np.isnan(value[0]) or np.isnan(value[1]))

    def _node_index(self, node: Union[str, Node, int]) -> int:
        if isinstance(node, int):
            return node
        if isinstance(node, Node):
            return self.skeleton.node_to_index(node)
        return self.skeleton.node_names.index(node)

    def __contains__(self, node: Union[str, Node]) -> bool:
        try:
            i = self._node_index(node)
        except (ValueError, KeyError):
            return False
        return bool(self.points[i]["visible"]) or not np.isnan(self.points[i]["x"])

    def __len__(self) -> int:
        return len(self.points)

    @property
    def nodes(self) -> List[Node]:
        """The nodes that have a point (a non-NaN x)."""
        mask = ~np.isnan(self.points["x"])
        return [n for n, m in zip(self.skeleton.nodes, mask) if m]

    @property
    def n_visible_points(self) -> int:
        return int(np.count_nonzero(self.points["visible"]))

    # -- array views -------------------------------------------------------- #
    def numpy(self, invisible_as_nan: bool = True) -> np.ndarray:
        """(n_nodes, 2) xy; invisible points NaN unless ``invisible_as_nan``
        is False."""
        pts = self.points
        xy = np.stack([pts["x"], pts["y"]], axis=-1).astype("f8")
        if invisible_as_nan:
            xy[~pts["visible"]] = np.nan
        return xy

    def get_points_array(self, copy: bool = True, invisible_as_nan: bool = False,
                         full: bool = False) -> np.ndarray:
        """The points as an array: xy, or every field with ``full``. With
        ``copy=False`` a view of the structured array (``invisible_as_nan``
        is then ignored)."""
        if not copy:
            return self.points if full else self.points[["x", "y"]]
        names = list(self.points.dtype.names) if full else ["x", "y"]
        arr = np.stack([self.points[n].astype("f8") for n in names], axis=-1)
        if invisible_as_nan:
            arr[~self.points["visible"]] = np.nan
        return arr

    @property
    def points_array(self) -> np.ndarray:
        """(n_nodes, 2) xy with invisible points as NaN."""
        return self.numpy()

    def transform_points(self, transformation_matrix: np.ndarray) -> None:
        """Apply a 2x2 linear, 2x3 affine or 3x3 homogeneous transform to the
        xy coordinates in place."""
        xy = self.numpy(invisible_as_nan=False)
        if transformation_matrix.shape == (2, 3):
            xy = xy @ transformation_matrix[:, :2].T + transformation_matrix[:, 2]
        elif transformation_matrix.shape == (3, 3):
            xy = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ transformation_matrix.T
            xy = xy[:, :2]
        else:
            xy = xy @ transformation_matrix.T
        self.points["x"] = xy[:, 0]
        self.points["y"] = xy[:, 1]

    def _merge_nodes_data(self, base_node: str, merge_node: str) -> None:
        """Copy ``merge_node``'s point (every field) into ``base_node`` when
        the base point is missing or invisible and the merged one is not."""
        names = self.skeleton.node_names
        bi, mi = names.index(base_node), names.index(merge_node)
        pts = self.points
        merge_has = bool(pts["visible"][mi]) and not np.isnan(pts["x"][mi])
        base_missing = (not pts["visible"][bi]) or np.isnan(pts["x"][bi])
        if merge_has and base_missing:
            for field in pts.dtype.names:
                pts[field][bi] = pts[field][mi]

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

    @property
    def midpoint(self) -> np.ndarray:
        """The middle of the bounding box, as xy."""
        y1, x1, y2, x2 = self.bounding_box
        return np.array([(x1 + x2) / 2.0, (y1 + y2) / 2.0])

    @property
    def video(self):
        return self.frame.video if self.frame is not None else None

    @property
    def frame_idx(self) -> Optional[int]:
        return self.frame.frame_idx if self.frame is not None else None

    @classmethod
    def from_numpy(cls, points: np.ndarray, skeleton: Skeleton,
                   track: Optional[Track] = None) -> "Instance":
        """From an (n_nodes, 2) array; NaN rows are missing."""
        return cls(skeleton=skeleton, points=np.asarray(points), track=track)

    @classmethod
    def from_pointsarray(cls, points: np.ndarray, skeleton: Skeleton,
                         track: Optional[Track] = None) -> "Instance":
        return cls.from_numpy(points, skeleton=skeleton, track=track)

    def fill_missing(self, max_x: Optional[float] = None, max_y: Optional[float] = None) -> None:
        """Put random points, inside the bounding box and kept invisible, at
        the missing nodes (``np.random``, as the JAX package draws them)."""
        y1, x1, y2, x2 = self.bounding_box
        y1, x1 = np.nanmax([y1, 0.0]), np.nanmax([x1, 0.0])
        if max_x is not None:
            x2 = np.nanmin([x2, max_x])
        if max_y is not None:
            y2 = np.nanmin([y2, max_y])
        w, h = x2 - x1, y2 - y1
        if np.isnan(w) or np.isnan(h):
            x1 = y1 = 0.0
            w = max_x if max_x is not None else 1.0
            h = max_y if max_y is not None else 1.0
        missing = ~self.points["visible"]
        n = int(np.count_nonzero(missing))
        if n == 0:
            return
        xy = np.random.rand(n, 2) * np.array([w, h]) + np.array([x1, y1])
        xy = np.maximum(xy, 0.0)
        if max_x is not None:
            xy[:, 0] = np.minimum(xy[:, 0], max_x)
        if max_y is not None:
            xy[:, 1] = np.minimum(xy[:, 1], max_y)
        self.points["x"][missing] = xy[:, 0]
        self.points["y"][missing] = xy[:, 1]
        self.points["visible"][missing] = False

    def matches(self, other: "Instance") -> bool:
        """Same class, structurally equal skeletons and points equal within
        ``np.isclose`` (NaNs equal)."""
        if type(self) is not type(other):
            return False
        if not self.skeleton.matches(other.skeleton):
            return False
        a, b = self.numpy(), other.numpy()
        if a.shape != b.shape:
            return False
        return bool(np.all(np.isclose(a, b, equal_nan=True)))

    def __repr__(self) -> str:
        return (
            f"Instance(video={self.video}, frame_idx={self.frame_idx}, "
            f"points={self.n_visible_points}/{len(self)}, track={self.track})"
        )


class PredictedInstance(Instance):
    """One predicted animal: an :class:`Instance` whose points carry
    scores, with an instance score and the score of its track assignment."""

    predicted = True

    def __init__(
        self,
        skeleton: Skeleton,
        points: Optional[Union[np.ndarray, Dict[str, Any], Sequence]] = None,
        track: Optional[Track] = None,
        score: float = 0.0,
        tracking_score: float = 0.0,
        frame: Optional["LabeledFrame"] = None,
    ):
        super().__init__(skeleton=skeleton, points=points, track=track, frame=frame)
        self.score = float(score)
        self.tracking_score = float(tracking_score)

    def _point_dtype(self) -> np.dtype:
        return PRED_POINT_DTYPE

    @property
    def scores(self) -> np.ndarray:
        """(n_nodes,) point confidences; NaN where a point is invisible."""
        s = self.points["score"].astype("f8")
        s[~self.points["visible"]] = np.nan
        return s

    @property
    def points_and_scores_array(self) -> np.ndarray:
        """(n_nodes, 3): x, y and score."""
        return np.concatenate([self.numpy(), self.scores[:, None]], axis=1)

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
        pts = empty_points(len(points), predicted=True)
        pts["x"] = points[:, 0]
        pts["y"] = points[:, 1]
        pts["visible"] = ~(np.isnan(points[:, 0]) | np.isnan(points[:, 1]))
        pts["score"] = np.where(np.isnan(confs), 0.0, confs)
        return cls(skeleton=skeleton, points=pts, track=track, score=float(instance_score),
                   tracking_score=tracking_score)

    from_numpy = from_arrays
    from_pointsarray = from_arrays

    @classmethod
    def from_instance(cls, instance: Instance, score: float) -> "PredictedInstance":
        xy = instance.numpy()
        return cls.from_arrays(xy, np.ones(len(xy)), score, instance.skeleton, track=instance.track)

    def __repr__(self) -> str:
        return (
            f"PredictedInstance(video={self.video}, frame_idx={self.frame_idx}, "
            f"points={self.n_visible_points}/{len(self)}, score={self.score:.2f}, "
            f"track={self.track})"
        )


class InstancesList(list):
    """A list of instances that sets each member's ``frame`` to the
    :class:`LabeledFrame` that owns it, and clears it on removal;
    ``copy()`` gives a plain list."""

    def __init__(self, *args, labeled_frame: Optional["LabeledFrame"] = None):
        super().__init__(*args)
        self._labeled_frame = labeled_frame
        for inst in self:
            inst.frame = labeled_frame

    def __reduce__(self):
        # Rebuilt through the constructor, which sets the owner: a list's
        # own pickle appends before the attributes are back.
        return _instances_list, (list(self), self._labeled_frame)

    @property
    def labeled_frame(self) -> Optional["LabeledFrame"]:
        return self._labeled_frame

    @labeled_frame.setter
    def labeled_frame(self, labeled_frame: Optional["LabeledFrame"]) -> None:
        if getattr(self, "_labeled_frame", None) is labeled_frame:
            return
        self._labeled_frame = labeled_frame
        for inst in self:
            inst.frame = labeled_frame

    def append(self, instance: Instance) -> None:
        if not isinstance(instance, Instance):
            raise ValueError(
                "InstancesList can only contain Instance or PredictedInstance "
                f"objects, but got {type(instance)}."
            )
        instance.frame = self._labeled_frame
        super().append(instance)

    def extend(self, instances: Iterable[Instance]) -> None:
        for inst in instances:
            self.append(inst)

    def insert(self, index: int, instance: Instance) -> None:
        super().insert(index, instance)
        instance.frame = self._labeled_frame

    def __setitem__(self, index, instance) -> None:
        super().__setitem__(index, instance)
        for inst in (instance if isinstance(index, slice) else [instance]):
            inst.frame = self._labeled_frame

    def __delitem__(self, index) -> None:
        removed = self[index]
        super().__delitem__(index)
        for inst in (removed if isinstance(index, slice) else [removed]):
            inst.frame = None

    def pop(self, index: int = -1) -> Instance:
        instance = super().pop(index)
        instance.frame = None
        return instance

    def remove(self, instance: Instance) -> None:
        super().remove(instance)
        instance.frame = None

    def clear(self) -> None:
        for inst in self:
            inst.frame = None
        super().clear()

    def copy(self) -> list:
        return list(self)


def _instances_list(instances: list, labeled_frame: Optional["LabeledFrame"]) -> InstancesList:
    return InstancesList(instances, labeled_frame=labeled_frame)


class LabeledFrame:
    """The instances in one frame of one video. Assigning ``instances``
    replaces them (trackers do)."""

    def __init__(self, video: Any, frame_idx: int, instances: Optional[Iterable[Instance]] = None):
        self.video = video
        self.frame_idx = int(frame_idx)
        self._instances = InstancesList(labeled_frame=self)
        for inst in instances or []:
            self.insert_instance(inst)

    @property
    def instances(self) -> InstancesList:
        return self._instances

    @instances.setter
    def instances(self, value: Iterable[Instance]) -> None:
        self._instances = InstancesList(labeled_frame=self)
        for inst in value:
            self.insert_instance(inst)

    def insert_instance(self, instance: Instance, index: Optional[int] = None) -> None:
        if index is None:
            self._instances.append(instance)
        else:
            self._instances.insert(index, instance)

    def remove_instance(self, instance: Instance) -> None:
        self._instances.remove(instance)

    def __len__(self) -> int:
        return len(self._instances)

    def __getitem__(self, i: int) -> Instance:
        return self._instances[i]

    def __setitem__(self, i: int, instance: Instance) -> None:
        self._instances[i] = instance

    def __delitem__(self, i: int) -> None:
        del self._instances[i]

    def index(self, instance: Instance) -> int:
        return self._instances.index(instance)

    def insert(self, index: int, instance: Instance) -> None:
        self._instances.insert(index, instance)

    def __iter__(self):
        return iter(self._instances)

    @property
    def user_instances(self) -> List[Instance]:
        return [i for i in self._instances if not i.predicted]

    @property
    def predicted_instances(self) -> List[PredictedInstance]:
        return [i for i in self._instances if i.predicted]

    @property
    def training_instances(self) -> List[Instance]:
        """User instances with at least one visible point."""
        return [i for i in self.user_instances if i.n_visible_points > 0]

    @property
    def has_user_instances(self) -> bool:
        return len(self.user_instances) > 0

    @property
    def has_predicted_instances(self) -> bool:
        return len(self.predicted_instances) > 0

    @property
    def has_tracked_instances(self) -> bool:
        return any(i.track is not None for i in self._instances)

    @property
    def tracked_instances(self) -> List[Instance]:
        return [i for i in self._instances if i.track is not None]

    @property
    def n_user_instances(self) -> int:
        return len(self.user_instances)

    @property
    def n_predicted_instances(self) -> int:
        return len(self.predicted_instances)

    @property
    def n_tracked_instances(self) -> int:
        return len(self.tracked_instances)

    @property
    def unused_predictions(self) -> List[PredictedInstance]:
        """Predictions that no user instance of this frame was corrected
        from."""
        used = {id(i.from_predicted) for i in self.user_instances if i.from_predicted}
        return [p for p in self.predicted_instances if id(p) not in used]

    @property
    def instances_to_show(self) -> List[Instance]:
        """User instances, then the predictions without a correction."""
        return self.user_instances + self.unused_predictions

    @classmethod
    def complex_frame_merge(cls, base_frame: "LabeledFrame", new_frame: "LabeledFrame"):
        """Merge ``new_frame`` into ``base_frame``; returns ``(merged
        instances, extra base frame, extra new frame)``. A conflict is when
        both frames keep unmatched instances of the same kind (user or
        predicted): then the base frame keeps only the instances that match
        one of the new frame's, and both sides' others come back as frames
        for the caller to resolve (else None)."""
        redundant: List[Instance] = []
        extra_base = list(base_frame.instances)
        extra_new: List[Instance] = []
        for new_inst in new_frame.instances:
            matched = next((b for b in extra_base if new_inst.matches(b)), None)
            if matched is not None:
                extra_base.remove(matched)
                redundant.append(matched)
            else:
                extra_new.append(new_inst)

        conflict = False
        if extra_base and extra_new:
            base_pred = sum(1 for i in extra_base if i.predicted)
            new_pred = sum(1 for i in extra_new if i.predicted)
            if base_pred and new_pred:
                conflict = True
            elif (len(extra_base) - base_pred) and (len(extra_new) - new_pred):
                conflict = True

        merged: List[Instance] = []
        if conflict:
            base_frame.instances = redundant
        else:
            merged = list(extra_new)
            for inst in extra_new:
                base_frame.insert_instance(inst)
            extra_base, extra_new = [], []

        def frame_of(frame, insts):
            return cls(video=frame.video, frame_idx=frame.frame_idx, instances=insts) if insts else None

        return merged, frame_of(base_frame, extra_base), frame_of(new_frame, extra_new)

    @classmethod
    def complex_merge_between(cls, base_labels, new_frames: List["LabeledFrame"]):
        """Merge frames into ``base_labels``: frames at a new (video, frame
        index) are appended, the others merged by
        :meth:`complex_frame_merge`. Returns ``(merged, extra base frames,
        extra new frames)``, ``merged`` mapping video -> frame index ->
        instances."""
        merged: Dict[Any, Dict[int, List[Instance]]] = {}
        extra_base: List["LabeledFrame"] = []
        extra_new: List["LabeledFrame"] = []
        for new_frame in new_frames:
            base_lfs = base_labels.find(new_frame.video, new_frame.frame_idx)
            if not base_lfs:
                base_labels.labeled_frames.append(new_frame)
                merged_instances = new_frame.instances
            else:
                merged_instances, eb, en = cls.complex_frame_merge(base_lfs[0], new_frame)
                if eb:
                    extra_base.append(eb)
                if en:
                    extra_new.append(en)
            if merged_instances:
                merged.setdefault(new_frame.video, {})[new_frame.frame_idx] = merged_instances
        return merged, extra_base, extra_new

    @property
    def image(self) -> np.ndarray:
        return self.video.get_frame(self.frame_idx)

    def numpy(self) -> np.ndarray:
        """(n_instances, n_nodes, 2) xy of the instances."""
        if not self._instances:
            return np.zeros((0, 0, 2))
        return np.stack([i.numpy() for i in self._instances], axis=0)

    def remove_untracked(self) -> None:
        self.instances = [i for i in self._instances if i.track is not None]

    def remove_empty_instances(self) -> None:
        self.instances = [i for i in self._instances if i.n_visible_points > 0]

    def __repr__(self) -> str:
        return (
            f"LabeledFrame(video={getattr(self.video, 'filename', self.video)}, "
            f"frame_idx={self.frame_idx}, instances={len(self._instances)})"
        )
