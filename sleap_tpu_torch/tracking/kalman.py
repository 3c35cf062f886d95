"""Kalman-filter identity tracking (port of :mod:`sleap_tpu.tracking.kalman`).

Per-track constant-velocity filters over selected node coordinates,
initialized from a window of frames tracked by another tracker (typically
flow), with NaN-masked observations: a closed-form filter, no EM fitting.
Host-side numpy, as in the JAX package: each frame's update depends on the
previous frame's, and the matrices are tiny.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from sleap_tpu_torch.core.instance import Track
from sleap_tpu_torch.tracking.components import greedy_matching

def remove_second_bests_from_cost_matrix(
    cost_matrix: np.ndarray, thresh: float, invalid_val: float = np.nan
) -> np.ndarray:
    """Invalidate ambiguous matches.

    A column (track) whose best cost is within ``thresh`` of its second-best
    is fully invalidated; a row (instance) is invalidated when its best
    match is ambiguous the same way OR its best column was already ruled
    out (so the instance doesn't get silently matched to its second
    choice). Returns a copy with invalid entries set to ``invalid_val``.
    """
    cm = np.asarray(cost_matrix, dtype=float)
    valid = np.ones(cm.shape, dtype=bool)

    with np.errstate(invalid="ignore"):
        for c in range(cm.shape[1]):
            col = cm[:, c]
            if np.all(np.isnan(col)):
                continue
            if np.sum(col < (np.nanmin(col) + thresh)) > 1:
                valid[:, c] = False
        for r in range(cm.shape[0]):
            row = cm[r]
            if np.all(np.isnan(row)):
                continue
            best = np.nanargmin(row)
            ambiguous = np.sum(row < (row[best] + thresh)) > 1
            if ambiguous or not valid[r, best]:
                valid[r] = False

    out = cm.copy()
    out[~valid] = invalid_val
    return out


class ConstantVelocityKF:
    """Constant-velocity Kalman filter over a flat coordinate vector.

    State per coordinate: (position, velocity). Missing observations (NaN)
    update only via prediction.
    """

    def __init__(self, initial_coords: np.ndarray, q: float = 1.0, r: float = 2.0):
        n = initial_coords.size
        self.n = n
        self.x = np.zeros(2 * n)
        self.x[0::2] = np.nan_to_num(initial_coords)
        self.P = np.eye(2 * n) * 10.0
        # Block-diagonal [1 1; 0 1] transitions.
        self.F = np.eye(2 * n)
        for i in range(n):
            self.F[2 * i, 2 * i + 1] = 1.0
        self.H = np.zeros((n, 2 * n))
        for i in range(n):
            self.H[i, 2 * i] = 1.0
        self.Q = np.eye(2 * n) * q
        self.R = np.eye(n) * r

    def predict(self) -> np.ndarray:
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        return self.x[0::2].copy()

    def update(self, coords: np.ndarray) -> None:
        observed = ~np.isnan(coords)
        if not observed.any():
            return
        H = self.H[observed]
        R = self.R[np.ix_(observed, observed)]
        z = coords[observed]
        y = z - H @ self.x
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(len(self.x)) - K @ H) @ self.P


@dataclass
class BareKalmanTracker:
    """Per-track KFs over selected nodes."""

    node_indices: List[int]
    instance_count: int
    instance_score_thresh: float = 0.3
    reset_gap_size: int = 5

    kalman_filters: Dict[Track, ConstantVelocityKF] = field(default_factory=dict)
    tracks: List[Track] = field(default_factory=list)
    last_frame_for_track: Dict[Track, int] = field(default_factory=dict)

    @classmethod
    def initialize(cls, frames, instance_count: int, node_indices: List[int],
                   instance_score_thresh: float = 0.3, reset_gap_size: int = 5) -> "BareKalmanTracker":
        """A tracker whose filters start from the predicted instances of
        ``frames``."""
        instances = [inst for lf in frames for inst in lf.predicted_instances]
        obj = cls(node_indices=node_indices, instance_count=instance_count,
                  instance_score_thresh=instance_score_thresh, reset_gap_size=reset_gap_size)
        obj.init_filters(instances)
        return obj

    def _coords(self, inst) -> np.ndarray:
        return inst.numpy()[self.node_indices].flatten()

    def init_filters(self, instances) -> None:
        if not instances:
            raise ValueError("Kalman filter must be initialized with instances.")
        n_nodes = len(instances[0].skeleton.nodes)
        bad = [i for i in self.node_indices if not 0 <= i < n_nodes]
        if bad:
            raise ValueError(
                f"Kalman node indices {bad} out of range for skeleton with "
                f"{n_nodes} nodes."
            )
        by_track: Dict[Track, List[np.ndarray]] = {}
        for inst in instances:
            if inst.track is None:
                continue
            by_track.setdefault(inst.track, []).append(self._coords(inst))
        self.kalman_filters = {}
        self.tracks = []
        for track, coord_seq in list(by_track.items())[: self.instance_count]:
            kf = ConstantVelocityKF(coord_seq[0])
            for coords in coord_seq[1:]:
                kf.predict()
                kf.update(coords)
            self.kalman_filters[track] = kf
            self.tracks.append(track)

    def track_frame(self, untracked_instances: List[Any], t: int) -> List[Any]:
        """Assign tracks by distance to KF-predicted coordinates."""
        if not self.kalman_filters:
            return untracked_instances
        predictions = {
            track: kf.predict() for track, kf in self.kalman_filters.items()
        }
        usable = [
            inst
            for inst in untracked_instances
            if getattr(inst, "score", 1.0) >= self.instance_score_thresh
        ]
        if not usable:
            return untracked_instances

        tracks = list(predictions.keys())
        cost = np.full((len(usable), len(tracks)), np.inf)
        for i, inst in enumerate(usable):
            coords = self._coords(inst)
            for j, track in enumerate(tracks):
                diff = coords - predictions[track]
                valid = ~np.isnan(diff)
                if valid.any():
                    cost[i, j] = float(np.nanmean(np.abs(diff)))
        # Second-best suppression: ambiguous
        # assignments (best too close to second-best, threshold = the data's
        # own minimum distance) are left unmatched.
        cost_nan = np.where(np.isfinite(cost), cost, np.nan)
        if np.all(np.isnan(cost_nan)):
            return untracked_instances
        cost = remove_second_bests_from_cost_matrix(
            cost_nan, thresh=float(np.nanmin(cost_nan)), invalid_val=np.inf
        )
        matches = greedy_matching(cost)
        tracked = []
        matched_inst = set()
        for i, j in matches:
            if not np.isfinite(cost[i, j]):
                continue
            inst = usable[i]
            inst.track = tracks[j]
            inst.tracking_score = float(1.0 / (1.0 + cost[i, j]))
            self.kalman_filters[tracks[j]].update(self._coords(inst))
            self.last_frame_for_track[tracks[j]] = t
            tracked.append(inst)
            matched_inst.add(id(inst))
        untouched = [
            inst for inst in untracked_instances if id(inst) not in matched_inst
        ]
        return tracked + untouched

    @property
    def last_frame_with_tracks(self) -> int:
        """Most recent frame index where any track matched an instance."""
        return max(self.last_frame_for_track.values(), default=-1)

    def has_stale_filters(self, t: int) -> bool:
        """True when no track has matched within the last ``reset_gap_size``
        frames before ``t``."""
        return self.last_frame_with_tracks < t - self.reset_gap_size


@dataclass
class KalmanTracker:
    """Init-then-filter wrapper: the init tracker (typically flow) runs for
    the first ``init_frame_count`` frames, then the KF takes over; on stale
    filters, re-initialization is triggered."""

    init_tracker: Any
    node_indices: List[int]
    instance_count: int
    init_frame_count: int = 10
    re_init_cooldown: int = 100
    re_init_after: int = 20

    kf: Optional[BareKalmanTracker] = None
    init_frames: List = field(default_factory=list)
    _frame_count: int = field(default=0, init=False)
    _last_init_t: int = field(default=0, init=False)

    @classmethod
    def make_tracker(
        cls,
        init_tracker,
        node_indices: List[int],
        instance_count: int,
        init_frame_count: int = 10,
    ) -> "KalmanTracker":
        return cls(
            init_tracker=init_tracker,
            node_indices=node_indices,
            instance_count=instance_count,
            init_frame_count=init_frame_count,
        )

    @property
    def uses_image(self) -> bool:
        return getattr(self.init_tracker, "uses_image", False)

    @property
    def is_valid(self) -> bool:
        return True

    def track(self, untracked_instances, img=None, t=None, img_hw=None):
        self._frame_count += 1
        if self.kf is None:
            tracked = self.init_tracker.track(untracked_instances, img=img, t=t)
            self.init_frames.append(tracked)
            if len(self.init_frames) >= self.init_frame_count:
                instances = [i for frame in self.init_frames for i in frame]
                if instances:
                    # Config errors (bad node indices) must surface, not be
                    # swallowed by the retry loop below.
                    n_nodes = len(instances[0].skeleton.nodes)
                    bad = [
                        i for i in self.node_indices if not 0 <= i < n_nodes
                    ]
                    if bad:
                        raise ValueError(
                            f"Kalman node indices {bad} out of range for "
                            f"skeleton with {n_nodes} nodes."
                        )
                try:
                    kf = BareKalmanTracker(
                        node_indices=self.node_indices,
                        instance_count=self.instance_count,
                    )
                    kf.init_filters(instances)
                    self.kf = kf
                    self._last_init_t = t if t is not None else self._frame_count
                except ValueError:
                    self.init_frames = []
            return tracked
        t = t if t is not None else self._frame_count
        tracked = self.kf.track_frame(untracked_instances, t)
        # Re-init only after a cooldown since the last init AND a sustained
        # all-tracks matching failure.
        if (t - self._last_init_t) > self.re_init_cooldown and (
            self.kf.last_frame_with_tracks < t - self.re_init_after
        ):
            # Restart initialization with the flow tracker.
            self.kf = None
            self.init_frames = []
            if hasattr(self.init_tracker, "reset_candidates"):
                self.init_tracker.reset_candidates()
        return tracked

    def final_pass(self, frames) -> None:
        if hasattr(self.init_tracker, "final_pass"):
            self.init_tracker.final_pass(frames)

    def get_name(self) -> str:
        return f"kalman.{self.init_tracker.get_name()}"
