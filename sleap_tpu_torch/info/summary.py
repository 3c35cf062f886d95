"""Per-frame statistic series of a video's labeled frames, for seekbar
colouring (port of :mod:`sleap_tpu.info.summary`); host numpy on the
port's ``Labels``."""

from __future__ import annotations

from typing import Dict

import numpy as np

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.io.video import Video


class StatisticSeries:
    """{frame_idx: statistic} series over a video's labeled frames."""

    def __init__(self, labels: Labels):
        self.labels = labels

    def get_point_count_series(self, video: Video) -> Dict[int, int]:
        return {
            lf.frame_idx: sum(inst.n_visible_points for inst in lf.instances)
            for lf in self.labels.find(video)
        }

    def get_point_score_series(self, video: Video, reduction: str = "sum") -> Dict[int, float]:
        reduce_fn = {"sum": np.nansum, "min": np.nanmin}[reduction]
        series = {}
        for lf in self.labels.find(video):
            scores = [inst.scores for inst in lf.predicted_instances if hasattr(inst, "scores")]
            if scores:
                series[lf.frame_idx] = float(reduce_fn(np.concatenate(scores)))
        return series

    def get_instance_score_series(self, video: Video, reduction: str = "sum") -> Dict[int, float]:
        reduce_fn = {"sum": np.nansum, "min": np.nanmin}[reduction]
        series = {}
        for lf in self.labels.find(video):
            scores = [inst.score for inst in lf.predicted_instances]
            if scores:
                series[lf.frame_idx] = float(reduce_fn(scores))
        return series

    def get_point_displacement_series(self, video: Video, reduction: str = "mean") -> Dict[int, float]:
        """Frame-to-frame displacement of tracked instances."""
        reduce_fn = {"mean": np.nanmean, "max": np.nanmax}[reduction]
        series = {}
        last_pts: Dict = {}
        for lf in self.labels.find(video):
            displacements = []
            for inst in lf.instances:
                if inst.track is None:
                    continue
                pts = inst.numpy()
                if inst.track in last_pts:
                    d = np.linalg.norm(pts - last_pts[inst.track], axis=1)
                    if not np.all(np.isnan(d)):
                        displacements.append(np.nanmean(d))
                last_pts[inst.track] = pts
            if displacements:
                series[lf.frame_idx] = float(reduce_fn(displacements))
        return series

    def get_primary_point_displacement_series(
        self, video: Video, reduction: str = "sum", primary_node=None
    ) -> np.ndarray:
        """The largest displacement of a primary node in each frame."""
        lfs = self.labels.find(video)
        n_frames = max((lf.frame_idx for lf in lfs), default=-1) + 1
        out = np.zeros(n_frames)
        node_ind = 0
        if primary_node is not None and self.labels.skeleton is not None:
            names = self.labels.skeleton.node_names
            if str(primary_node) in names:
                node_ind = names.index(str(primary_node))
        last_pts: Dict = {}
        for lf in lfs:
            vals = []
            for inst in lf.instances:
                if inst.track is None:
                    continue
                pt = inst.numpy()[node_ind]
                if inst.track in last_pts:
                    vals.append(np.linalg.norm(pt - last_pts[inst.track]))
                last_pts[inst.track] = pt
            vals = [v for v in vals if not np.isnan(v)]
            if vals:
                out[lf.frame_idx] = np.max(vals)
        return out
