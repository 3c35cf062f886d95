"""Reading an ``.analysis.h5`` file back into :class:`Labels`
(:mod:`sleap_tpu.io.formats.sleap_analysis` on the port's HDF5 reader): one
predicted instance a (frame, track) with a point, on a skeleton of the
file's nodes and edges, over the file's video where it exists (beside the
file too), else a placeholder of as many frames. A skeleton without edges
reads, where the JAX reader raises."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io import hdf5
from sleap_tpu_torch.io.video import DummyVideo, Video


def _names(values) -> list:
    return [v.decode() if isinstance(v, bytes) else str(v) for v in values]


def read_labels(filename: str, video: Optional[Video] = None, device="cuda") -> Labels:
    with hdf5.File(filename, device=device) as f:
        tracks_mat = f["tracks"][:].T  # -> (frames, nodes, 2, tracks)
        node_names = _names(f["node_names"][:])
        track_names = _names(f["track_names"][:] if f["track_names"].shape[0] else [])
        edge_inds = f["edge_inds"][:] if "edge_inds" in f else np.zeros((0, 2), int)
        if edge_inds.ndim == 2 and edge_inds.shape[0] == 2 and edge_inds.shape[1] != 2:
            edge_inds = edge_inds.T
        point_scores = f["point_scores"][:].T if "point_scores" in f else None
        instance_scores = f["instance_scores"][:].T if "instance_scores" in f else None
        tracking_scores = f["tracking_scores"][:].T if "tracking_scores" in f else None
        video_path = ""
        if "video_path" in f:
            raw = f["video_path"][()]
            video_path = raw.decode() if isinstance(raw, bytes) else str(raw)

    skeleton = Skeleton(name="analysis")
    skeleton.add_nodes(node_names)
    # (the JAX reader fails on a skeleton without edges: an empty
    # edge_inds unpacks as one empty row)
    for src, dst in np.asarray(edge_inds).reshape(-1, 2):
        try:
            skeleton.add_edge(node_names[int(src)], node_names[int(dst)])
        except (IndexError, ValueError):
            continue

    if video is None:
        beside = os.path.join(os.path.dirname(os.path.abspath(filename)), os.path.basename(video_path))
        if video_path and os.path.exists(video_path):
            video = Video.from_filename(video_path, device=device)
        elif video_path and os.path.exists(beside):
            video = Video.from_filename(beside, device=device)
        else:
            video = Video(DummyVideo(filename=video_path or filename, frames=tracks_mat.shape[0]))

    tracks = [Track(spawned_on=0, name=n) for n in track_names]
    while len(tracks) < tracks_mat.shape[-1]:
        tracks.append(Track(spawned_on=0, name=f"track_{len(tracks)}"))

    lfs = []
    n_frames, n_nodes, _, n_tracks = tracks_mat.shape
    for fi in range(n_frames):
        instances = []
        for ti in range(n_tracks):
            pts = tracks_mat[fi, :, :, ti]
            if np.all(np.isnan(pts)):
                continue
            confs = point_scores[fi, :, ti] if point_scores is not None else np.ones(n_nodes)
            instances.append(PredictedInstance.from_arrays(
                points=pts,
                point_confidences=np.nan_to_num(confs),
                instance_score=float(np.nan_to_num(instance_scores[fi, ti])
                                     if instance_scores is not None else 1.0),
                skeleton=skeleton,
                track=tracks[ti],
                tracking_score=float(np.nan_to_num(tracking_scores[fi, ti])
                                     if tracking_scores is not None else 0.0),
            ))
        if instances:
            lfs.append(LabeledFrame(video=video, frame_idx=fi, instances=instances))
    return Labels(labeled_frames=lfs, videos=[video], skeletons=[skeleton], tracks=tracks)
