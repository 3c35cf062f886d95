"""Reading DeepPoseKit labels (:mod:`sleap_tpu.io.formats.deepposekit`):
a ``pose`` dataset (tracks, frames, nodes, 3) read by the port's HDF5
reader, a skeleton CSV (``name``, ``parent``, ``swap`` columns) and the
video."""

from __future__ import annotations

import csv

from sleap_tpu_torch.core.instance import Instance, LabeledFrame, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io import hdf5
from sleap_tpu_torch.io.video import Video


def read_labels(filename: str, video_path: str, skeleton_path: str, device="cuda") -> Labels:
    video = Video.from_filename(video_path, device=device)

    skeleton = Skeleton(name="deepposekit")
    with open(skeleton_path) as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        skeleton.add_node(row["name"])
    for row in rows:
        parent = row.get("parent", "")
        if parent and parent.lower() != "nan":
            skeleton.add_edge(parent, row["name"])
    for row in rows:
        swap = row.get("swap", "") or row.get("swap_index", "")
        if swap and swap.lower() != "nan" and skeleton.has_node(swap):
            try:
                skeleton.add_symmetry(row["name"], swap)
            except ValueError:
                pass

    with hdf5.File(filename, device=device) as f:
        pose = f["pose"][:]
    track_count, frame_count, _, _ = pose.shape
    tracks = [Track(0, f"Track {i}") for i in range(track_count)]
    lfs = []
    for frame_idx in range(frame_count):
        instances = [Instance(skeleton=skeleton, points=pose[ti, frame_idx, :, :2].astype("f8"),
                              track=tracks[ti]) for ti in range(track_count)]
        lfs.append(LabeledFrame(video, frame_idx=frame_idx, instances=instances))
    return Labels(labeled_frames=lfs, tracks=tracks, skeletons=[skeleton])
