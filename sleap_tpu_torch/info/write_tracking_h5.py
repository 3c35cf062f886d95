"""The analysis export: a video's tracked poses as an ``.analysis.h5`` file
or a CSV, without ``h5py`` or ``pandas``.

:mod:`sleap_tpu.info.write_tracking_h5` on the port's HDF5 writer
(:mod:`sleap_tpu_torch.io.hdf5`) and the standard library's ``csv``. The
HDF5 file holds what h5py writes for the JAX package, read back by h5py
with the same datasets, dtypes, shapes, values and filters:
``track_occupancy`` (frames, tracks), ``tracks`` (tracks, 2, nodes,
frames), ``point_scores``, ``instance_scores``, ``tracking_scores`` and
``edge_inds`` (each array transposed for MATLAB's column-major order and
deflated at level 9 in h5py's own chunks), fixed-length ``track_names``,
``node_names`` and ``edge_names``, the scalar ``video_ind``, and scalar
variable-length UTF-8 strings ``labels_path``, ``video_path`` and
``provenance``. The CSV is byte-equal to the JAX package's pandas output:
one row a (frame, occupied track), floats as Python's ``repr``, NaN empty.

    python -m sleap_tpu_torch.info.write_tracking_h5 labels.slp [-o out.h5] [--csv]
"""

from __future__ import annotations

import csv as _csv
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.io.video import Video


def get_tracks_as_np_strings(labels: Labels) -> List[bytes]:
    return [np.bytes_(track.name) for track in labels.tracks]


def get_nodes_as_np_strings(labels: Labels) -> List[bytes]:
    return [np.bytes_(node.name) for node in labels.skeletons[0].nodes]


def get_edges_as_np_strings(labels: Labels) -> List[Tuple[bytes, bytes]]:
    return [(np.bytes_(src), np.bytes_(dst)) for src, dst in labels.skeletons[0].edge_names]


def get_occupancy_and_points_matrices(
    labels: Labels, all_frames: bool, video: Optional[Video] = None
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(occupancy (tracks, frames), locations (frames, nodes, 2, tracks),
    point scores, instance scores, tracking scores) of ``video`` (the first
    by default), from frame 0 with ``all_frames`` else from the first
    labeled frame, to the last labeled frame. A user instance on a track
    wins over the predictions on it; without tracks, every instance goes to
    the one column. None when the video has no labeled frame."""
    track_count = len(labels.tracks) or 1
    node_count = labels.skeletons[0].n_nodes
    if video is None:
        if not labels.videos:
            return None
        video = labels.videos[0]
    labeled_frames = labels.find(video)
    frame_idxs = sorted(lf.frame_idx for lf in labeled_frames)
    if not frame_idxs:
        return None
    first_frame_idx = 0 if all_frames else frame_idxs[0]
    frame_count = frame_idxs[-1] - first_frame_idx + 1

    occupancy = np.zeros((track_count, frame_count), dtype=np.uint8)
    locations = np.full((frame_count, node_count, 2, track_count), np.nan)
    point_scores = np.full((frame_count, node_count, track_count), np.nan)
    instance_scores = np.full((frame_count, track_count), np.nan)
    tracking_scores = np.full((frame_count, track_count), np.nan)

    tracks = labels.tracks or [None]
    multi_warned = False
    for lf in labeled_frames:
        fi = lf.frame_idx - first_frame_idx
        user_by_track: Dict[int, list] = {}
        pred_by_track: Dict[int, list] = {}
        for inst in lf.instances:
            if inst.track in tracks:
                ti = tracks.index(inst.track)
            elif inst.track is None and len(tracks) == 1 and tracks[0] is None:
                ti = 0
            else:
                continue
            (pred_by_track if inst.predicted else user_by_track).setdefault(ti, []).append(inst)
        for ti in set(user_by_track) | set(pred_by_track):
            chosen = user_by_track.get(ti) or pred_by_track.get(ti, [])
            if len(chosen) > 1 and tracks[0] is not None and not multi_warned:
                multi_warned = True
                print("\nWarning! There are more than one instances per track on a single frame.\n")
            for inst in chosen:
                occupancy[ti, fi] = 1
                locations[fi, :, :, ti] = inst.numpy()
                if inst.predicted:
                    point_scores[fi, :, ti] = inst.scores
                    instance_scores[fi, ti] = inst.score
                    tracking_scores[fi, ti] = inst.tracking_score
    return occupancy, locations, point_scores, instance_scores, tracking_scores


def remove_empty_tracks_from_matrices(track_names: List, occupancy: np.ndarray, locations: np.ndarray,
                                      point_scores: np.ndarray, instance_scores: np.ndarray,
                                      tracking_scores: np.ndarray):
    """Drop the tracks that no frame occupies."""
    keep = np.where(occupancy.sum(axis=1) > 0)[0]
    return ([track_names[i] for i in keep], occupancy[keep], locations[..., keep],
            point_scores[..., keep], instance_scores[..., keep], tracking_scores[..., keep])


def write_occupancy_file(output_path: str, data_dict: Dict[str, Any], transpose: bool = True) -> None:
    """Write ``data_dict`` as h5py writes it: arrays (transposed unless
    ``transpose`` is False) chunked as h5py chunks them and deflated at
    level 9; lists and scalars contiguous; strings variable-length."""
    from sleap_tpu_torch.io import hdf5

    with hdf5.Writer(output_path) as f:
        for key, val in data_dict.items():
            if isinstance(val, np.ndarray):
                data = np.transpose(val) if transpose else val
                chunks = hdf5.guess_chunk(data.shape, data.dtype.itemsize) if data.ndim else None
                f.create_dataset(key, data=data, compression="gzip", compression_opts=9, chunks=chunks)
            elif isinstance(val, str):
                f.create_dataset(key, data=val)
            else:
                f.create_dataset(key, data=np.asarray(val), compression=None)


def _csv_cell(value: Any) -> str:
    """A cell as pandas' ``to_csv`` writes it: NaN empty, floats by
    ``repr``."""
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else repr(float(value))
    return str(value)


def write_csv_file(output_path: str, data_dict: Dict[str, Any]) -> None:
    """A wide CSV: ``frame_idx``, ``track``, ``instance.score``, then x, y
    and score of each node, one row a (frame, track) with a point."""
    locations = data_dict["tracks"]  # (frames, nodes, 2, tracks)
    point_scores = data_dict["point_scores"]
    track_names = [t.decode() if isinstance(t, bytes) else str(t) for t in data_dict["track_names"]]
    node_names = [n.decode() if isinstance(n, bytes) else str(n) for n in data_dict["node_names"]]
    header: List[str] = []
    rows = []
    n_frames, n_nodes, _, n_tracks = locations.shape
    for fi in range(n_frames):
        for ti in range(n_tracks):
            if np.all(np.isnan(locations[fi, :, :, ti])):
                continue
            row: Dict[str, Any] = {
                "frame_idx": fi,
                "track": track_names[ti] if ti < len(track_names) else f"track_{ti}",
                "instance.score": data_dict["instance_scores"][fi, ti],
            }
            for ni, node in enumerate(node_names):
                row[f"{node}.x"] = locations[fi, ni, 0, ti]
                row[f"{node}.y"] = locations[fi, ni, 1, ti]
                row[f"{node}.score"] = point_scores[fi, ni, ti]
            header = header or list(row)
            rows.append([_csv_cell(row[k]) for k in header])
    with open(output_path, "w", newline="") as fh:
        writer = _csv.writer(fh, lineterminator="\n")
        if header:
            writer.writerow(header)
        else:  # pandas writes an empty frame as an empty line
            fh.write("\n")
        writer.writerows(rows)


def export_analysis_file(labels: Labels, output_path: str, labels_path: str = "",
                         all_frames: bool = True, video: Optional[Video] = None,
                         csv: bool = False) -> None:
    """Write the analysis file (``csv`` for the CSV) of ``video`` (the
    first by default); raises ValueError when it has no labeled frame."""
    video = video or (labels.videos[0] if labels.videos else None)
    mats = get_occupancy_and_points_matrices(labels, all_frames, video)
    if mats is None:
        raise ValueError("No labeled frames to export.")
    occupancy, locations, point_scores, instance_scores, tracking_scores = mats
    track_names = get_tracks_as_np_strings(labels)
    if track_names:
        (track_names, occupancy, locations, point_scores, instance_scores,
         tracking_scores) = remove_empty_tracks_from_matrices(
            track_names, occupancy, locations, point_scores, instance_scores, tracking_scores)
    data_dict = {
        "track_names": track_names,
        "node_names": get_nodes_as_np_strings(labels),
        "edge_names": get_edges_as_np_strings(labels),
        "edge_inds": np.array(labels.skeletons[0].edge_inds, dtype=np.int32),
        "track_occupancy": occupancy,
        "tracks": locations,
        "point_scores": point_scores,
        "instance_scores": instance_scores,
        "tracking_scores": tracking_scores,
        "labels_path": labels_path,
        "video_path": video.filename if video else "",
        "video_ind": np.int32(labels.videos.index(video)) if video else np.int32(0),
        "provenance": json.dumps(labels.provenance),
    }
    if csv:
        write_csv_file(output_path, data_dict)
    else:
        write_occupancy_file(output_path, data_dict, transpose=True)


def main(args=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Export analysis HDF5/CSV.")
    parser.add_argument("data_path", help="Path to labels (.slp).")
    parser.add_argument("--output", "-o", default=None)
    parser.add_argument("--all-frames", action="store_true", default=True)
    parser.add_argument("--csv", action="store_true")
    ns = parser.parse_args(args)
    labels = Labels.load_file(ns.data_path)
    out = ns.output or (ns.data_path + (".analysis.csv" if ns.csv else ".analysis.h5"))
    export_analysis_file(labels, out, labels_path=ns.data_path, all_frames=ns.all_frames, csv=ns.csv)
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
