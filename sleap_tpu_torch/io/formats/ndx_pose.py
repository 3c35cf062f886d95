"""NWB (ndx-pose) import and export: :mod:`sleap_tpu.io.formats.ndx_pose`
on the port's data model.

The layout is the JAX package's:

- one ``ProcessingModule`` a video, named
  ``SLEAP_VIDEO_{video_idx:03}_{stem}``;
- one ``ndx_pose.PoseEstimation`` a track, named ``track{idx:03}``
  (``untracked{idx:03}`` when no instance of the video has a track);
- one ``ndx_pose.PoseEstimationSeries`` a node, keyed by the node's name,
  with each frame's ``data`` (x, y) and ``confidence``.

The arrays to and from :class:`~sleap_tpu_torch.core.labels.Labels`
(:func:`labels_to_pose_arrays`, :func:`tracks_numpy_to_labeled_frames`) are
plain numpy. :func:`read_labels` and :func:`write_labels` import ``pynwb``
and ``ndx_pose`` inside, as the JAX module does, and raise ``ImportError``
naming them where they are absent; the file is never written without them.
"""

from __future__ import annotations

import datetime
import re
import uuid
from pathlib import Path, PurePath
from typing import Dict, List, Optional, Tuple

import numpy as np

from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video


def _require_pynwb():
    try:
        import pynwb  # noqa: F401
        import ndx_pose  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "NWB support requires the 'pynwb' and 'ndx-pose' packages "
            "(pip install pynwb ndx-pose)."
        ) from e


def tracks_numpy_to_labeled_frames(
    tracks_numpy: np.ndarray,
    confidence: np.ndarray,
    is_tracked: bool,
    video: Video,
    skeleton: Skeleton,
) -> List[LabeledFrame]:
    """Labeled frames from ``Labels.numpy()``'s layout: points (frames,
    tracks, nodes, 2) and their confidences (frames, tracks, nodes); a
    (frame, track) with no point gives no instance, and the tracks are
    ``track{i}`` when ``is_tracked``."""
    n_frames, n_tracks = tracks_numpy.shape[:2]
    tracks = [Track(name=f"track{i}", spawned_on=0) for i in range(n_tracks)]
    lfs = []
    for frame_idx in range(n_frames):
        insts = []
        for track, inst_pts, inst_confs in zip(tracks, tracks_numpy[frame_idx], confidence[frame_idx]):
            if np.isnan(inst_pts).all():
                continue
            insts.append(
                PredictedInstance.from_arrays(
                    points=inst_pts,
                    point_confidences=inst_confs,
                    instance_score=float(np.nanmean(inst_confs)),
                    skeleton=skeleton,
                    track=track if is_tracked else None,
                )
            )
        if insts:
            lfs.append(LabeledFrame(video=video, frame_idx=frame_idx, instances=insts))
    return lfs


def labels_to_pose_arrays(labels: Labels, video: Video) -> Tuple[np.ndarray, bool]:
    """One video's (frames, tracks, nodes, 3) array of x, y and confidence
    over all its frames, and whether none of its instances has a track."""
    video_lfs = labels.find(video)
    untracked = all(inst.track is None for lf in video_lfs for inst in lf.instances)
    tracks_numpy = labels.numpy(video=video, all_frames=True, untracked=untracked,
                                return_confidence=True)
    return tracks_numpy, untracked


def read_labels(filename: str, device="cuda", **kwargs) -> Labels:
    """Labels from an NWB file's SLEAP pose modules; the videos they name
    decode on ``device``."""
    _require_pynwb()
    from pynwb import NWBHDF5IO

    video_tracks: Dict[str, Tuple[np.ndarray, np.ndarray, bool]] = {}
    with NWBHDF5IO(filename, mode="r", load_namespaces=True) as io:
        nwb_file = io.read().processing
        video_keys = [k for k in nwb_file.keys() if "SLEAP_VIDEO" in k]
        first_module = nwb_file[video_keys[0]]
        first_track_key = list(first_module.fields["data_interfaces"])[0]
        first_pose = first_module[first_track_key]
        node_names = list(first_pose.nodes[:])
        edge_inds = [tuple(int(v) for v in e) for e in first_pose.edges[:]]

        for processing_module in nwb_file.values():
            track_keys = list(processing_module.fields["data_interfaces"])
            is_tracked = re.sub("[0-9]+", "", track_keys[0]) == "track"
            test_pose = processing_module[track_keys[0]]
            n_frames = test_pose[node_names[0]].data[:].shape[0]
            n_tracks = len(track_keys)
            n_nodes = len(node_names)
            tracks_numpy = np.full((n_frames, n_tracks, n_nodes, 2), np.nan, "f4")
            confidence = np.full((n_frames, n_tracks, n_nodes), np.nan, "f4")
            for track_idx, track_key in enumerate(track_keys):
                pose = processing_module[track_key]
                for node_idx, node_name in enumerate(node_names):
                    series = pose[node_name]
                    tracks_numpy[:, track_idx, node_idx, :] = series.data[:]
                    confidence[:, track_idx, node_idx] = series.confidence[:]
            video_tracks[str(PurePath(test_pose.original_videos[0]))] = (
                tracks_numpy, confidence, is_tracked,
            )

    skeleton = Skeleton.from_names_and_edge_inds(node_names, edge_inds)
    lfs: List[LabeledFrame] = []
    for video_fn, (tracks_numpy, confidence, is_tracked) in video_tracks.items():
        video = Video.from_filename(video_fn, device=device)
        lfs.extend(tracks_numpy_to_labeled_frames(tracks_numpy, confidence, is_tracked, video, skeleton))
    labels = Labels(lfs)
    labels.skeletons = [skeleton]
    return labels


def write_labels(
    filename: str,
    labels: Labels,
    overwrite: bool = False,
    session_description: str = "Processed SLEAP pose data",
    identifier: Optional[str] = None,
    session_start_time: Optional[datetime.datetime] = None,
) -> None:
    """Write the predicted instances to an NWB file (appended to an
    existing one unless ``overwrite``)."""
    _require_pynwb()
    from ndx_pose import PoseEstimation, PoseEstimationSeries
    from pynwb import NWBHDF5IO, NWBFile

    from sleap_tpu_torch.version import __version__

    if len(labels.predicted_instances) == 0:
        raise TypeError(
            "Only predicted instances are written to the NWB format. "
            "This project has no predicted instances."
        )
    if session_start_time is None:
        session_start_time = datetime.datetime.now(datetime.timezone.utc)
    identifier = str(uuid.uuid4()) if identifier is None else identifier

    io = None
    try:
        if Path(filename).exists() and not overwrite:
            io = NWBHDF5IO(filename, mode="a", load_namespaces=True)
            nwb_file = io.read()
        else:
            nwb_file = NWBFile(
                session_description=session_description,
                identifier=identifier,
                session_start_time=session_start_time,
            )
            io = NWBHDF5IO(filename, mode="w")

        skeleton = labels.skeleton
        for video_idx, video in enumerate(labels.videos):
            video_fn = PurePath(video.filename or f"video{video_idx}")
            name = f"SLEAP_VIDEO_{video_idx:03}_{video_fn.stem}"
            try:
                module = nwb_file.create_processing_module(
                    name=name,
                    description=f"{session_description} for {video_fn.name} with "
                                f"{skeleton.name} skeleton.",
                )
            except ValueError:
                continue  # an existing processing module is not overwritten

            tracks_numpy, untracked = labels_to_pose_arrays(labels, video)
            n_frames, n_tracks = tracks_numpy.shape[:2]
            timestamps = np.arange(n_frames, dtype="f8")
            for track_idx in range(n_tracks):
                series_list = [
                    PoseEstimationSeries(
                        name=node_name,
                        description=f"Sequential trajectory of {node_name}.",
                        data=tracks_numpy[:, track_idx, node_idx, :2],
                        unit="pixels",
                        reference_frame="No reference.",
                        timestamps=timestamps,
                        confidence=tracks_numpy[:, track_idx, node_idx, 2],
                        confidence_definition="Point-wise confidence scores.",
                    )
                    for node_idx, node_name in enumerate(skeleton.node_names)
                ]
                prefix = "untracked" if untracked else "track"
                module.add(
                    PoseEstimation(
                        name=f"{prefix}{track_idx:03}",
                        pose_estimation_series=series_list,
                        description=f"Estimated positions of {skeleton.name} in video "
                                    f"{video_fn} using SLEAP.",
                        original_videos=[f"{video_fn}"],
                        labeled_videos=[f"{video_fn}"],
                        dimensions=np.array([[video.height or 0, video.width or 0]], dtype="uint16"),
                        scorer=str(labels.provenance),
                        source_software="SLEAP",
                        source_software_version=__version__,
                        nodes=skeleton.node_names,
                        edges=np.asarray(skeleton.edge_inds, dtype="uint32"),
                    )
                )
        io.write(nwb_file)
    finally:
        if io is not None:
            io.close()
