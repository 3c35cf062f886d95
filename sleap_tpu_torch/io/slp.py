"""Read and write ``.slp`` labels files (SLEAP's HDF5 format, format_id
1.2) without h5py: a copy of :mod:`sleap_tpu.io.slp` on the port's own HDF5
reader and writer (:mod:`sleap_tpu_torch.io.hdf5`).

A file holds a ``metadata`` group (attributes ``format_id`` and ``json``:
skeletons as node-link dicts over a shared node list, provenance, negative
anchors), ``videos_json``, ``tracks_json`` and ``suggestions_json`` (arrays
of JSON strings), and the compound tables ``frames``, ``instances``,
``points`` and ``pred_points``. Training packages (``.pkg.slp``) add
embedded frames under ``video{N}/``.

:func:`write_labels` writes the tables and JSON lists contiguous and
uncompressed; in-memory videos are written as raw, deflated
``video{N}_raw`` datasets that the file's own video entries point at. With
``save_frame_data`` the frames of the labeled (and, if asked, suggested)
frames are embedded as a training package: per video a group ``video{N}``
of PNG rows (deflated int8, one row a chunk), ``frame_numbers`` and
``source_video``, pointed at through the filename ``"."``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from sleap_tpu_torch.core.instance import (
    POINT_DTYPE,
    PRED_POINT_DTYPE,
    Instance,
    LabeledFrame,
    PredictedInstance,
    Track,
)
from sleap_tpu_torch.core.labels import Labels, SuggestionFrame
from sleap_tpu_torch.core.skeleton import Node, Skeleton
from sleap_tpu_torch.io import hdf5
from sleap_tpu_torch.io.video import HDF5Video, NumpyVideo, Video, imencode_rows, write_encoded

FORMAT_ID = 1.2

FRAME_DTYPE = np.dtype(
    [
        ("frame_id", "u8"),
        ("video", "u4"),
        ("frame_idx", "u8"),
        ("instance_id_start", "u8"),
        ("instance_id_end", "u8"),
    ]
)

INSTANCE_DTYPE = np.dtype(
    [
        ("instance_id", "i8"),
        ("instance_type", "u1"),
        ("frame_id", "u8"),
        ("skeleton", "u4"),
        ("track", "i4"),
        ("from_predicted", "i8"),
        ("score", "f4"),
        ("point_id_start", "u8"),
        ("point_id_end", "u8"),
        ("tracking_score", "f4"),  # added in format 1.2
    ]
)

USER_INSTANCE = 0
PREDICTED_INSTANCE = 1


def _as_str(raw) -> str:
    """A fixed-length (``np.bytes_``) or variable-length (``bytes`` or
    ``str``) string as ``str``."""
    return raw.decode() if isinstance(raw, bytes) else str(raw)


def _make_video_search(
    slp_path: str, video_search: Optional[Union[Callable, List[str], bool]]
) -> Callable:
    """Resolver for stored (often relative) video paths.

    Tries the callback or the listed paths, the path as it is, then every
    suffix of the stored path under the listed paths and under the ``.slp``
    file's directory and its ancestors; a file among the listed paths also
    stands for its directory. ``video_search=False`` keeps stored paths
    verbatim.
    """
    slp_dir = os.path.dirname(os.path.abspath(slp_path))

    if video_search is False:
        return lambda path: path

    def search(path: Optional[str]) -> Optional[str]:
        if path is None:
            return None
        if callable(video_search):
            fixed = video_search(path)
            if fixed and os.path.exists(fixed):
                return fixed
        if os.path.exists(path):
            return path
        hints = list(video_search) if isinstance(video_search, (list, tuple)) else []
        base = os.path.basename(path.replace("\\", "/"))
        for hint in hints:
            if os.path.isfile(hint):
                cand = os.path.join(os.path.dirname(hint), base)
                if os.path.exists(cand):
                    return cand
        anc = slp_dir
        for _ in range(6):
            hints.append(anc)
            anc = os.path.dirname(anc)
        # Every suffix of the stored path under every hint: resolves paths
        # recorded on other machines and operating systems.
        parts = path.replace("\\", "/").split("/")
        suffixes = ["/".join(parts[i:]) for i in range(len(parts))][-6:]
        for hint in hints:
            for suffix in suffixes:
                cand = os.path.join(hint, suffix)
                if os.path.exists(cand):
                    return cand
        return path

    return search


def read_labels(
    filename: str,
    video_search: Optional[Union[Callable, List[str], bool]] = None,
    device="cuda",
) -> Labels:
    """Load a ``.slp`` file into :class:`Labels`; its media videos decode on
    ``device`` (the card unless the caller asks for the CPU), and its LZF
    chunks on that device's route (:class:`~sleap_tpu_torch.io.hdf5.File`)."""
    with hdf5.File(filename, device=device) as f:
        meta = json.loads(_as_str(f["metadata"].attrs["json"]))
        format_id = float(f["metadata"].attrs.get("format_id", 1.0))

        nodes = [Node(n["name"], n.get("weight", 1.0)) for n in meta.get("nodes", [])]
        skeletons = [Skeleton.from_dict(sd, node_list=nodes) for sd in meta.get("skeletons", [])]

        search = _make_video_search(filename, video_search)
        video_dicts = []
        if "videos_json" in f:
            video_dicts = [json.loads(_as_str(raw)) for raw in f["videos_json"][:]]

        # Positional replacement: when as many search paths as videos are
        # given, their extensions pairwise match, and the stored paths are
        # still missing after the search, each search path replaces the
        # video at its own index.
        positional: Dict[int, str] = {}
        hints = list(video_search) if isinstance(video_search, (list, tuple)) else []
        ext = lambda p: str(p).rsplit(".", 1)[-1]  # noqa: E731
        if hints and len(hints) == len(video_dicts):
            stored = [d.get("backend", {}).get("filename") for d in video_dicts]
            if all(isinstance(s, str) for s in stored) and all(
                ext(s) == ext(h) for s, h in zip(stored, hints)
            ):
                for i, (s, h) in enumerate(zip(stored, hints)):
                    fixed = search(s)
                    if (fixed is None or not os.path.exists(fixed)) and os.path.exists(str(h)):
                        positional[i] = str(h)

        videos: List[Video] = []
        for i, d in enumerate(video_dicts):
            backend = d.get("backend", {})
            fn = backend.get("filename")
            if fn == "." or fn == filename:
                backend["filename"] = filename
                video = Video.from_dict(d, device=device)
            elif i in positional:
                backend["filename"] = positional[i]
                video = Video.from_dict(d, device=device)
            else:
                video = Video.from_dict(d, video_search=search, device=device)
            videos.append(video)

        tracks: List[Track] = []
        if "tracks_json" in f and f["tracks_json"].shape[0]:
            for raw in f["tracks_json"][:]:
                item = json.loads(_as_str(raw))
                if isinstance(item, dict):
                    tracks.append(Track(spawned_on=item.get("spawned_on", 0), name=item.get("name", "")))
                else:
                    tracks.append(Track(spawned_on=int(item[0]), name=str(item[1])))

        suggestions: List[SuggestionFrame] = []
        if "suggestions_json" in f and f["suggestions_json"].shape[0]:
            for raw in f["suggestions_json"][:]:
                item = json.loads(_as_str(raw))
                try:
                    vid = videos[int(item.get("video"))]
                except (TypeError, ValueError, IndexError):
                    continue
                suggestions.append(
                    SuggestionFrame(video=vid, frame_idx=int(item.get("frame_idx", 0)),
                                    group=item.get("group"))
                )

        points = f["points"][:] if "points" in f else np.zeros(0, dtype=POINT_DTYPE)
        pred_points = f["pred_points"][:] if "pred_points" in f else np.zeros(0, PRED_POINT_DTYPE)
        # Files before format 1.1 stored user points with the top-left pixel
        # corner at (0, 0) instead of (-0.5, -0.5); predictions are unshifted.
        if format_id < 1.1 and points.shape[0]:
            points["x"] -= 0.5
            points["y"] -= 0.5
        inst_table = f["instances"][:] if "instances" in f else np.zeros(0, dtype=INSTANCE_DTYPE)
        frame_table = f["frames"][:] if "frames" in f else np.zeros(0, dtype=FRAME_DTYPE)

    has_tracking_score = "tracking_score" in (inst_table.dtype.names or ())

    # Instances in a first pass, their from_predicted links in a second.
    instances: List[Any] = []
    for rec in inst_table:
        skel = skeletons[int(rec["skeleton"])] if skeletons else None
        track = tracks[int(rec["track"])] if int(rec["track"]) >= 0 else None
        i0, i1 = int(rec["point_id_start"]), int(rec["point_id_end"])
        if int(rec["instance_type"]) == PREDICTED_INSTANCE:
            inst = PredictedInstance(
                skeleton=skel,
                points=pred_points[i0:i1].astype(PRED_POINT_DTYPE),
                track=track,
                score=float(rec["score"]) if not np.isnan(rec["score"]) else 0.0,
                tracking_score=float(rec["tracking_score"]) if has_tracking_score else 0.0,
            )
        else:
            inst = Instance(skeleton=skel, points=points[i0:i1].astype(POINT_DTYPE), track=track)
        instances.append(inst)

    for rec, inst in zip(inst_table, instances):
        fp = int(rec["from_predicted"])
        if 0 <= fp < len(instances):
            inst.from_predicted = instances[fp]

    labeled_frames = [
        LabeledFrame(
            video=videos[int(rec["video"])],
            frame_idx=int(rec["frame_idx"]),
            instances=instances[int(rec["instance_id_start"]):int(rec["instance_id_end"])],
        )
        for rec in frame_table
    ]
    return Labels(
        labeled_frames=labeled_frames,
        videos=videos,
        skeletons=skeletons,
        tracks=tracks,
        suggestions=suggestions,
        negative_anchors=meta.get("negative_anchors", {}) or {},
        provenance=meta.get("provenance", {}) or {},
    )


def _serialize_metadata(labels: Labels) -> Dict[str, Any]:
    """The ``metadata/json`` dict: skeletons over one node list shared by
    all of them (in order of first appearance)."""
    all_nodes: List[Node] = []
    for skel in labels.skeletons:
        for node in skel.nodes:
            if not any(node is n for n in all_nodes):
                all_nodes.append(node)
    node_to_idx = {node: i for i, node in enumerate(all_nodes)}
    anchors = labels.negative_anchors
    return {
        "version": "2.0.0",
        "skeletons": [s.to_dict(node_to_idx) for s in labels.skeletons],
        "nodes": [{"name": n.name, "weight": n.weight} for n in all_nodes],
        "videos": [],
        "tracks": [],
        "suggestions": [],
        "negative_anchors": anchors
        if isinstance(anchors, dict) and not any(isinstance(k, Video) for k in anchors)
        else {},
        "provenance": labels.provenance,
    }


def _json_bytes(obj) -> np.bytes_:
    return np.bytes_(json.dumps(obj, separators=(",", ":")))


def write_labels(
    filename: str,
    labels: Labels,
    save_frame_data: bool = False,
    all_labeled: bool = False,
    suggested: bool = False,
    image_format: str = "png",
    append: bool = False,
    device=None,
) -> None:
    """Write :class:`Labels` as ``.slp``.

    Frames and instances are written in the order of ``labeled_frames``; a
    user instance's score is NaN on disk and a missing track is -1.
    ``save_frame_data`` embeds the images of the frames with user instances
    (every labeled frame with ``all_labeled``, and the suggested ones with
    ``suggested``) as ``image_format`` rows (``png``, ``jpg``, ``bmp`` or
    ``tif``; JPEG and TIFF encoded on ``device``, by default each video's),
    and points the file's videos at them.
    ``append=True`` merges into an existing file: its project is read, the
    new frames merged in (videos matched by filename, skeletons by node
    names) and the file written again.
    """
    if append and os.path.exists(filename):
        base = read_labels(filename, video_search=False)
        base.extend_from(labels, unify=True)
        base_keys = {}
        for v in base.videos:
            fn = getattr(getattr(v, "backend", None), "filename", None)
            if isinstance(fn, str):
                base_keys[os.path.basename(fn)] = v
        seen = {(id(s.video), s.frame_idx) for s in base.suggestions}
        for s in labels.suggestions:
            fn = getattr(getattr(s.video, "backend", None), "filename", None)
            video = base_keys.get(os.path.basename(fn)) if isinstance(fn, str) else None
            if video is not None:
                s = SuggestionFrame(video, s.frame_idx, s.group)
            if (id(s.video), s.frame_idx) not in seen:
                base.suggestions.append(s)
        base.provenance.update(labels.provenance)
        labels = base

    with hdf5.Writer(filename) as f:
        videos = list(labels.videos)
        if save_frame_data:
            videos = _embed_frame_data(f, labels, image_format, all_labeled, suggested, device)
        md = f.require_group("metadata")
        md.attrs["format_id"] = FORMAT_ID
        md.attrs["json"] = _json_bytes(_serialize_metadata(labels))

        # An in-memory video is written as raw frames that the file's own
        # entry (filename ".") points at, so the project reads back whole.
        videos_json = []
        for i, video in enumerate(videos):
            if isinstance(video.backend, NumpyVideo):
                name = f"video{i}_raw"
                f.create_dataset(name, data=video.backend.data, compression="gzip")
                videos_json.append(_json_bytes({"backend": {
                    "type": "HDF5Video", "filename": ".", "dataset": name,
                    "input_format": "channels_last", "convert_range": False,
                }}))
                continue
            d = video.to_dict()
            if save_frame_data and isinstance(video.backend, HDF5Video) \
                    and video.backend.filename == filename:
                d["backend"]["filename"] = "."
            videos_json.append(_json_bytes(d))
        _write_json_dataset(f, "videos_json", videos_json)
        _write_json_dataset(f, "tracks_json", [_json_bytes([t.spawned_on, t.name]) for t in labels.tracks])
        video_to_idx = {id(v): i for i, v in enumerate(labels.videos)}
        _write_json_dataset(f, "suggestions_json", [
            _json_bytes({"video": str(video_to_idx[id(s.video)]), "frame_idx": s.frame_idx,
                         "group": s.group})
            for s in labels.suggestions
            if id(s.video) in video_to_idx
        ])

        skel_to_idx = {id(s): i for i, s in enumerate(labels.skeletons)}
        track_to_idx = {id(t): i for i, t in enumerate(labels.tracks)}
        all_instances = [inst for lf in labels.labeled_frames for inst in lf.instances]
        inst_to_id = {id(inst): i for i, inst in enumerate(all_instances)}

        points_list, pred_points_list = [], []
        inst_recs = np.zeros(len(all_instances), dtype=INSTANCE_DTYPE)
        n_points = n_pred_points = 0
        for i, inst in enumerate(all_instances):
            if inst.predicted:
                start = n_pred_points
                pred_points_list.append(inst.points.astype(PRED_POINT_DTYPE))
                n_pred_points += len(inst.points)
                end = n_pred_points
            else:
                start = n_points
                points_list.append(inst.points.astype(POINT_DTYPE))
                n_points += len(inst.points)
                end = n_points
            from_predicted = getattr(inst, "from_predicted", None)
            inst_recs[i] = (
                i,
                PREDICTED_INSTANCE if inst.predicted else USER_INSTANCE,
                0,  # frame_id, set below
                skel_to_idx.get(id(inst.skeleton), 0),
                track_to_idx.get(id(inst.track), -1) if inst.track is not None else -1,
                inst_to_id.get(id(from_predicted), -1) if from_predicted is not None else -1,
                getattr(inst, "score", np.nan),
                start,
                end,
                getattr(inst, "tracking_score", 0.0),
            )

        frame_recs = np.zeros(len(labels.labeled_frames), dtype=FRAME_DTYPE)
        cursor = 0
        for fi, lf in enumerate(labels.labeled_frames):
            n = len(lf.instances)
            frame_recs[fi] = (fi, video_to_idx.get(id(lf.video), 0), lf.frame_idx, cursor, cursor + n)
            inst_recs["frame_id"][cursor:cursor + n] = fi
            cursor += n

        tables = {
            "points": np.concatenate(points_list) if points_list else np.zeros(0, POINT_DTYPE),
            "pred_points": np.concatenate(pred_points_list) if pred_points_list
            else np.zeros(0, PRED_POINT_DTYPE),
            "instances": inst_recs,
            "frames": frame_recs,
        }
        for name, table in tables.items():
            f.create_dataset(name, data=table, compression=None)


def _write_json_dataset(f: hdf5.Writer, name: str, items: List[np.bytes_]) -> None:
    """Fixed-length strings, or an empty float64 dataset when there are none."""
    f.create_dataset(name, data=np.array(items) if items else np.zeros(0), compression=None)


def _embed_frame_data(f: hdf5.Writer, labels: Labels, image_format: str, all_labeled: bool,
                      suggested: bool, device=None) -> List[Video]:
    """Embed each video's frames (those with user instances; every labeled
    one with ``all_labeled``; plus the suggested ones with ``suggested``)
    as ``video{N}/video`` rows, ``video{N}/frame_numbers`` and
    ``video{N}/source_video``; return videos of them, in the order of
    ``labels.videos``."""
    suggested_by_video: Dict[int, set] = {}
    if suggested:
        for s in labels.suggestions:
            suggested_by_video.setdefault(id(s.video), set()).add(s.frame_idx)
    new_videos = []
    for v_idx, video in enumerate(labels.videos):
        frame_nums = {lf.frame_idx for lf in labels.find(video) if all_labeled or lf.has_user_instances}
        frame_nums = sorted(frame_nums | suggested_by_video.get(id(video), set()))
        group = f"video{v_idx}"
        rows = imencode_rows((video.get_frame(i) for i in frame_nums), image_format,
                             video._device(device))
        write_encoded(f, f"{group}/video", rows, image_format,
                      (video.height, video.width, video.channels))
        f.create_dataset(f"{group}/frame_numbers", data=np.array(frame_nums, dtype=np.int64),
                         compression=None)
        f.require_group(f"{group}/source_video").attrs["json"] = json.dumps(
            video.to_dict(), separators=(",", ":"))
        new_videos.append(Video(HDF5Video(filename=f.filename, dataset=f"{group}/video",
                                          input_format="channels_last", convert_range=False,
                                          device=getattr(video.backend, "device", "cuda"))))
    return new_videos
