"""NIX (nixtrack) export: :mod:`sleap_tpu.io.formats.nix` on the port's
data model.

The nixtrack layout (github.com/bendalab/nixtrack): one block a video of
flat per-instance arrays (``frame``, ``position`` (instances, 2, nodes),
``track``, ``skeleton``, ``node score``, ``centroid``, ``instance score``,
``tracking score``) bound by a MultiTag, with skeleton, node and track map
data frames. Write-only, as in the JAX package.

:func:`assemble_nix_arrays` is plain numpy; :func:`write_labels` imports
``nixio`` inside, as the JAX module does, and raises ``ImportError`` naming it
where it is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.io.video import Video


def _require_nixio():
    try:
        import nixio  # noqa: F401
    except ImportError as e:
        raise ImportError("NIX export requires the 'nixio' package (pip install nixio).") from e


def _check_video(labels: Labels, video: Optional[Video]) -> Video:
    """The video to write: ``video``, which must be one of the project's
    with labeled frames, or else the project's first."""
    if video is None and len(labels.videos) == 0:
        raise ValueError("There are no videos in this project. No analysis file will be written.")
    if video is not None:
        if not any(v is video for v in labels.videos):
            raise ValueError(
                f"Specified video {video} is not part of this project. "
                "Skipping the analysis file for this video."
            )
        if len(labels.find(video)) == 0:
            raise ValueError(
                f"No labeled frames in {video.filename}. "
                "Skipping the analysis file for this video."
            )
        return video
    return labels.videos[0]


def assemble_nix_arrays(labels: Labels, video: Video) -> Dict[str, object]:
    """A video's instances, in frame order, as nixtrack's flat arrays and
    map tables: ``{"arrays", "maps", "n_instances"}``."""
    instances = [
        inst
        for lf in sorted(labels.find(video), key=lambda lf: lf.frame_idx)
        for inst in lf.instances
    ]
    nodes = {node: i for i, node in enumerate(labels.skeleton.nodes)}
    tracks = {t: i for i, t in enumerate(labels.tracks)}
    skeletons = {s: i for i, s in enumerate(labels.skeletons)}
    n = len(instances)
    n_nodes = len(nodes)
    arrays = {
        "frame": np.zeros(n, "i8"),
        "position": np.full((n, 2, n_nodes), np.nan, "f8"),
        "track": np.zeros(n, "i8"),
        "skeleton": np.zeros(n, "i8"),
        "node_score": np.zeros((n, n_nodes), "f8"),
        "centroid": np.zeros((n, 2), "f8"),
        "instance_score": np.zeros(n, "f8"),
        "tracking_score": np.zeros(n, "f8"),
    }
    for i, inst in enumerate(instances):
        arrays["frame"][i] = inst.frame.frame_idx if inst.frame is not None else 0
        arrays["track"][i] = tracks.get(inst.track, -1) if inst.track else -1
        arrays["skeleton"][i] = skeletons.get(inst.skeleton, 0)
        pts = inst.numpy()
        for node, idx in nodes.items():
            if node in inst.skeleton.nodes:  # else the node stays NaN
                arrays["position"][i, :, idx] = pts[inst.skeleton.nodes.index(node)]
        with np.errstate(all="ignore"):
            arrays["centroid"][i] = np.nanmean(pts, axis=0)
        scores = getattr(inst, "scores", None)
        if scores is not None:
            arrays["node_score"][i] = np.nan_to_num(scores)
            arrays["instance_score"][i] = getattr(inst, "score", 0.0)
            arrays["tracking_score"][i] = getattr(inst, "tracking_score", 0.0)
    maps = {
        "skeleton_map": [(s.name or f"skeleton{i}", i) for s, i in skeletons.items()],
        "node_map": [
            (node.name, float(node.weight), i,
             next((si for s, si in skeletons.items() if node in s.nodes), -1))
            for node, i in nodes.items()
        ],
        "track_map": [("none", -1, -1)] + [(t.name, int(t.spawned_on), i) for t, i in tracks.items()],
    }
    return {"arrays": arrays, "maps": maps, "n_instances": n}


def write_labels(
    filename: str,
    labels: Labels,
    video: Optional[Video] = None,
    project: Optional[str] = None,
) -> None:
    """Write a nixtrack analysis file of one video (the first by default)."""
    _require_nixio()
    import nixio as nix

    video = _check_video(labels, video)
    data = assemble_nix_arrays(labels, video)
    arrays, maps = data["arrays"], data["maps"]
    n = data["n_instances"]
    node_names = [node.name for node in labels.skeleton.nodes]

    nf = nix.File.open(filename, nix.FileMode.Overwrite)
    try:
        s = nf.create_section("TrackingAnalysis", "nix.tracking.metadata")
        s["version"] = "0.1.0"
        s["format"] = "nix.tracking"
        s["definitions"] = "https://github.com/bendalab/nixtrack"
        s["writer"] = "sleap_tpu_torch.io.formats.nix"
        if project is not None:
            s["project"] = project

        name = Path(video.filename).name
        b = nf.create_block(name, "nix.tracking_results")
        src = b.create_source(name, "nix.tracking.source.video")
        sec = src.file.create_section(name, "nix.tracking.source.video.metadata")
        sec["filename"] = video.filename
        sec["fps"] = float(getattr(video.backend, "fps", 0.0) or 0.0)
        sec.props["fps"].unit = "Hz"
        sec["frames"] = video.num_frames
        sec["height"] = video.height
        sec["width"] = video.width
        src.metadata = sec

        frameid = b.create_data_array(
            "frame", "nix.tracking.instance_frameidx", label="frame index",
            shape=(n,), dtype=nix.DataType.Int64,
        )
        frameid.append_range_dimension_using_self()
        frameid[:] = arrays["frame"]

        def feature_array(name, type_, shape, dtype, values):
            arr = b.create_data_array(name, type_, dtype=dtype, shape=shape)
            rd = arr.append_range_dimension()
            rd.link_data_array(frameid, [-1])
            arr[:] = values
            return arr

        positions = b.create_data_array(
            "position", "nix.tracking.instance_position",
            dtype=nix.DataType.Float, shape=(n, 2, len(node_names)), label="pixel",
        )
        rd = positions.append_range_dimension()
        rd.link_data_array(frameid, [-1])
        positions.append_set_dimension(["x", "y"])
        positions.append_set_dimension(node_names)
        positions[:] = arrays["position"]

        track_arr = feature_array("track", "nix.tracking.instance_track", (n,),
                                  nix.DataType.Int64, arrays["track"])
        skeleton_arr = feature_array("skeleton", "nix.tracking.instance_skeleton", (n,),
                                     nix.DataType.Int64, arrays["skeleton"])
        point_score = feature_array("node score", "nix.tracking.nodes_score", (n, len(node_names)),
                                    nix.DataType.Float, arrays["node_score"])
        point_score.append_set_dimension(node_names)
        centroid_arr = feature_array("centroid", "nix.tracking.centroid_position", (n, 2),
                                     nix.DataType.Float, arrays["centroid"])
        centroid_arr.append_set_dimension(["x", "y"])
        instance_score = feature_array("instance score", "nix.tracking.instance_score", (n,),
                                       nix.DataType.Float, arrays["instance_score"])
        tracking_score = feature_array("tracking score", "nix.tracking.tack_score", (n,),
                                       nix.DataType.Float, arrays["tracking_score"])

        mtag = b.create_multi_tag("tracking results", "nix.tracking.results", positions=frameid)
        mtag.references.append(positions)
        for arr in (track_arr, skeleton_arr, point_score, instance_score, tracking_score, centroid_arr):
            mtag.create_feature(arr, nix.LinkType.Indexed)

        sm = b.create_data_frame(
            "skeleton map", "nix.tracking.skeleton_map",
            col_names=["name", "index"],
            col_dtypes=[nix.DataType.String, nix.DataType.Int8],
        )
        sm.append_rows(maps["skeleton_map"])
        nm = b.create_data_frame(
            "node map", "nix.tracking.node_map",
            col_names=["name", "weight", "index", "skeleton"],
            col_dtypes=[nix.DataType.String, nix.DataType.Float, nix.DataType.Int8, nix.DataType.Int8],
        )
        nm.append_rows(maps["node_map"])
        tm = b.create_data_frame(
            "track map", "nix.tracking.track_map",
            col_names=["name", "spawned_on", "index"],
            col_dtypes=[nix.DataType.String, nix.DataType.Int64, nix.DataType.Int8],
        )
        tm.append_rows(maps["track_map"])
    finally:
        nf.close()
