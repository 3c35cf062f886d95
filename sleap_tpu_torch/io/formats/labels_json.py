"""Reading the JSON project format (:mod:`sleap_tpu.io.formats.labels_json`):
one document, plain, gzip-compressed or in a ``.zip``, with ``skeletons``
over a shared ``nodes`` list, ``videos`` (backend dicts), ``tracks`` and
``labels`` (frames of instances with per-node ``_points``), as
:meth:`Labels.to_dict` writes it."""

from __future__ import annotations

import gzip
import json
import zipfile

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame, PredictedInstance, Track, empty_points
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Node, Skeleton
from sleap_tpu_torch.io.slp import _make_video_search
from sleap_tpu_torch.io.video import Video


def _load_json_document(filename: str) -> dict:
    if filename.endswith(".zip"):
        with zipfile.ZipFile(filename) as zf:
            name = [n for n in zf.namelist() if n.endswith(".json")][0]
            with zf.open(name) as f:
                return json.loads(f.read())
    with open(filename, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def read_labels(filename: str, video_search=None, device="cuda") -> Labels:
    data = _load_json_document(filename)
    nodes = [Node(n["name"], n.get("weight", 1.0)) for n in data.get("nodes", [])]
    skeletons = [Skeleton.from_dict(sd, node_list=nodes) for sd in data.get("skeletons", [])]
    search = _make_video_search(filename, video_search)
    videos = [Video.from_dict(vd, video_search=search, device=device) for vd in data.get("videos", [])]
    tracks = []
    for td in data.get("tracks", []):
        if isinstance(td, dict):
            tracks.append(Track(td.get("spawned_on", 0), td.get("name", "")))
        else:
            tracks.append(Track(int(td[0]), str(td[1])))

    lfs = []
    for frame in data.get("labels", []):
        lf = LabeledFrame(video=videos[int(frame["video"])], frame_idx=int(frame["frame_idx"]))
        for inst_d in frame.get("_instances", []):
            skel = skeletons[int(inst_d.get("skeleton", 0))] if skeletons else None
            t_ref = inst_d.get("track")
            track = tracks[int(t_ref)] if t_ref is not None and int(t_ref) < len(tracks) else None
            is_pred = "score" in inst_d or inst_d.get("py/object", "").endswith("PredictedInstance")
            pts = empty_points(skel.n_nodes, predicted=is_pred)
            for key, pd in (inst_d.get("_points") or {}).items():
                ni = int(key)
                if ni >= len(pts):
                    continue
                pts[ni]["x"] = pd.get("x", np.nan)
                pts[ni]["y"] = pd.get("y", np.nan)
                pts[ni]["visible"] = bool(pd.get("visible", True))
                pts[ni]["complete"] = bool(pd.get("complete", False))
                if is_pred:
                    pts[ni]["score"] = pd.get("score", 1.0)
            if is_pred:
                inst = PredictedInstance(skeleton=skel, points=pts, track=track,
                                         score=float(inst_d.get("score", 0.0)))
            else:
                inst = Instance(skeleton=skel, points=pts, track=track)
            lf.insert_instance(inst)
        lfs.append(lf)
    return Labels(labeled_frames=lfs, videos=videos, skeletons=skeletons, tracks=tracks)
