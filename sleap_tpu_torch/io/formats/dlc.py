"""Reading DeepLabCut labels: :mod:`sleap_tpu.io.formats.dlc` without
``yaml`` (the project's ``config.yaml`` goes through the port's YAML subset,
:mod:`sleap_tpu_torch.io.yamlsubset`) or ``pandas``.

:func:`read_labels` reads a ``CollectedData`` CSV, single-animal or
multi-animal (an ``individuals`` header row; named individuals become
tracks, spawned on their first frame), its image paths resolved from the
CSV's directory and its ancestors. :func:`read_config` reads a project:
the skeleton from the config, then every ``labeled-data/<subdir>``'s CSV.

Three faults of the JAX reader are not copied (ROADMAP.md queue 3, item 5):
a multi-animal skeleton is taken when ``multianimalbodyparts`` is present
(the JAX reader asks for ``multianimalproject``); a ``bodyparts`` that is
not a list (maDLC's ``MULTI!``) adds no nodes (the JAX reader adds one a
character); and where ``videos/<subdir>.*`` exists, the subdir's frames are
that video's, indexed by the number in ``imgNNNN`` (the JAX reader keeps
the images, in row order).
"""

from __future__ import annotations

import csv as csv_mod
import glob
import os
import re
from typing import Optional

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame, Track
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.io.yamlsubset import yaml_load


def _resolve_image(path: str, base_dir: str) -> str:
    candidates = [path, os.path.join(base_dir, os.path.basename(path))]
    anc = base_dir
    for _ in range(4):
        candidates.append(os.path.join(anc, path))
        anc = os.path.dirname(anc)
    return next((c for c in candidates if os.path.exists(c)), path)


def _frame_number(image_path: str) -> int:
    """The frame number DeepLabCut writes into ``imgNNNN.png``."""
    name = os.path.basename(image_path)
    match = re.search(r"img(\d+)", name) or re.search(r"(\d+)", name)
    if match is None:
        raise ValueError(f"No frame number in the DeepLabCut image name {name!r}.")
    return int(match.group(1))


def read_config(filename: str, device="cuda") -> Labels:
    """A DeepLabCut project from its ``config.yaml``: a skeleton of its body
    parts, then the labels of each ``labeled-data/<subdir>/CollectedData*.csv``
    on it, over ``videos/<subdir>.*`` where it exists."""
    with open(filename) as f:
        project = yaml_load(f.read()) or {}

    def names(key):
        value = project.get(key)
        return list(value) if isinstance(value, list) else []

    skeleton = Skeleton(name="deeplabcut")
    if "multianimalbodyparts" in project:
        skeleton.add_nodes(names("multianimalbodyparts"))
        for name in names("uniquebodyparts"):
            skeleton.add_node(name)
    else:
        skeleton.add_nodes(names("bodyparts"))

    root_dir = os.path.dirname(os.path.abspath(filename))
    merged: Optional[Labels] = None
    for subdir in sorted(glob.glob(os.path.join(root_dir, "labeled-data", "*"))):
        if not os.path.isdir(subdir):
            continue
        csvs = sorted(glob.glob(os.path.join(subdir, "CollectedData*.csv")))
        if not csvs:
            continue
        videos = sorted(glob.glob(os.path.join(root_dir, "videos", os.path.basename(subdir) + ".*")))
        labels = read_labels(csvs[0], skeleton=skeleton, full_video=videos[0] if videos else None,
                             device=device)
        if merged is None:
            merged = labels
        else:
            merged.extend_from(labels)
    return merged if merged is not None else Labels(labeled_frames=[], skeletons=[skeleton])


def read_labels(filename: str, skeleton: Optional[Skeleton] = None, full_video: Optional[str] = None,
                device="cuda") -> Labels:
    """A ``CollectedData`` CSV, single- or multi-animal. With ``full_video``
    the frames are that video's, at the numbers of their image names; else
    the images themselves, in row order."""
    with open(filename) as f:
        rows = list(csv_mod.reader(f))  # header rows can be ragged
    header_names = [r[0].strip() for r in rows[:4]]
    has_individuals = "individuals" in header_names
    n_header = 4 if has_individuals else 3
    headers, data_rows = rows[:n_header], rows[n_header:]
    n_cols = max(len(r) for r in data_rows) - 1

    def header_row(label):
        for r in headers:
            if r[0].strip() == label:
                return [(r[i + 1] if i + 1 < len(r) else "") for i in range(n_cols)]
        return [""] * n_cols

    inds_row = header_row("individuals") if has_individuals else [None] * n_cols
    parts_row, coords_row = header_row("bodyparts"), header_row("coords")
    # The v2 layout splits the image path over the first columns, under
    # empty header cells.
    n_index = 1
    while n_index <= len(parts_row) and parts_row[n_index - 1] == "":
        n_index += 1
    if n_index > 1:
        inds_row, parts_row, coords_row = (row[n_index - 1:] for row in (inds_row, parts_row, coords_row))
    columns = list(zip(inds_row, parts_row, coords_row))

    df_index = [os.path.join(*r[:n_index]) for r in data_rows]
    df_data = []
    for r in data_rows:
        vals = {}
        for i, col in enumerate(columns):
            raw = r[i + n_index] if i + n_index < len(r) else ""
            vals[col] = float(raw) if raw not in ("", None) else np.nan
        df_data.append(vals)

    individuals = list(dict.fromkeys(c[0] if has_individuals else None for c in columns))
    node_names = list(dict.fromkeys(c[1] for c in columns))
    if skeleton is None:
        skeleton = Skeleton(name="deeplabcut")
        skeleton.add_nodes(node_names)
    else:
        for name in node_names:
            if not skeleton.has_node(name):
                skeleton.add_node(name)

    tracks: dict = {}

    def track_for(ind, frame_idx):
        if ind is None:
            return None
        if ind not in tracks:
            tracks[ind] = Track(spawned_on=frame_idx, name=str(ind))
        return tracks[ind]

    col_map = {(c[0] if has_individuals else None, c[1], str(c[2])): c for c in columns}
    base_dir = os.path.dirname(os.path.abspath(filename))
    img_paths = [_resolve_image(str(idx), base_dir) for idx in df_index]
    if full_video is not None:
        video = Video.from_filename(full_video, device=device)
        frame_idxs = [_frame_number(p) for p in img_paths]
    else:
        video = Video.from_image_filenames(img_paths, device=device)
        frame_idxs = list(range(len(img_paths)))

    lfs = []
    for row_i, row in enumerate(df_data):
        instances = []
        for ind in individuals:
            pts = np.full((skeleton.n_nodes, 2), np.nan)
            visible = False
            for ni, part in enumerate(skeleton.node_names):
                for ci, coord in enumerate(("x", "y")):
                    col = col_map.get((ind, part, coord))
                    if col is None:
                        continue
                    val = row.get(col, np.nan)
                    if not np.isnan(val):
                        pts[ni, ci] = float(val)
                        visible = True
            if visible:
                instances.append(Instance(skeleton=skeleton, points=pts,
                                          track=track_for(ind, frame_idxs[row_i])))
        if instances:
            lfs.append(LabeledFrame(video=video, frame_idx=frame_idxs[row_i], instances=instances))
    return Labels(labeled_frames=lfs, videos=[video], skeletons=[skeleton], tracks=list(tracks.values()))
