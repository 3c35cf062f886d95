"""Reading AlphaTracker JSON (:mod:`sleap_tpu.io.formats.alphatracker`):
an entry an image; in its annotations each "Face" box starts an animal
whose following "point" annotations are its nodes, named 1, 2, ..."""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video


def read_labels(filename: str, skeleton: Optional[Skeleton] = None, device="cuda") -> Labels:
    with open(filename) as f:
        data = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(filename))

    max_pts = 0
    for entry in data:
        count = 0
        for ann in entry.get("annotations", []):
            if ann.get("class") == "Face":
                count = 0
            elif ann.get("class") == "point":
                count += 1
                max_pts = max(max_pts, count)
    if skeleton is None:
        skeleton = Skeleton(name="alphatracker")
        skeleton.add_nodes([str(i + 1) for i in range(max_pts)])

    img_paths = []
    for entry in data:
        fn = entry.get("filename") or entry.get("file") or ""
        img_paths.append(fn if os.path.exists(fn) else os.path.join(base_dir, os.path.basename(fn)))
    video = Video.from_image_filenames(img_paths, device=device)

    lfs = []
    for frame_idx, entry in enumerate(data):
        instances: List[Instance] = []
        current: Optional[np.ndarray] = None
        n = 0
        for ann in entry.get("annotations", []):
            if ann.get("class") == "Face":
                if current is not None:
                    instances.append(Instance(skeleton=skeleton, points=current))
                current = np.full((skeleton.n_nodes, 2), np.nan)
                n = 0
            elif ann.get("class") == "point" and current is not None:
                if n < skeleton.n_nodes:
                    current[n] = (ann["x"], ann["y"])
                n += 1
        if current is not None:
            instances.append(Instance(skeleton=skeleton, points=current))
        if instances:
            lfs.append(LabeledFrame(video=video, frame_idx=frame_idx, instances=instances))
    return Labels(labeled_frames=lfs, videos=[video], skeletons=[skeleton])
