"""Reading COCO keypoint annotations (:mod:`sleap_tpu.io.formats.coco`):
a skeleton a category (1-based edges), an image a frame, an instance an
annotation, its points those with visibility above 0."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import Video


def read_labels(filename: str, img_dir: Optional[str] = None, device="cuda") -> Labels:
    with open(filename) as f:
        data = json.load(f)
    img_dir = img_dir or os.path.dirname(os.path.abspath(filename))

    skeletons: Dict[int, Skeleton] = {}
    for cat in data.get("categories", []):
        skel = Skeleton(name=cat.get("name", f"category_{cat['id']}"))
        names = cat.get("keypoints", [])
        skel.add_nodes(names)
        for src, dst in cat.get("skeleton", []):
            skel.add_edge(names[src - 1], names[dst - 1])
        skeletons[cat["id"]] = skel

    images = {img["id"]: img for img in data.get("images", [])}
    img_ids = sorted(images.keys())
    img_paths = []
    for iid in img_ids:
        fn = images[iid].get("file_name", "")
        cands = (fn, os.path.join(img_dir, fn), os.path.join(img_dir, os.path.basename(fn)))
        img_paths.append(next((c for c in cands if os.path.exists(c)), fn))
    video = Video.from_image_filenames(img_paths, device=device)
    frame_for_img = {iid: i for i, iid in enumerate(img_ids)}

    frames: Dict[int, LabeledFrame] = {}
    for ann in data.get("annotations", []):
        if "keypoints" not in ann:
            continue
        skel = skeletons.get(ann.get("category_id"))
        if skel is None:
            continue
        kps = np.asarray(ann["keypoints"], "f8").reshape(-1, 3)
        pts = np.full((skel.n_nodes, 2), np.nan)
        vis = kps[:, 2] > 0
        pts[vis] = kps[vis, :2]
        fi = frame_for_img.get(ann["image_id"])
        if fi is None:
            continue
        if fi not in frames:
            frames[fi] = LabeledFrame(video=video, frame_idx=fi)
        frames[fi].insert_instance(Instance(skeleton=skel, points=pts))
    return Labels(labeled_frames=[frames[k] for k in sorted(frames)], videos=[video],
                  skeletons=list(skeletons.values()))
