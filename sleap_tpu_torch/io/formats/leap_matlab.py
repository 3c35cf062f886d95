"""Reading LEAP's MATLAB ``labels.mat`` (:mod:`sleap_tpu.io.formats.leap_matlab`,
through scipy's ``loadmat``): ``positions`` (nodes, 2, frames) and a
``skeleton`` struct (node names, 1-based edges), over the HDF5 box file of
``boxPath`` where it exists (beside the file too), else a placeholder."""

from __future__ import annotations

import os

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.io.video import DummyVideo, Video


def read_labels(filename: str, gui: bool = False, device="cuda") -> Labels:
    from scipy.io import loadmat

    mat = loadmat(filename)
    positions = mat["positions"]  # (nodes, 2, frames)
    n_nodes = positions.shape[0]

    node_names = [str(i + 1) for i in range(n_nodes)]
    edges = []
    if "skeleton" in mat:
        try:
            skel_struct = mat["skeleton"][0, 0]
            fields = skel_struct.dtype.names or ()
            if "nodes" in fields:
                names = [str(np.squeeze(n)) for n in skel_struct["nodes"].flatten()]
                if len(names) == n_nodes:
                    node_names = names
            if "edges" in fields:
                edges = (np.asarray(skel_struct["edges"]) - 1).tolist()
        except Exception:
            pass

    skeleton = Skeleton(name="leap")
    skeleton.add_nodes(node_names)
    for e in edges:
        try:
            skeleton.add_edge(node_names[int(e[0])], node_names[int(e[1])])
        except Exception:
            continue

    video = None
    if "boxPath" in mat:
        box_path = str(np.squeeze(mat["boxPath"]))
        beside = os.path.join(os.path.dirname(os.path.abspath(filename)), os.path.basename(box_path))
        for cand in (box_path, beside):
            if os.path.exists(cand):
                video = Video.from_hdf5(dataset="box", filename=cand, input_format="channels_first",
                                        device=device)
                break
    if video is None:
        video = Video(DummyVideo(filename="missing_box.h5", frames=positions.shape[2]))

    lfs = []
    for fi in range(positions.shape[2]):
        pts = positions[:, :, fi].astype("f8")
        if np.all(np.isnan(pts)) or np.all(pts == 0):
            continue
        lfs.append(LabeledFrame(video=video, frame_idx=fi, instances=[Instance(skeleton=skeleton, points=pts)]))
    return Labels(labeled_frames=lfs, videos=[video], skeletons=[skeleton])
