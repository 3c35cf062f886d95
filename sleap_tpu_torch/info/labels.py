"""``sleap-inspect`` on the port: describe a labels file or a run folder.

    python -m sleap_tpu_torch.info.labels labels.slp [--verbose]
    python -m sleap_tpu_torch.info.labels models/run_folder

A copy of :mod:`sleap_tpu.info.labels` on the port's reader: its output
lines are the JAX module's, letter for letter. A directory or a ``.json``
path is described as a model (backbone, head, nodes, and from
``training_log.csv`` the epochs trained and the best ``val_loss``), anything
else as labels.
"""

from __future__ import annotations

import argparse
import csv
import os


def describe_labels(data_path: str, verbose: bool = False) -> None:
    """Print the frames, tracks, videos, skeletons and provenance of a
    ``.slp``."""
    from sleap_tpu_torch.core.labels import Labels

    labels = Labels.load_file(data_path)
    print(f"Labeled frames: {len(labels)}")
    print(f"Tracks: {len(labels.tracks)}")
    print(f"Video files: {len(labels.videos)}")
    for video in labels.videos:
        lfs = labels.find(video)
        first = min((lf.frame_idx for lf in lfs), default=None)
        last = max((lf.frame_idx for lf in lfs), default=None)
        n_user = sum(1 for lf in lfs if lf.has_user_instances)
        n_pred = sum(len(lf.predicted_instances) for lf in lfs)
        print(f"  {video.filename}")
        print(f"    labeled frames: {len(lfs)} (user: {n_user})")
        print(f"    labeled frame range: {first} to {last}")
        print(f"    predicted instances: {n_pred}")
    for skel in labels.skeletons:
        print(f"Skeleton: {skel.name}")
        print(f"  nodes: {skel.node_names}")
        print(f"  edges: {skel.edge_names}")
    if labels.provenance:
        print("Provenance:")
        for k, v in labels.provenance.items():
            print(f"  {k}: {v}")
    if verbose:
        for lf in labels.labeled_frames:
            print(f"frame {lf.frame_idx}: {len(lf.instances)} instances")


def describe_model(model_path: str) -> None:
    """Print a run folder's (or config's) backbone, head and nodes, and the
    epochs trained and best ``val_loss`` from its ``training_log.csv``."""
    from sleap_tpu_torch.config import load_config

    cfg = load_config(model_path)
    print(f"Model: {model_path}")
    print(f"  backbone: {cfg.model.backbone.which_oneof_attrib_name}")
    print(f"  head: {cfg.model.heads.which_oneof_attrib_name}")
    if cfg.data.labels.skeletons:
        print(f"  skeleton nodes: {cfg.data.labels.skeletons[0].node_names}")
    log_path = os.path.join(
        model_path if os.path.isdir(model_path) else os.path.dirname(model_path),
        "training_log.csv",
    )
    if os.path.exists(log_path):
        with open(log_path) as f:
            rows = list(csv.DictReader(f))
        if rows:
            best = min(rows, key=lambda r: float(r.get("val_loss", "inf")))
            print(f"  epochs trained: {len(rows)}")
            print(f"  best val_loss: {best.get('val_loss')} (epoch {best.get('epoch')})")


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description="Inspect a labels file or model.")
    parser.add_argument("data_path")
    parser.add_argument("--verbose", action="store_true")
    ns = parser.parse_args(args)
    if os.path.isdir(ns.data_path) or ns.data_path.endswith(".json"):
        describe_model(ns.data_path)
    else:
        describe_labels(ns.data_path, verbose=ns.verbose)


if __name__ == "__main__":
    main()
