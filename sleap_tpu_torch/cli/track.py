"""``sleap-track`` on the port: predict (and optionally track) poses on
videos or labels and write them as ``.slp``.

    python -m sleap_tpu_torch.cli.track clip.slp -m centroid_folder -m instance_folder -o out.slp

A copy of :mod:`sleap_tpu.cli.track` with the same flags, input rules
(a ``.slp``, a video file, a ``.csv`` or ``.txt`` list of them, or a
directory), output-path rules and provenance, and its tracking-only branch
for re-tracking a predictions file (``--tracking.tracker`` and no ``-m``).
Where it differs:

- it runs on the card (``"cuda"``) unless ``--cpu`` asks for the CPU; there
  is no fallback;
- media videos are decoded where ``--video.device`` says, by default on
  the device the networks run on: the card reads Motion-JPEG and MPEG-4
  Part 2 (cv2's ``mp4v``/``FMP4``/``XVID``/``DIVX``) in AVI, QuickTime/MP4
  and Matroska files, raw AVI frames, and H.264 in MP4 and Matroska through
  NVDEC (each by content), the CPU any format cv2 reads;
- ``--n-devices N`` runs each batch data-parallel over N replicas, as the
  JAX CLI does: on the first N cards, or with ``--cpu`` on the CPU N times
  (:func:`~sleap_tpu_torch.parallel.distributed.make_sharded_predictor`;
  ``--batch_size`` stays each replica's batch); asking for more cards than
  there are raises;
- ``--compute_dtype bfloat16`` runs the networks in bf16 (the port's
  ``load_model(..., compute_dtype=torch.bfloat16)``).
"""

from __future__ import annotations

import argparse
import logging
import os
import platform
import sys
import time
from datetime import datetime
from typing import List, Optional

import torch

logger = logging.getLogger(__name__)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Run sleap-tpu inference on the PyTorch port.")
    parser.add_argument(
        "data_path", nargs="?", default="",
        help="Video file, labels (.slp), image dir, or list file to predict on.",
    )
    parser.add_argument(
        "-m", "--model", action="append", dest="models", default=None,
        help="Model run folder (repeatable for top-down pairs).",
    )
    parser.add_argument("--frames", default="", help="e.g. 1-100 or 2,4,6")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--no-empty-frames", action="store_true")
    parser.add_argument("--verbosity", choices=("none", "rich", "json"), default="rich")
    parser.add_argument("--video.dataset", dest="video_dataset", default=None)
    parser.add_argument("--video.input_format", dest="video_input_format", default="channels_last")
    parser.add_argument("--video.index", dest="video_index", default="")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
    parser.add_argument(
        "--video.device", dest="video_device", choices=("cuda", "cpu"), default=None,
        help="Where media videos (.mp4, .mov, .mkv, .avi, ...) are decoded: 'cuda' reads, by "
        "content, Motion-JPEG and MPEG-4 Part 2 (mp4v, FMP4, XVID, DIVX: I- and P-VOPs) in AVI, "
        "QuickTime/MP4 and Matroska files (as OpenCV's FFmpeg backend decodes them, edit lists "
        "applied), AVI files of uncompressed frames, and H.264 in MP4/QuickTime and Matroska "
        "through NVDEC; 'cpu' reads any format cv2 reads. Defaults to the device the networks "
        "run on.",
    )
    parser.add_argument(
        "--n-devices", type=int, default=None, dest="n_devices",
        help="Data-parallel inference over this many devices: each takes a slice of every "
        "batch (--batch_size frames). With --cpu, that many replicas on the CPU.",
    )
    parser.add_argument(
        "--compute_dtype", choices=("float32", "bfloat16"), default="float32",
        help="The networks' compute dtype.",
    )
    parser.add_argument("--peak_threshold", type=float, default=0.2)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--max_instances", "-n", type=int, default=None)
    parser.add_argument("--max_edge_length_ratio", type=float, default=0.25)
    parser.add_argument("--dist_penalty_weight", type=float, default=1.0)
    parser.add_argument("--only-labeled-frames", action="store_true")
    parser.add_argument("--only-suggested-frames", action="store_true")
    parser.add_argument("--tracking.tracker", dest="tracking_tracker", default=None)
    parser.add_argument("--tracking.max_tracking", dest="tracking_max_tracking", default=None)
    parser.add_argument("--tracking.max_tracks", dest="tracking_max_tracks", type=int, default=None)
    parser.add_argument("--tracking.target_instance_count", dest="tracking_target_instance_count", type=int, default=0)
    parser.add_argument("--tracking.post_connect_single_breaks", dest="tracking_post_connect_single_breaks", type=int, default=0)
    parser.add_argument("--tracking.clean_instance_count", dest="tracking_clean_instance_count", type=int, default=0)
    parser.add_argument("--tracking.similarity", dest="tracking_similarity", default="instance")
    parser.add_argument("--tracking.match", dest="tracking_match", default="greedy")
    parser.add_argument("--tracking.track_window", dest="tracking_track_window", type=int, default=5)
    parser.add_argument("--tracking.min_new_track_points", dest="tracking_min_new_track_points", type=int, default=0)
    parser.add_argument("--tracking.min_match_points", dest="tracking_min_match_points", type=int, default=0)
    parser.add_argument("--tracking.img_scale", dest="tracking_img_scale", type=float, default=1.0)
    parser.add_argument("--tracking.of_window_size", dest="tracking_of_window_size", type=int, default=21)
    parser.add_argument("--tracking.of_max_levels", dest="tracking_of_max_levels", type=int, default=3)
    parser.add_argument("--tracking.robust", dest="tracking_robust", type=float, default=1.0,
                        help="Robust quantile of similarity scores (1.0 = max).")
    parser.add_argument("--tracking.save_shifted_instances", dest="tracking_save_shifted_instances", type=int, default=0)
    parser.add_argument("--tracking.pre_cull_to_target", dest="tracking_pre_cull_to_target", type=int, default=0)
    parser.add_argument("--tracking.pre_cull_iou_threshold", dest="tracking_pre_cull_iou_threshold", type=float, default=None)
    parser.add_argument("--tracking.clean_iou_threshold", dest="tracking_clean_iou_threshold", type=float, default=None)
    parser.add_argument("--tracking.oks_errors", dest="tracking_oks_errors", default=None,
                        help="Comma-separated per-node errors for object_keypoint similarity.")
    parser.add_argument("--tracking.oks_score_weighting", dest="tracking_oks_score_weighting", type=int, default=0)
    parser.add_argument("--tracking.oks_normalization", dest="tracking_oks_normalization", default="all")
    parser.add_argument("--tracking.kf_init_frame_count", dest="tracking_kf_init_frame_count", type=int, default=0,
                        help="If >0, run Kalman filters initialized from this many tracked frames.")
    parser.add_argument("--tracking.kf_node_indices", dest="tracking_kf_node_indices", default=None,
                        help="Comma-separated node indices to use for Kalman filtering.")
    return parser


def parse_frames(frames: str) -> Optional[List[int]]:
    """``"1-3,7"`` -> ``[1, 2, 3, 7]``; an empty string -> None."""
    if not frames:
        return None
    out: List[int] = []
    for part in frames.split(","):
        part = part.strip()
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def _read_csv_paths(path: str):
    """A CSV input's data paths (the first column whose first data row is
    an existing path) and output paths (the column after it, where every row
    has one)."""
    import csv as csvlib

    with open(path, newline="") as f:
        rows = [r for r in csvlib.reader(f) if r]
    if len(rows) < 2:
        raise ValueError(f"CSV file is empty: {path}")
    data_rows = rows[1:]
    col = next((ci for ci, cell in enumerate(data_rows[0]) if cell and os.path.exists(cell)), None)
    if col is None:
        raise ValueError(f"Column containing valid data_paths does not exist in the CSV file: {path}")
    data_paths = [r[col] for r in data_rows]
    out_col = col + 1
    output_paths = None
    if all(len(r) > out_col and r[out_col] for r in data_rows):
        output_paths = [r[out_col] for r in data_rows]
    return data_paths, output_paths


def make_provider_from_cli(ns):
    """The inputs as ``(providers, data paths, output paths or None)``."""
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.data.providers import LabelsReader, VideoReader

    path = ns.data_path
    frames = parse_frames(ns.frames)
    if not path:
        raise ValueError(
            "You must specify a path to a video or a labels dataset. "
            "Run 'sleap-track -h' to see full command documentation."
        )
    if not os.path.exists(path):
        raise ValueError("Path to data_path does not exist")

    output_path_list = None
    if os.path.isfile(path):
        if path.lower().endswith(".csv"):
            raw_paths, output_path_list = _read_csv_paths(path)
        elif path.lower().endswith(".txt"):
            with open(path) as f:
                raw_paths = [line.strip() for line in f if line.strip()]
        else:
            raw_paths = [path]
    else:  # a directory: every file in it
        raw_paths = sorted(
            os.path.join(path, n) for n in os.listdir(path) if os.path.isfile(os.path.join(path, n))
        )

    provider_list, data_path_list = [], []
    for file_path in raw_paths:
        if file_path.endswith(".slp") and len(raw_paths) > 1:
            print(f"slp file skipped: {file_path}")
            continue
        if file_path.endswith(".slp"):
            labels = Labels.load_file(file_path, device=_video_device(ns))
            if ns.only_labeled_frames:
                inds = [i for i, lf in enumerate(labels.labeled_frames) if lf.has_user_instances]
                provider_list.append(LabelsReader(labels=labels, example_indices=inds))
            elif ns.only_suggested_frames:
                provider_list.append(LabelsReader.from_unlabeled_suggestions(labels))
            elif ns.video_index != "":
                provider_list.append(
                    VideoReader(video=labels.videos[int(ns.video_index)], example_indices=frames)
                )
            elif frames is not None and labels.video is not None:
                provider_list.append(VideoReader(video=labels.video, example_indices=frames))
            else:
                provider_list.append(LabelsReader(labels=labels))
            data_path_list.append(file_path)
        else:
            kwargs = {}
            if ns.video_dataset:
                kwargs["dataset"] = ns.video_dataset
            if ns.video_input_format:
                kwargs["input_format"] = ns.video_input_format
            try:
                provider_list.append(VideoReader.from_filepath(
                    file_path, example_indices=frames, device=_video_device(ns), **kwargs))
            except ValueError:  # no video backend for this file's extension
                print(f"Error reading file: {file_path}")
                continue
            data_path_list.append(file_path)
    return provider_list, data_path_list, output_path_list


def _device(ns) -> str:
    return "cpu" if ns.cpu else "cuda"


def _video_device(ns) -> str:
    """Where media videos are decoded: ``--video.device``, else the device
    the networks run on."""
    return ns.video_device or _device(ns)


def make_predictor_from_cli(ns):
    from sleap_tpu_torch.inference.predictors import Predictor

    if not ns.models:
        raise SystemExit("At least one model (-m) is required.")
    return Predictor.from_model_paths(
        ns.models,
        device=_device(ns),
        peak_threshold=ns.peak_threshold,
        batch_size=ns.batch_size,
        max_instances=ns.max_instances,
        compute_dtype=getattr(torch, ns.compute_dtype),
        verbosity=ns.verbosity,
    )


def make_tracker_from_cli(ns):
    if ns.tracking_tracker is None:
        return None
    from sleap_tpu_torch.tracking.tracker import Tracker

    return Tracker.make_tracker_by_name(
        tracker=ns.tracking_tracker,
        similarity=ns.tracking_similarity,
        match=ns.tracking_match,
        track_window=ns.tracking_track_window,
        max_tracks=ns.tracking_max_tracks,
        max_tracking=bool(ns.tracking_max_tracking),
        min_new_track_points=ns.tracking_min_new_track_points,
        min_match_points=ns.tracking_min_match_points,
        img_scale=ns.tracking_img_scale,
        of_window_size=ns.tracking_of_window_size,
        of_max_levels=ns.tracking_of_max_levels,
        target_instance_count=ns.tracking_target_instance_count,
        post_connect_single_breaks=bool(ns.tracking_post_connect_single_breaks),
        clean_instance_count=ns.tracking_clean_instance_count,
        robust=ns.tracking_robust,
        save_shifted_instances=bool(ns.tracking_save_shifted_instances),
        pre_cull_to_target=bool(ns.tracking_pre_cull_to_target),
        pre_cull_iou_threshold=ns.tracking_pre_cull_iou_threshold,
        clean_iou_threshold=ns.tracking_clean_iou_threshold,
        oks_errors=(
            [float(v) for v in ns.tracking_oks_errors.split(",")] if ns.tracking_oks_errors else None
        ),
        oks_score_weighting=bool(ns.tracking_oks_score_weighting),
        oks_normalization=ns.tracking_oks_normalization,
        kf_init_frame_count=ns.tracking_kf_init_frame_count,
        kf_node_indices=(
            [int(v) for v in ns.tracking_kf_node_indices.split(",")]
            if ns.tracking_kf_node_indices else None
        ),
        device=_device(ns),
    )


def _default_output(data_path: str) -> str:
    """``x/y.mp4`` -> ``x/y.predictions.slp``."""
    root, _ext = os.path.splitext(data_path)
    return root + ".predictions.slp"


def main(args: Optional[List[str]] = None) -> None:
    """Predict on every input and write each one's ``.slp``; or, with a
    tracker and no model, re-track a predictions file. Float32 runs with
    TF32 off for the whole process."""
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.precision import disable_tf32
    from sleap_tpu_torch.version import __version__

    disable_tf32()
    logging.basicConfig(level=logging.INFO)
    t0 = time.time()
    start_timestamp = str(datetime.now())
    ns = make_parser().parse_args(args)

    provider_list, data_path_list, output_path_list = make_provider_from_cli(ns)

    output_path = None
    if output_path_list is None and ns.output is not None:
        output_path = ns.output
        if os.path.isfile(output_path) and len(data_path_list) > 1:
            raise ValueError(
                "output_path argument must be a directory if multiple video inputs are given"
            )

    tracker = make_tracker_from_cli(ns)

    def base_provenance(labels_pr, data_path, out):
        labels_pr.provenance.update(
            {
                "sleap_version": __version__,
                "platform": platform.platform(),
                "command": " ".join(sys.argv),
                "data_path": data_path,
                "output_path": str(out),
                "total_elapsed": time.time() - t0,
                "start_timestamp": start_timestamp,
                "finish_timestamp": str(datetime.now()),
            }
        )

    mesh = None
    if ns.models is not None and ns.n_devices and ns.n_devices > 1:
        from sleap_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_devices=ns.n_devices, devices=[_device(ns)] * ns.n_devices if ns.cpu else None)

    if ns.models is not None:
        for i, (data_path, provider) in enumerate(zip(data_path_list, provider_list)):
            predictor = make_predictor_from_cli(ns)
            if mesh is not None:
                from sleap_tpu_torch.parallel.distributed import make_sharded_predictor

                predictor = make_sharded_predictor(predictor, mesh)
            predictor.tracker = tracker
            labels_pr = predictor.predict(provider)

            if output_path is None:
                out = output_path_list[i] if output_path_list else _default_output(data_path)
            elif len(data_path_list) > 1:
                # -o names a directory when there are several inputs.
                out = os.path.join(output_path, os.path.basename(_default_output(data_path)))
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            else:
                out = output_path

            if ns.no_empty_frames:
                labels_pr.remove_empty_frames()
            labels_pr.provenance["model_paths"] = ns.models
            labels_pr.provenance["predictor"] = type(predictor).__name__
            base_provenance(labels_pr, data_path, out)
            labels_pr.provenance["args"] = dict(vars(ns))
            try:
                labels_pr.save(out)
            except OSError:
                print("WARNING: Provided output path invalid.")
                out = _default_output(data_path)
                labels_pr.save(out)
            if ns.verbosity != "none":
                print(f"\nSaved {len(labels_pr)} frames to {out}")
            output_path = ns.output  # reset for the next input
    elif ns.tracking_tracker is not None:
        from sleap_tpu_torch.tracking.tracker import run_tracker

        data_path = ns.data_path
        labels_pr = Labels.load_file(data_path, device=_video_device(ns))
        frames = sorted(labels_pr.labeled_frames, key=lambda lf: lf.frame_idx)
        frames = run_tracker(frames=frames, tracker=tracker)
        tracker.final_pass(frames)
        labels_pr = Labels(labeled_frames=frames)
        out = output_path or f"{data_path}.{tracker.get_name()}.slp"
        if ns.no_empty_frames:
            labels_pr.remove_empty_frames()
        base_provenance(labels_pr, data_path, out)
        labels_pr.save(out)
        if ns.verbosity != "none":
            print(f"\nSaved {len(labels_pr)} frames to {out}")
    else:
        raise ValueError(
            "You must specify at least one model (-m) or a tracker (--tracking.tracker) to run."
        )


if __name__ == "__main__":
    main()
