"""``sleap-train`` on the port: train a model from a training profile and
labels, then score it.

    python -m sleap_tpu_torch.cli.train baseline.centroid.json labels.slp [--cpu]

A copy of :mod:`sleap_tpu.cli.train` with the same flags and config
overrides. ``training_job_path`` is a profile JSON (the shipped ones are in
``sleap_tpu_torch/training_profiles/``) or a run folder, whose
``training_config.json`` (else ``initial_config.json``) is read. The run
folder (``outputs.runs_folder``/``run_name``) ends up holding
``best_model.pt``, the configs, ``training_log.csv``,
``labels_gt.{train,val}.slp``, ``labels_pr.{train,val}.slp`` and
``metrics.{train,val}.npz``. Where it differs:

- it trains on the card (``"cuda"``) unless ``--cpu`` asks for the CPU;
  there is no fallback;
- the labels' media videos are decoded where ``--video.device`` says, by
  default on the device it trains on: the card reads Motion-JPEG in AVI,
  QuickTime/MP4 and Matroska files, raw AVI frames, and H.264 in MP4 and
  Matroska through NVDEC (each by content), the CPU any format cv2 reads;
- ``--n-devices N`` trains data-parallel as the JAX CLI does, one process
  per device: on the first N cards, or with ``--cpu`` on the CPU N times;
  the caller spawns the other ranks (under ``torchrun`` each process is a
  rank of its group instead) and alone writes the run folder; asking for
  more cards than there are raises. ``--spatial-sharding S`` shares each
  data index among S of those devices, each holding a horizontal band of
  its frames (``--n-devices`` defaults to S, where the JAX CLI ignores S
  without ``--n-devices``);
- ``--tensorboard`` and ``--zmq`` set the config as in JAX, and the
  trainer acts on both: it writes TensorBoard logs, and with ``--zmq`` it
  publishes its progress on ``--publish_port`` and takes ``stop`` and
  ``set_lr`` commands on ``--controller_port`` (pyzmq);
- ``--save_viz`` is parsed and not applied, as in the JAX package's CLI.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

logger = logging.getLogger(__name__)


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a sleap-tpu model on the PyTorch port.")
    parser.add_argument(
        "training_job_path",
        help="Path to a training job profile JSON or a model run folder.",
    )
    parser.add_argument(
        "labels_path", nargs="?", default=None,
        help="Path to labels (.slp) to use for training.",
    )
    parser.add_argument("--val_labels", "--val", default=None)
    parser.add_argument("--test_labels", "--test", default=None)
    parser.add_argument("--base_checkpoint", default=None)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--save_viz", action="store_true")
    parser.add_argument("--zmq", action="store_true")
    parser.add_argument("--controller_port", type=int, default=9000)
    parser.add_argument("--publish_port", type=int, default=9001)
    parser.add_argument("--run_name", default=None)
    parser.add_argument("--prefix", default="")
    parser.add_argument("--suffix", default="")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU instead of the card.")
    parser.add_argument(
        "--video.device", dest="video_device", choices=("cuda", "cpu"), default=None,
        help="Where media videos (.mp4, .mov, .mkv, .avi, ...) are decoded: 'cuda' reads, by "
        "content, Motion-JPEG in AVI, QuickTime/MP4 and Matroska files (as OpenCV's FFmpeg "
        "backend decodes it, edit lists applied), AVI files of uncompressed frames, and H.264 in "
        "MP4/QuickTime and Matroska through NVDEC; 'cpu' reads any format cv2 reads. Defaults to "
        "the device the networks run on.",
    )
    parser.add_argument(
        "--n-devices", type=int, default=None, dest="n_devices",
        help="Data-parallel training over this many devices (default: 1): one process each, "
        "params replicated, batches split, gradients averaged. With --cpu, that many ranks on "
        "the CPU.",
    )
    parser.add_argument(
        "--mixed-precision", action="store_true", dest="mixed_precision",
        help="Run the forward and backward passes in bfloat16; parameters, optimizer "
        "state and the loss stay float32.",
    )
    parser.add_argument(
        "--spatial-sharding", type=int, default=1, dest="spatial_sharding",
        help="Shard frame height over this many devices (default: 1): each data index's frames "
        "are split into this many horizontal bands, one a device, exchanging rows at the band "
        "edges; it lets frames too large for one card's memory train. --n-devices must be a "
        "multiple (it defaults to this).",
    )
    return parser


def create_trainer_using_cli(args: Optional[List[str]] = None):
    """Parse the flags, load the profile, apply the overrides and build the
    trainer of its head type."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.training.trainer import Trainer

    ns = make_parser().parse_args(args)
    cfg = TrainingJobConfig.load_json(ns.training_job_path)
    if ns.labels_path:
        cfg.data.labels.training_labels = ns.labels_path
    if ns.val_labels:
        cfg.data.labels.validation_labels = ns.val_labels
    if ns.test_labels:
        cfg.data.labels.test_labels = ns.test_labels
    if ns.base_checkpoint:
        cfg.model.base_checkpoint = ns.base_checkpoint
    if ns.run_name:
        cfg.outputs.run_name = ns.run_name
    if ns.prefix:
        cfg.outputs.run_name_prefix = ns.prefix
    if ns.suffix:
        cfg.outputs.run_name_suffix = ns.suffix
    if ns.mixed_precision:
        cfg.optimization.mixed_precision = True
    if ns.tensorboard:
        cfg.outputs.tensorboard.write_logs = True
    if ns.zmq:
        cfg.outputs.zmq.publish_updates = True
        cfg.outputs.zmq.subscribe_to_controller = True
        cfg.outputs.zmq.controller_address = f"tcp://127.0.0.1:{ns.controller_port}"
        cfg.outputs.zmq.publish_address = f"tcp://127.0.0.1:{ns.publish_port}"

    return Trainer.from_config(cfg, device="cpu" if ns.cpu else "cuda",
                               video_device=ns.video_device, n_devices=ns.n_devices,
                               spatial_sharding=ns.spatial_sharding)


def main(args: Optional[List[str]] = None) -> None:
    """Train from the command line; float32 runs with TF32 off for the
    whole process."""
    from sleap_tpu_torch.precision import disable_tf32

    disable_tf32()
    logging.basicConfig(level=logging.INFO)
    trainer = create_trainer_using_cli(args)
    trainer.train()


if __name__ == "__main__":
    main()
