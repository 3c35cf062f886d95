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
- ``--n-devices`` and ``--spatial-sharding`` above 1 raise: data-parallel
  and spatially sharded training are not ported (ROADMAP.md, queue 1,
  item 12);
- ``--tensorboard`` and ``--zmq`` set the config as in JAX, and the
  trainer then raises ``NotImplementedError`` (not ported);
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
        "--n-devices", type=int, default=None, dest="n_devices",
        help="Data-parallel training over this many devices; only 1 is ported.",
    )
    parser.add_argument(
        "--mixed-precision", action="store_true", dest="mixed_precision",
        help="Run the forward and backward passes in bfloat16; parameters, optimizer "
        "state and the loss stay float32.",
    )
    parser.add_argument(
        "--spatial-sharding", type=int, default=1, dest="spatial_sharding",
        help="Shard frame height over this many devices; only 1 is ported.",
    )
    return parser


def create_trainer_using_cli(args: Optional[List[str]] = None):
    """Parse the flags, load the profile, apply the overrides and build the
    trainer of its head type."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.training.trainer import Trainer

    ns = make_parser().parse_args(args)
    for flag, value in (("--n-devices", ns.n_devices), ("--spatial-sharding", ns.spatial_sharding)):
        if value is not None and value > 1:
            raise NotImplementedError(
                f"{flag} {value}: multi-card training is not ported yet "
                "(ROADMAP.md, queue 1, item 12)."
            )

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

    return Trainer.from_config(cfg, device="cpu" if ns.cpu else "cuda")


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
