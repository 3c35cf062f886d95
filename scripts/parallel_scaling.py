#!/usr/bin/env python3
"""Data-parallel scaling over the cards of one machine: sharded top-down
inference FPS and data-parallel training images/s on 1, 2, ... cards.

    python3 scripts/parallel_scaling.py [--cards 1,2,4]

Inference: ``chip_smoke.py`` phase 4's float32 top-down pair (seeded
weights, full width, 1024^2 frames) at 16 frames a card, through
``make_sharded_predictor`` over the first n cards (n = 1: the predictor
itself): a warm-up global batch, then TIMED_BATCHES timed ones, three
times in turns; on the same 64 frames, the points held within 1e-3 px of the
one-card run.
Training: phase 7's centroid UNet at full width, 16 frames a card,
``Trainer.from_config(..., devices=<first n cards>).train()`` (n = 1: one
process; else a spawned rank a card over NCCL) for EPOCHS epochs of STEPS
steps and one validation step, no run folder; images/s from the epochs after
the first (its seconds hold the ranks' start). Prints the card line, then
one JSON line per measurement. Needs as many cards as the largest n.
"""

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TIMED_BATCHES, REPEATS = 6, 3
EPOCHS, STEPS = 3, 10


def topdown_predictor():
    import sleap_tpu_torch

    with tempfile.TemporaryDirectory() as root:
        folders = cs.write_run_folders(root)
        gen = torch.Generator().manual_seed(0)
        paths = [folders["centroid"], folders["instance"]]
        params = {p: cs.seeded_params(p, gen) for p in paths}
        return sleap_tpu_torch.load_model(paths, params=params, batch_size=cs.BATCH,
                                          max_instances=cs.MAX_INSTANCES)


def inference(pred, cards):
    from sleap_tpu_torch.parallel.distributed import make_sharded_predictor
    from sleap_tpu_torch.parallel.mesh import make_mesh

    frames = cs.synthetic_frames((1 + TIMED_BATCHES) * cs.BATCH * max(cards), seed=0)
    runs = {n: make_sharded_predictor(dataclasses.replace(pred), make_mesh(n)) if n > 1 else pred
            for n in cards}
    fps, outs = {n: [] for n in cards}, {}
    for _ in range(REPEATS):
        for n, p in runs.items():
            gb = p.batch_size
            use = frames[:(1 + TIMED_BATCHES) * gb]
            p.predict(use[:gb], make_labels=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict(use[gb:], make_labels=False)
            torch.cuda.synchronize()
            fps[n].append((len(use) - gb) / (time.perf_counter() - t0))
    for n, p in runs.items():  # the same frames through each
        outs[n] = cs.merged(p.predict(frames[:4 * cs.BATCH], make_labels=False), 4 * cs.BATCH)
    for n in cards:
        diff = cs.same_points(f"{n} cards", outs[n], outs[cards[0]], ("centroids", "instance_peaks"))
        print(json.dumps({"inference": {"cards": n, "global_batch": runs[n].batch_size,
                                        "fps": fps[n], "fps_median": float(np.median(fps[n])),
                                        "max_dxy_vs_first": diff}}), flush=True)


def training(cards):
    from sleap_tpu_torch.training.trainer import Trainer

    labels = cs.labels_of(*cs.phase7_recipe(16, seed=5))
    for n in cards:
        cfg = cs.train_config("centroid", batch=cs.TRAIN_BATCH * n)
        cfg.optimization.epochs = EPOCHS
        cfg.optimization.batches_per_epoch = STEPS
        cfg.optimization.val_batches_per_epoch = 1
        devices = [torch.device("cuda", i) for i in range(n)] if n > 1 else None
        trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                      devices=devices)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        steady = trainer.epoch_seconds[1:]
        print(json.dumps({"training": {
            "cards": n, "global_batch": cs.TRAIN_BATCH * n, "train_s": time.perf_counter() - t0,
            "epoch_s": trainer.epoch_seconds, "losses": [r["loss"] for r in trainer.log_rows],
            "images_per_s": STEPS * cs.TRAIN_BATCH * n * len(steady) / sum(steady)}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", default="1,2,4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("parallel_scaling: CUDA is not available; this script needs the cards.")
    cards = [int(c) for c in args.cards.split(",")]
    if max(cards) > torch.cuda.device_count():
        raise SystemExit(f"parallel_scaling: {max(cards)} cards asked for, "
                         f"{torch.cuda.device_count()} visible.")
    from sleap_tpu_torch.ops import _build

    _build.build_library()
    print(cs.card_line(), flush=True)
    inference(topdown_predictor(), cards)
    training(cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
