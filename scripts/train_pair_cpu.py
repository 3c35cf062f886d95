#!/usr/bin/env python3
"""A CPU rehearsal of ``chip_smoke.py`` phase 7c at a reduced size: the
top-down pair (centroid at input scale 0.25, then centered instance)
trained from scratch on frames of blob animals, the run folders loaded
with ``load_model(..., device="cpu")`` from their ``best_model.pt``, and
held-out frames predicted, with each model's epoch losses and the held-out
animals' mean node errors printed. It sizes the chip run's steps and its
localisation bound before a chip call.

    JAX_PLATFORMS=cpu python3 scripts/train_pair_cpu.py

Imports ``chip_smoke.py`` for its data, config and error helpers, so that it
trains what phase 7c trains, at the sizes below (512^2 frames instead of
1024^2, UNet filters 16 instead of 64).
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
SIZE, MARGIN, GAP = 512, 80, 120  # frame side; blob centres this far inside, this far apart
FILTERS, EPOCHS, BATCHES, BATCH_SIZE = 16, 20, 15, 8


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    import sleap_tpu_torch
    from sleap_tpu_torch.training.trainer import Trainer

    frames, points = cs.blob_animals(40, seed=7, size=SIZE, margin=MARGIN, gap=GAP)
    labels = cs.labels_of(frames[:32], points[:32])
    with tempfile.TemporaryDirectory() as root:
        folders = []
        for head, scaling in (("centroid", 0.25), ("topdown", 1.0)):
            cfg = cs.train_config(head, filters=FILTERS, input_scaling=scaling,
                                  lr=cs.PAIR_LR, batch=BATCH_SIZE)
            cfg.optimization.epochs = EPOCHS
            cfg.optimization.batches_per_epoch = BATCHES
            cfg.optimization.val_batches_per_epoch = 1
            cfg.outputs.save_outputs = True
            cfg.outputs.runs_folder, cfg.outputs.run_name = root, head
            trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                          device="cpu")
            t0 = time.perf_counter()
            trainer.train()
            print(f"{head}: epoch losses {[round(r['loss'], 6) for r in trainer.log_rows]} "
                  f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
            folders.append(os.path.join(root, head))
        pred = sleap_tpu_torch.load_model(folders, device="cpu", batch_size=4,
                                          max_instances=cs.MAX_INSTANCES)
        errs = cs.pair_errors(pred.predict(frames[32:], make_labels=False), points[32:])
    print(f"held-out mean node error: median {np.median(errs):.3f} px, max {errs.max():.3f} px "
          f"over {len(errs)} animals")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
