#!/usr/bin/env python3
"""A CPU rehearsal of ``chip_smoke.py`` phase 9a: the port's copies of the
shipped ``baseline.centroid`` and ``baseline_medium_rf.topdown`` profiles,
with phase 9's cuts, trained through ``sleap-train --cpu`` on the same
two-size project (IMG^2 and TRAIN_CLI_SMALL^2 HDF5 videos of blob animals),
each scored after training, then ``sleap-track --cpu`` of the pair on the
validation frames. Prints each model's epoch losses, CLI and evaluation
seconds and validation metrics, and the tracked animals' mean node errors:
what sizes phase 9's cuts and bounds before a chip call.

    JAX_PLATFORMS=cpu python3 scripts/train_cli_cpu.py

Imports ``chip_smoke.py`` for its project, profile cuts and helpers, so that
it runs what phase 9a runs, at full size.
"""

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from sleap_tpu_torch.cli import track
    from sleap_tpu_torch.io.slp import read_labels

    with tempfile.TemporaryDirectory() as root:
        project = cs.write_cli_project(root)
        folders = {}
        for name, profile in cs.TRAIN_CLI_PROFILES:
            path, _ = cs.cut_profile(profile, root)
            total_s, setup_s, _, evaluations = cs.train_with_cli(path, project, name, {}, ["--cpu"])
            folders[name] = os.path.join(root, name)
            with open(os.path.join(folders[name], "training_log.csv")) as f:
                losses = [round(float(line.split(",")[1]), 6) for line in f.readlines()[1:]]
            print(f"{name}: CLI {total_s:.1f} s on the CPU (setup {setup_s:.1f} s); epoch losses "
                  f"{losses}", flush=True)
            for e in evaluations:
                print(f"  evaluation ({e['split']}): {e['seconds']:.2f} s; "
                      f"{cs.metric_line(e['metrics'])}", flush=True)
        val_path = os.path.join(folders["instance"], "labels_gt.val.slp")
        out = os.path.join(root, "val.predictions.slp")
        track.main([val_path, "-m", folders["centroid"], "-m", folders["instance"], "--cpu",
                    "--verbosity", "none", "-o", out])
        errs = cs.animal_errors(read_labels(out), read_labels(val_path))
    print(f"sleap-track on the validation frames: {len(errs)} animals, mean node error median "
          f"{np.median(errs):.3f} px, max {errs.max():.3f} px")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
