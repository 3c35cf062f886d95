"""Whether ``sleap-track`` with the trained top-down pair gives the same
predictions run after run in one process on the card: runs it in turns on
``tests/torch_data/raw.slp`` and its SWMR-written latest-format twin
``tests/torch_data/hdf5/latest_raw.slp`` (bitwise equal frames), then
prints the largest point difference between every two runs.

    python3 scripts/cli_repeatability.py [--deterministic] [--runs 5]

``--deterministic`` sets ``torch.backends.cudnn.deterministic`` first.
Needs the card and the built kernel library (built at first use).
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from sleap_tpu_torch.io.slp import read_labels  # noqa: E402
from sleap_tpu_torch.ops import cuda_crops, cuda_peaks  # noqa: E402


def max_dxy(a, b) -> float:
    d = 0.0
    for x, y in zip(a, b):
        for p, q in zip(x.instances, y.instances):
            d = max(d, float(np.nanmax(np.abs(p.numpy() - q.numpy()))))
    return d


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--runs", type=int, default=5)
    args = parser.parse_args()
    print(cs.card_line(), flush=True)
    torch.backends.cudnn.deterministic = args.deterministic
    wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
                "global_peaks": cuda_peaks.global_peaks_cuda}
    runs = os.path.join(REPO, ".convergence_runs")
    centroid, instance = (os.path.join(runs, f) for f in cs.CLI_TRAINED[:2])
    sources = {"raw": os.path.join(REPO, *cs.FIXTURE_DIR, "raw.slp"),
               "latest": os.path.join(REPO, *cs.HDF5_DIR, "latest_raw.slp")}
    out = []
    with tempfile.TemporaryDirectory() as root:
        for k in range(args.runs):
            name = ("raw", "latest")[k % 2]
            dst = os.path.join(root, f"{k}.slp")
            cs.cli_run([sources[name], "-m", centroid, "-m", instance, "--peak_threshold", "0.05",
                        "--batch_size", "4", "--verbosity", "none", "-o", dst], wrappers)
            out.append((f"{k}:{name}", read_labels(dst)))
    for (n1, l1), (n2, l2) in itertools.combinations(out, 2):
        print(n1, n2, max_dxy(l1, l2))


if __name__ == "__main__":
    main()
