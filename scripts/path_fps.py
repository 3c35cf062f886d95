#!/usr/bin/env python3
"""Frames per second of ``chip_smoke.py``'s top-down (float32) and
bottom-up (bf16) paths, timed several times in one process, to compare two
checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/path_fps.py --label NAME [--repeats 5]

The package and ``chip_smoke.py`` both come from the checkout that
``sleap_tpu_torch`` resolves to, so the same command, run once per checkout
in turns (A, B, B, A), compares two trees on their own configurations.
Each repeat is ``chip_smoke.run_path``: a warm-up batch, then 8 timed
batches of ``predict(make_labels=False)`` on the same seeded frames and
weights. One timed window is about 0.2 s, so a single reading swings with
the host's load; the median of the repeats is the figure to compare.
Prints one JSON line: the label, the card and every repeat's FPS.
"""

import argparse
import importlib.util
import json
import statistics
import sys
import tempfile
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("path_fps: CUDA is not available; this script needs one GPU.")
    import sleap_tpu_torch
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    root = Path(sleap_tpu_torch.__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = cs.synthetic_frames((1 + cs.TIMED_BATCHES) * cs.BATCH, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        preds = cs.load_predictors(cs.write_run_folders(tmp))
    topdown, bottomup = preds[0], preds[2][0]
    paths = {
        "top-down": (topdown, {"local_peaks": cuda_peaks.local_peaks_cuda,
                               "crop_unit": cuda_crops.crop_unit_cuda,
                               "global_peaks": cuda_peaks.global_peaks_cuda}),
        "bottom-up": (bottomup, {"local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda}),
    }
    fps = {name: [] for name in paths}
    for _ in range(args.repeats):
        for name, (pred, wrappers) in paths.items():
            fps[name].append(cs.run_path(name, pred, frames, wrappers)[2])
    print(json.dumps({
        "label": args.label, "package": str(root), "card": cs.card_line(), "fps": fps,
        "median": {name: statistics.median(v) for name, v in fps.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
