#!/usr/bin/env python3
"""Where the time of ``chip_smoke.py``'s paths goes on the card.

    python3 scripts/path_profile.py [--paths NAME,NAME] [--batches 4]

For each path (``chip_smoke.py``'s configurations and seeded weights, the
same frames): a warm-up batch; ``--batches`` batches of
``predict(make_labels=False)`` timed by the host clock and synchronised;
then the same batches under ``torch.profiler`` (CPU and CUDA activity).
Prints one JSON line a path: the card, wall ms a batch (without the
profiler), device ms a batch (the sum of the device kernels' self time;
one stream, so kernels do not overlap), the device's busy share of the wall
time, device kernels a batch, and the ten device kernels that take the most
time (ms and launches a batch).
"""

import argparse
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # this checkout's package

PATHS = ("top-down", "bottom-up", "top-down bf16", "single-instance bf16",
         "top-down multiclass", "bottom-up multiclass bf16")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS), help="comma-separated, of: " + ", ".join(PATHS))
    ap.add_argument("--batches", type=int, default=4)
    args = ap.parse_args()
    names = args.paths.split(",")
    unknown = sorted(set(names) - set(PATHS))
    if unknown:
        raise SystemExit(f"path_profile: unknown paths {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("path_profile: CUDA is not available; this script needs one GPU.")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import sleap_tpu_torch

    root = Path(sleap_tpu_torch.__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    frames = cs.synthetic_frames((1 + args.batches) * cs.BATCH, seed=0)
    si_frames = cs.synthetic_frames((1 + args.batches) * cs.SI_BATCH, seed=1, size=cs.SI_IMG,
                                    blobs=1)
    with tempfile.TemporaryDirectory() as tmp:
        folders = cs.write_run_folders(tmp)
        td, _, bu, td_bf16, si = cs.load_predictors(folders)
        td_mc, _, bu_mc = cs.load_multiclass(folders)
    preds = {
        "top-down": (td, frames, cs.BATCH),
        "bottom-up": (bu[0], frames, cs.BATCH),
        "top-down bf16": (td_bf16, frames, cs.BATCH),
        "single-instance bf16": (si, si_frames, cs.SI_BATCH),
        "top-down multiclass": (td_mc, frames, cs.BATCH),
        "bottom-up multiclass bf16": (bu_mc, frames, cs.BATCH),
    }
    for name in names:
        pred, path_frames, batch = preds[name]
        pred.predict(path_frames[:batch], make_labels=False)  # warm-up
        torch.cuda.synchronize()
        timed = path_frames[batch:]
        t0 = time.perf_counter()
        pred.predict(timed, make_labels=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.batches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pred.predict(timed, make_labels=False)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / args.batches
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
        print(json.dumps({
            "path": name, "card": card, "batch": batch, "batches": args.batches,
            "wall_ms_per_batch": wall_ms, "device_ms_per_batch": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernels_per_batch": sum(e.count for e in kernels) / args.batches,
            "top": [[e.key[:80], e.self_device_time_total / 1e3 / args.batches,
                     e.count / args.batches] for e in top],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
