#!/usr/bin/env python3
"""Cut kernels 2 (float32 local peaks) and 3 (crops) after each phase and
time what is left, to show what bounds them on the card.

    python3 scripts/kernel_phases.py [--out DIR]

A one-off measurement tied to the sources of the commit that added it: each
cut is inserted before a literal line of ``csrc/peaks.cu`` or
``csrc/crops.cu``, and the script stops with an error once an edit removes
or repeats that line. Writes one patched copy of ``sleap_tpu_torch`` per
cut under DIR (default ``tree_check/phases``, which ``.gitignore`` lists):
the kernel returns after the phase, behind a store the compiler cannot drop,
so what remains is the launch plus the phases before the cut. Each copy is
built and timed in its own process with ``torch.profiler`` (device time over
50 calls) at the top-down path's shapes, from a fixed seed: kernel 2 on 16
maps of 64^2 with K = 4 (half 2 and -1), kernel 3 on 64 boxes of 160^2 from
uint8 and float32 frames, and one PyTorch kernel on 64 floats (the launch
floor). The outputs of a cut copy are wrong by design; only its time is
read. Prints one JSON line: cut -> {row: device ms}.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# cut -> (source, anchor line, code inserted before it)
CUTS = {
    "local: staging + NMS": (
        "peaks.cu", "  // The part's top K: each warp merges its 32 thread lists, then warp 0\n",
        "  if (lk[0] == 12345ull) peaks[0] = 0.f;\n  return;\n"),
    "local: + warp merges": (
        "peaks.cu", '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n',
        "  if (lists[threadIdx.x % kLpWarps][0] == 12345ull) peaks[0] = 0.f;\n  return;\n"),
    "local: + list push and cluster barrier": (
        "peaks.cu", "  // Merge the part lists (lane = part); the winners go to lists[0].\n",
        "  if (all_lists[threadIdx.x % kLpParts] == 12345ull) peaks[0] = 0.f;\n  return;\n"),
    "crop: staging": (
        "crops.cu", "  const float gx = __fsub_rn(1.f, fx);\n",
        "  if (win[threadIdx.x] == -1.f) out[0] = 0.f;\n  return;\n"),
    "crop: blend and stores, no staging": (
        "crops.cu", "  stage<T>(win, stride, frame, box_ok,", "  if (n_bands < 0)\n"),
}


def make_copy(out: Path, name: str, cut) -> Path:
    dst = out / re.sub(r"\W+", "_", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "sleap_tpu_torch", dst / "sleap_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    if cut is not None:
        source, anchor, insert = cut
        f = dst / "sleap_tpu_torch" / "csrc" / source
        text = f.read_text()
        if text.count(anchor) != 1:
            raise RuntimeError(f"cut {name!r}: anchor not found once in {source}")
        f.write_text(text.replace(anchor, insert + anchor))
    return dst


def time_rows() -> dict:
    """Runs in the child process, with the copy first on the import path."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import kernel_ab
    from sleap_tpu_torch.ops import _build, cuda_crops, cuda_peaks

    cs = kernel_ab.load_smoke()
    _build.load_library()
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    local_maps = cs.planted_maps(cs.BATCH, cs.IMG // 16, cs.IMG // 16, 1, 8, gen, device)
    n = cs.BATCH * cs.MAX_INSTANCES
    images = torch.randint(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    top_left = cs.crop_boxes(n, cs.IMG, cs.CROP, gen, device)
    box_inds = torch.arange(cs.BATCH, device=device).repeat_interleave(cs.MAX_INSTANCES)
    f32 = images.float()
    tiny = torch.zeros(64, device="cuda")
    crop = (cs.CROP, cs.CROP)
    rows = {
        "local half 2": (lambda: cuda_peaks.local_peaks_cuda(local_maps, 4, 0.2, 2),
                         "local_peaks_kernel"),
        "local half -1": (lambda: cuda_peaks.local_peaks_cuda(local_maps, 4, 0.2, -1),
                          "local_peaks_kernel"),
        "crop uint8": (lambda: cuda_crops.crop_unit_cuda(images, top_left, box_inds, crop),
                       "crop_unit_kernel"),
        "crop float32": (lambda: cuda_crops.crop_unit_cuda(f32, top_left, box_inds, crop),
                         "crop_unit_kernel"),
        "launch floor": (lambda: tiny.add_(1.0), None),
    }
    return {k: cs.device_ms(fn, None if f is None else (f,), iters=50)
            for k, (fn, f) in rows.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tree_check" / "phases"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(time_rows()), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: CUDA is not available; this script needs one GPU.")
    out = Path(args.out)
    res = {}
    for name, cut in {"full": None, **CUTS}.items():
        copy = make_copy(out, name, cut)
        env = dict(os.environ, PYTHONPATH=str(copy))
        done = subprocess.run([sys.executable, __file__, "--child"], env=env, check=True,
                              stdout=subprocess.PIPE, text=True)
        res[name] = json.loads(done.stdout.strip().splitlines()[-1])
        print(name, {k: round(v, 4) for k, v in res[name].items()}, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
