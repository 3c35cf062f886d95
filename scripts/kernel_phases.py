#!/usr/bin/env python3
"""Cut kernels 1 (global peaks), 2 (float32 local peaks) and 3 (crops)
after each phase and time what is left, to show what bounds them on the
card; and time variants of kernel 1 that swap one of its steps.

    python3 scripts/kernel_phases.py [--out DIR] [--kernels global local crop]

A one-off measurement tied to the sources of the commit that added it: each
cut is inserted before a literal line of ``csrc/peaks.cu`` or
``csrc/crops.cu``, and the script stops with an error once an edit removes
or repeats that line. Writes one patched copy of ``sleap_tpu_torch`` per
cut under DIR (default ``tree_check/phases``, which ``.gitignore`` lists):
the kernel returns after the phase, behind a store the compiler cannot drop,
so what remains is the launch plus the phases before the cut. A variant
inserts code that replaces a step (its outputs stay right). Each copy is
built and timed in its own process with ``torch.profiler`` (device time over
50 calls) at the paths' shapes, from fixed seeds: kernel 1 on 64 crops x 13
nodes of 40^2 (float32 as the NHWC view of NCHW, and bf16 channels-last)
and on single-instance's 4 x 48^2 x 13 bf16, with half 2, kernel 2 on 16
maps of 64^2 with K = 4 (half 2 and -1), kernel 3 on 64 boxes of 160^2
from uint8 and float32 frames, and one PyTorch kernel on 64 floats (the
launch floor). ``--kernels`` keeps the cuts and rows of the kernels named
(default: all). The outputs of a cut copy are wrong by design; only its
time is read. Prints one JSON line: cut -> {row: device ms}.
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

# cut -> (source, anchor line, code inserted before it); the name's first
# word is the kernel's.
CUTS = {
    "global: launch": (
        "peaks.cu", "  __shared__ __align__(8) uint64_t bar;\n",
        "  if (cms == nullptr) xy[0] = 0.f;\n  return;\n"),
    "global: + slab copied": (
        "peaks.cu", "  uint32_t* key_hi = reinterpret_cast<uint32_t*>(smem + slab_bytes);\n",
        "  if (bulk && lane == 0) mbar_wait(smem_addr(&bar));\n  __syncwarp();\n"
        "  if (n > 0 && to_f32(data[threadIdx.x % n]) == 12345.f) xy[0] = 0.f;\n  return;\n"),
    "global: + scan": (
        "peaks.cu", "    uint32_t hi, idx;\n    am.key((uint32_t)HW, hi, idx);\n",
        "    if (am.v == 12345.f) xy[0] = 0.f;\n    return;\n"),
    "global: + warp merge": (
        "peaks.cu", "    if (P == 1) {\n      if (idx == kNoIdx) idx = 0;",
        "    if (hi == 12345u) xy[0] = 0.f;\n    return;\n"),
    "global: + key exchange": (
        "peaks.cu", "  // The block whose rows hold map g's peak (row H - 1 for a NaN map's H*W)\n",
        "  if (key_hi[threadIdx.x % (P * G)] == 12345u) xy[0] = 0.f;\n  return;\n"),
    "global variant: one block a map or sample": (
        "peaks.cu", "  for (;;) {\n    plan.rows_per = (H + plan.P - 1) / plan.P;\n",
        "  plan.P = 1;\n"),
    "global variant: two blocks a map or sample": (
        "peaks.cu", "  for (;;) {\n    plan.rows_per = (H + plan.P - 1) / plan.P;\n",
        "  plan.P = 2;\n"),
    "local: staging + NMS": (
        "peaks.cu", "  // The part's top K: each warp merges its 32 thread lists, then warp 0\n",
        "  if (lk[0] == 12345ull) peaks[0] = 0.f;\n  return;\n"),
    "local: + warp merges": (
        "peaks.cu", '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
        "  if (warp == 0) {\n    Key64* out",
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
    g1 = torch.Generator(device=device).manual_seed(1)  # kernels 2 and 3 keep gen's inputs
    global_maps = cs.planted_maps(cs.BATCH * cs.MAX_INSTANCES, cs.CROP // 4, cs.CROP // 4,
                                  cs.N_NODES, 2, g1, device)
    global_bf16 = global_maps.to(torch.bfloat16).contiguous()
    single_bf16 = cs.planted_maps(cs.SI_BATCH, cs.SI_IMG // 4, cs.SI_IMG // 4, cs.N_NODES, 1, g1,
                                  device).to(torch.bfloat16).contiguous()
    local_maps = cs.planted_maps(cs.BATCH, cs.IMG // 16, cs.IMG // 16, 1, 8, gen, device)
    n = cs.BATCH * cs.MAX_INSTANCES
    images = torch.randint(0, 256, (cs.BATCH, cs.IMG, cs.IMG, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    top_left = cs.crop_boxes(n, cs.IMG, cs.CROP, gen, device)
    box_inds = torch.arange(cs.BATCH, device=device).repeat_interleave(cs.MAX_INSTANCES)
    f32 = images.float()
    tiny = torch.zeros(64, device="cuda")
    crop = (cs.CROP, cs.CROP)
    gp = ("global_slab_kernel", "global_band_kernel")
    rows = {
        "global float32": (lambda: cuda_peaks.global_peaks_cuda(global_maps, 0.2, 2), gp),
        "global bf16": (lambda: cuda_peaks.global_peaks_cuda(global_bf16, 0.2, 2), gp),
        "global single-instance bf16": (
            lambda: cuda_peaks.global_peaks_cuda(single_bf16, 0.2, 2), gp),
        "local half 2": (lambda: cuda_peaks.local_peaks_cuda(local_maps, 4, 0.2, 2),
                         ("local_peaks_kernel",)),
        "local half -1": (lambda: cuda_peaks.local_peaks_cuda(local_maps, 4, 0.2, -1),
                          ("local_peaks_kernel",)),
        "crop uint8": (lambda: cuda_crops.crop_unit_cuda(images, top_left, box_inds, crop),
                       ("crop_unit_kernel",)),
        "crop float32": (lambda: cuda_crops.crop_unit_cuda(f32, top_left, box_inds, crop),
                         ("crop_unit_kernel",)),
        "launch floor": (lambda: tiny.add_(1.0), None),
    }
    kernels = os.environ["KERNEL_PHASES_KERNELS"].split(",")
    return {k: cs.device_ms(fn, f, iters=50) for k, (fn, f) in rows.items()
            if k == "launch floor" or k.split()[0] in kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "tree_check" / "phases"))
    ap.add_argument("--kernels", nargs="+", default=["global", "local", "crop"],
                    choices=["global", "local", "crop"])
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
    cuts = {k: v for k, v in CUTS.items() if k.split()[0].rstrip(":") in args.kernels}
    for name, cut in {"full": None, **cuts}.items():
        copy = make_copy(out, name, cut)
        env = dict(os.environ, PYTHONPATH=str(copy), KERNEL_PHASES_KERNELS=",".join(args.kernels))
        done = subprocess.run([sys.executable, __file__, "--child"], env=env, check=True,
                              stdout=subprocess.PIPE, text=True)
        res[name] = json.loads(done.stdout.strip().splitlines()[-1])
        print(name, {k: round(v, 4) for k, v in res[name].items()}, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
