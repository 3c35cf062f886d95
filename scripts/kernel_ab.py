#!/usr/bin/env python3
"""Check and time sleap_tpu_torch's four CUDA kernels at the main paths'
shapes, to compare two checkouts on one card.

    PYTHONPATH=<checkout> python3 scripts/kernel_ab.py --label NAME [--sass] [--host-split]

The kernels come from whichever ``sleap_tpu_torch`` the import path resolves
to, so one card compares two checkouts by running this script once per
checkout, in turns (A, B, B, A). The checks and the times are this
checkout's ``chip_smoke.py`` phases 3 and 5 (``check_kernels``,
``check_hwcs``, ``kernel_rows``) on the same seeded inputs in every run;
kernel 4 runs on planted bf16 maps of the bottom-up path's shape instead of
the model's head maps, so no model is built. ``launch_floor`` is the device
time of one PyTorch kernel on 64 floats, the least any launch takes.

Prints one JSON line: the rows of ``chip_smoke.py``'s kernels line
(``launches`` 0: no path runs here) and the launch floor. ``--sass``
adds, per kernel function of the built library, its registers and spills
(``nvcc -Xptxas -v``) and its SASS instruction counts (``cuobjdump -sass``):
instructions, global and shared loads and stores, and call targets (nvcc
emits 64-bit division as a call). ``--host-split`` adds the host time of
the crop wrapper: whole, with its C entry point or its launch helper
replaced by a no-op, and the allocation and lookups it makes; of the
global peaks wrapper with its outputs' two ways of allocating; and of the
device dispatch in front of the two wrappers (``crop_unit`` and
``global_peaks``, custom ops since the kernels were registered with
``torch.library``), which the paths call.
"""

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_stats():
    """Registers and spills from ptxas, SASS instruction counts per kernel."""
    from sleap_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    ptxas = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in _build.SOURCES:
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", f"{tmp}/{name}.o",
                 str(_build.CSRC / name)], capture_output=True, text=True, check=True)
            func = None
            for line in done.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    func = m.group(1)
                elif func and ("registers" in line or "spill" in line):
                    ptxas.setdefault(func, []).append(line.split(":", 1)[-1].strip())
    lib = _build.build_library()
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    stats = {}
    func = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            stats[func] = Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if func and m:
            op = m.group(1)
            c = stats[func]
            c["instructions"] += 1
            for kind in ("LDG", "STG", "LDS", "STS", "ATOMS", "RED", "BAR", "SHFL", "REDUX"):
                if op.split(".")[0] == kind:
                    c[kind] += 1
            if op.startswith("CALL"):
                c["call " + m.group(2).strip()] += 1
    keep = ("crop_unit_kernel", "local_peaks_kernel", "global_slab_kernel", "global_band_kernel",
            "hwcs_band_kernel")
    return {
        f: {"ptxas": ptxas.get(f, []), **dict(c)}
        for f, c in stats.items() if any(k in f for k in keep)
    }


def patched(module, attr, value, fn):
    """``fn`` with ``module.attr`` replaced by ``value`` for the call."""
    def call():
        old = getattr(module, attr)
        setattr(module, attr, value)
        try:
            fn()
        finally:
            setattr(module, attr, old)
    return call


def host_split(cs, crop_args, global_maps):
    """Host microseconds per call of the crop wrapper on the path's boxes:
    whole, with the C entry point a no-op (the launch helper's own work
    stays), with the launch helper a no-op (the wrapper's checks, arguments
    and allocation stay), and the calls it makes; and of the global peaks
    wrapper on the float32 path maps, beside its outputs allocated as two
    tensors or as one with two ``as_strided`` views; and the device
    dispatch of both. Each part runs 500
    calls without synchronising, in turns with the others, for 7 rounds;
    the median round counts (the host's clock swings by microseconds
    between rounds)."""
    from sleap_tpu_torch.ops import _build, cuda_crops, cuda_peaks

    images, top_left, box_inds = crop_args
    S, _, _, C = global_maps.shape

    def one_allocation():
        out = global_maps.new_empty(3 * S * C)
        return out.as_strided((S, C, 2), (2 * C, 2, 1)), out.as_strided((S, C), (C, 1), 2 * S * C)

    crop = (cs.CROP, cs.CROP)
    shape = (top_left.shape[0], cs.CROP, cs.CROP, images.shape[-1])
    wrapper = lambda: cuda_crops.crop_unit_cuda(images, top_left, box_inds, crop)
    parts = {
        "wrapper": wrapper,
        "wrapper, C entry a no-op": patched(_build, "entry", lambda name: lambda *a: 0, wrapper),
        "wrapper, launch a no-op": patched(cuda_crops, "launch", lambda *a: None, wrapper),
        "new_empty": lambda: images.new_empty(shape, dtype=torch.float32),
        "current stream": lambda: torch._C._cuda_getCurrentRawStream(images.device.index),
        "current device": torch.cuda.current_device,
        "F.grid_sample": cs.grid_sample_crops(images.float(), top_left, box_inds, cs.CROP),
        "global wrapper": lambda: cuda_peaks.global_peaks_cuda(global_maps, 0.2, 2),
        # The device dispatch the paths call: a Python test of the device in
        # checkouts before the custom ops, ``torch.ops.sleap_tpu_torch.*`` since.
        "crop dispatch": lambda: cuda_crops.crop_unit(images, top_left, box_inds, crop),
        "global dispatch": lambda: cuda_peaks.global_peaks(global_maps, 0.2, 2),
        "global outputs, two new_empty": lambda: (global_maps.new_empty((S, C, 2)),
                                                  global_maps.new_empty((S, C))),
        "global outputs, one new_empty and two views": one_allocation,
    }
    rounds = {name: [] for name in parts}
    for _ in range(7):
        for name, f in parts.items():
            for _ in range(20):
                f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                f()
            rounds[name].append((time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
    res = {name: statistics.median(us) for name, us in rounds.items()}
    for name, us in rounds.items():
        print(f"host {name}: {res[name]:.2f} us per call (median of 7 rounds, "
              f"{min(us):.2f}-{max(us):.2f})", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--host-split", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: CUDA is not available; this script needs one GPU.")
    import sleap_tpu_torch
    from sleap_tpu_torch.ops import _build

    cs = load_smoke()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    _build.load_library()
    gen = torch.Generator(device=device).manual_seed(0)
    errs = cs.check_kernels(device, gen)
    h = cs.IMG // cs.BU_CM_STRIDE
    hwcs_maps = cs.planted_maps(cs.BATCH, h, h, cs.N_NODES, 12, gen, device)
    errs["local_peaks_hwcs"] = cs.check_hwcs(
        device, gen, hwcs_maps.to(torch.bfloat16).contiguous())
    rows = cs.kernel_rows(errs, {name: {} for name in errs}, card)
    tiny = torch.zeros(64, device=device)
    floor = cs.device_ms(lambda: tiny.add_(1.0))
    print(f"launch_floor: {floor:.4f} ms device", flush=True)
    res = {"label": args.label, "package": str(Path(sleap_tpu_torch.__file__).parent),
           "card": card, "kernels": rows, "launch_floor_device_ms": floor}
    if args.sass:
        res["sass"] = sass_stats()
    if args.host_split:
        res["host_us"] = host_split(cs, errs["crop_unit"][1], errs["global_peaks"][1][0])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
