#!/usr/bin/env python3
"""Drive sleap_tpu_torch's top-down inference once on one CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:

1. The card: CUDA must be available; print its name and power limit.
2. Build the CUDA kernels from ``sleap_tpu_torch/csrc``; print the build time.
3. Hold each kernel against its plain PyTorch version on the card, at the
   top-down main path's shapes (planted-Gaussian maps plus noise; crop boxes
   hanging off every edge; local peaks with and without refinement).
4. Run the main path: ``bench.py``'s top-down configuration at full width
   (1024^2 uint8 frames, UNets with filters 64 and an s2d-4 stem, centroid
   input scaling 0.25, 13 nodes, crop 160, batch 16, 4 instances), seeded
   random weights, float32 with TF32 off, through
   ``TopDownPredictor.predict``. Every kernel's launch count must rise in
   that run, and a batch of 4 must match the same predictor on the CPU.
   Labels are not assembled (``make_labels=False``): the card's Python has
   no ``h5py``, which ``sleap_tpu``'s ``Labels`` and ``Video`` import.
5. Time each kernel and its plain version with CUDA events, and the path's
   frames per second.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import dataclasses
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# Tolerances of kernel vs plain version on the card (see ops/cuda_*.py):
# values, masks and integer locations are exact; refined xy differ by the
# order of the window sums; crops are bitwise (no FMA in the blend).
XY_TOL = 1e-4
VAL_TOL = 1e-6
CROP_TOL = 0.0
# GPU vs CPU on the whole path: f32 convs sum in another order on each side
# (cuDNN vs oneDNN, ~1e-5 in the maps); refined points scale that by up to
# stride / input scale = 16 px per map px, and a shifted crop origin can move
# a truncated uint8 pixel by 1.
PATH_XY_TOL = 0.05
PATH_VAL_TOL = 1e-3

IMG, CROP, N_NODES, BATCH, MAX_INSTANCES = 1024, 160, 13, 16, 4


def log(msg):
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| over entries; NaN must sit in the same places."""
    a, b = a.float().cpu(), b.float().cpu()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise RuntimeError("chip_smoke check failed: NaN patterns differ")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~fin], b[~fin]):
        raise RuntimeError("chip_smoke check failed: non-finite entries differ")
    return float((a[fin] - b[fin]).abs().max()) if fin.any() else 0.0


def time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def planted_maps(n, h, w, c, n_peaks, gen, device) -> torch.Tensor:
    """(n, h, w, c) NHWC view of NCHW maps: Gaussians (sigma 1.5) + noise,
    laid out as a conv head's output."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    cy = torch.rand(n, c, n_peaks, generator=gen, device=device) * (h - 1)
    cx = torch.rand(n, c, n_peaks, generator=gen, device=device) * (w - 1)
    amp = 0.3 + 0.7 * torch.rand(n, c, n_peaks, generator=gen, device=device)
    d2 = (yy - cy[..., None, None]) ** 2 + (xx - cx[..., None, None]) ** 2
    maps = (amp[..., None, None] * torch.exp(-d2 / (2 * 1.5**2))).sum(2)
    maps += 0.05 * torch.rand(maps.shape, generator=gen, device=device)
    return maps.permute(0, 2, 3, 1)  # (n, h, w, c), strides of NCHW


def synthetic_frames(n, seed) -> np.ndarray:
    """(n, 1024, 1024, 1) uint8: noise plus 4 bright Gaussian blobs each."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 40, (n, IMG, IMG, 1), dtype=np.uint8)
    r = 24
    g = np.mgrid[-r:r + 1, -r:r + 1]
    blob = np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * 8.0**2))
    for i in range(n):
        for _ in range(MAX_INSTANCES):
            y, x = rng.integers(r, IMG - r, 2)
            patch = frames[i, y - r:y + r + 1, x - r:x + r + 1, 0].astype(np.float32)
            frames[i, y - r:y + r + 1, x - r:x + r + 1, 0] = np.clip(patch + 200 * blob, 0, 255)
    return frames


def check_kernels(device, gen):
    """Phase 3: kernel vs plain version at the main path's shapes."""
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    errs = {}
    # Global peaks: 64 crops x 13 nodes of 40 x 40 (instance maps, stride 4).
    # Integral refinement (half 2) and the grid peak (half -1, the rough
    # peaks under learned offsets).
    cms = planted_maps(BATCH * MAX_INSTANCES, CROP // 4, CROP // 4, N_NODES, 2, gen, device)
    e_global = 0.0
    for half in (2, -1):
        xy_k, v_k = cuda_peaks.global_peaks_cuda(cms, 0.2, half)
        xy_p, v_p = cuda_peaks.global_peaks_plain(cms, 0.2, half)
        e_xy, e_v = max_abs(xy_k, xy_p), max_abs(v_k, v_p)
        log(f"global_peaks {tuple(cms.shape)} refine={half >= 0}: "
            f"max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}")
        check(e_xy <= XY_TOL and e_v <= VAL_TOL, "global_peaks kernel vs plain")
        e_global = max(e_global, e_xy, e_v)
    errs["global_peaks"] = (e_global, (cms,))

    # Local peaks: 16 centroid maps of 64 x 64 (1024 * 0.25 / 4), K = 4.
    cmap = planted_maps(BATCH, IMG // 16, IMG // 16, 1, 8, gen, device)
    e_local = 0.0
    for half in (2, -1):
        pk_k, v_k = cuda_peaks.local_peaks_cuda(cmap, MAX_INSTANCES, 0.2, half)
        pk_p, v_p = cuda_peaks.local_peaks_plain(cmap, MAX_INSTANCES, 0.2, half)
        e_xy, e_v = max_abs(pk_k, pk_p), max_abs(v_k, v_p)
        log(f"local_peaks {tuple(cmap.shape)} refine={half >= 0}: "
            f"max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}, peaks {int(torch.isfinite(v_k).sum())}")
        check(e_xy <= XY_TOL and e_v <= VAL_TOL, "local_peaks kernel vs plain")
        e_local = max(e_local, e_xy, e_v)
    errs["local_peaks"] = (e_local, (cmap,))

    # Crops: 64 boxes of 160 x 160 from 16 uint8 frames of 1024^2, with
    # boxes hanging off every edge and corner.
    images = torch.randint(0, 256, (BATCH, IMG, IMG, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    n = BATCH * MAX_INSTANCES
    top_left = torch.rand(n, 2, generator=gen, device=device) * (IMG + CROP) - CROP
    top_left[:8] = torch.tensor(
        [[-100.5, 300.25], [950.75, 10.5], [400.125, -90.5], [10.0, 940.0],
         [-50.3, -60.7], [900.9, 920.1], [-170.0, 500.0], [1030.5, 1030.5]],
        device=device,
    )
    box_inds = torch.arange(BATCH, device=device).repeat_interleave(MAX_INSTANCES)
    c_k = cuda_crops.crop_unit_cuda(images, top_left, box_inds, (CROP, CROP))
    c_p = cuda_crops.crop_unit_plain(images, top_left, box_inds, (CROP, CROP))
    e_c = max_abs(c_k, c_p)
    log(f"crop_unit {tuple(images.shape)} -> {tuple(c_k.shape)}: max |d| {e_c:.3g}")
    check(e_c <= CROP_TOL, "crop_unit kernel vs plain")
    # The float32 instantiation (frames resized before cropping), 3 channels.
    rgb = torch.rand((2, 300, 200, 3), generator=gen, device=device) * 255
    small_tl, small_inds = top_left[:8] * 0.25, box_inds[:8] % 2
    e_f = max_abs(cuda_crops.crop_unit_cuda(rgb, small_tl, small_inds, (40, 24)),
                  cuda_crops.crop_unit_plain(rgb, small_tl, small_inds, (40, 24)))
    log(f"crop_unit float32 {tuple(rgb.shape)} -> (8, 40, 24, 3): max |d| {e_f:.3g}")
    check(e_f <= CROP_TOL, "crop_unit float32 kernel vs plain")
    errs["crop_unit"] = (max(e_c, e_f), (images, top_left, box_inds))
    return errs


def bench_topdown(device, gen):
    """``bench.py``'s top-down predictor, full width, seeded weights."""
    from sleap_tpu_torch.inference.predictors import TopDownPredictor, TrainedModel
    from sleap_tpu_torch.models.model import HeadSpec, PoseNet, init_params
    from sleap_tpu_torch.models.unet import UNet

    unet = UNet.from_config(SimpleNamespace(
        max_stride=16, output_stride=4, filters=64, filters_rate=2.0, up_interpolate=True,
        space_to_depth=4, stem_stride=None, middle_block=True, stacks=1,
    ))
    centroid = PoseNet(unet, [HeadSpec("CentroidConfmapsHead", 1, "linear", 4)], 1)
    instance = PoseNet(unet, [HeadSpec("CenteredInstanceConfmapsHead", N_NODES, "linear", 4)], 1)
    for net in (centroid, instance):
        init_params(net, gen).eval()
        # Non-negative head kernels over ReLU features give maps with peaks
        # above the 0.2 threshold, so every stage does real work (random
        # signs give maps below it everywhere and an empty result).
        with torch.no_grad():
            for head in net.heads.values():
                head.weight.abs_()

    def predictor(dev, batch):
        ctm = TrainedModel(module=copy.deepcopy(centroid).to(dev), input_scale=0.25,
                           output_stride=4, pad_to_stride=16, part_names=[])
        itm = TrainedModel(module=copy.deepcopy(instance).to(dev), input_scale=1.0,
                           output_stride=4, pad_to_stride=16, crop_size=CROP,
                           part_names=[f"n{i}" for i in range(N_NODES)])
        return TopDownPredictor(device=torch.device(dev), centroid_model=ctm,
                                confmap_model=itm, max_instances=MAX_INSTANCES,
                                batch_size=batch)

    return predictor(device, BATCH), predictor("cpu", 4)


def merged(examples, n):
    """Concatenate per-batch outputs, trimmed to the n valid frames."""
    keys = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")
    return {k: np.concatenate([ex[k][:ex["n_valid"]] for ex in examples])[:n] for k in keys}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU.")
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # Phase 2: build.
    from sleap_tpu_torch.ops import _build, cuda_crops, cuda_peaks

    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")

    # Phase 3: each kernel vs its plain version.
    gen = torch.Generator(device=device).manual_seed(0)
    errs = check_kernels(device, gen)

    # Phase 4: the main path.
    gpu_pred, cpu_pred = bench_topdown(device, torch.Generator().manual_seed(0))
    frames = synthetic_frames(9 * BATCH, seed=0)
    gpu_pred.predict(frames[:BATCH], make_labels=False)  # warm-up: cuDNN plans, library
    torch.cuda.synchronize()
    wrappers = {
        "local_peaks": cuda_peaks.local_peaks_cuda,
        "crop_unit": cuda_crops.crop_unit_cuda,
        "global_peaks": cuda_peaks.global_peaks_cuda,
    }
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = gpu_pred.predict(frames[BATCH:], make_labels=False)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    n_frames = len(frames) - BATCH
    fps = n_frames / path_s
    log(f"main path: {n_frames} frames in {path_s:.3f} s = {fps:.1f} FPS; launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    res = merged(out, n_frames)
    check(res["instance_peaks"].shape == (n_frames, MAX_INSTANCES, N_NODES, 2), "peaks shape")
    check(res["centroids"].shape == (n_frames, MAX_INSTANCES, 2), "centroids shape")
    check(np.isfinite(res["centroids"][res["centroid_mask"]]).all(), "finite centroids")
    check(np.isfinite(res["instance_peak_vals"]).all(), "finite peak values")
    log(f"centroids found: {int(res['centroid_mask'].sum())} of {res['centroid_mask'].size}; "
        f"instance points: {int(np.isfinite(res['instance_peaks'][..., 0]).sum())}")

    # GPU vs CPU on one batch of 4.
    small = frames[:4]
    g = merged(dataclasses.replace(gpu_pred, batch_size=4).predict(small, make_labels=False), 4)
    c = merged(cpu_pred.predict(small, make_labels=False), 4)
    check(np.array_equal(g["centroid_mask"], c["centroid_mask"]), "GPU vs CPU centroid masks")
    d = {k: max_abs(torch.from_numpy(g[k]), torch.from_numpy(c[k]))
         for k in ("centroids", "instance_peaks", "centroid_vals", "instance_peak_vals")}
    log(f"GPU vs CPU (batch 4): {d}; centroids {int(g['centroid_mask'].sum())}")
    check(d["centroids"] <= PATH_XY_TOL and d["instance_peaks"] <= PATH_XY_TOL, "GPU vs CPU points")
    check(d["centroid_vals"] <= PATH_VAL_TOL and d["instance_peak_vals"] <= PATH_VAL_TOL,
          "GPU vs CPU values")

    # Phase 5: kernel and plain version times at the main-path shapes.
    calls = {
        "global_peaks": (lambda m: cuda_peaks.global_peaks_cuda(m, 0.2, 2),
                         lambda m: cuda_peaks.global_peaks_plain(m, 0.2, 2)),
        "local_peaks": (lambda m: cuda_peaks.local_peaks_cuda(m, MAX_INSTANCES, 0.2, 2),
                        lambda m: cuda_peaks.local_peaks_plain(m, MAX_INSTANCES, 0.2, 2)),
        "crop_unit": (lambda *a: cuda_crops.crop_unit_cuda(*a, (CROP, CROP)),
                      lambda *a: cuda_crops.crop_unit_plain(*a, (CROP, CROP))),
    }
    replaces = {
        "local_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:101"),
        "crop_unit": ("sleap_tpu_torch/csrc/crops.cu", "sleap_tpu/ops/pallas_crops.py:56"),
        "global_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:68"),
    }
    kernels = []
    for name in wrappers:
        err, args = errs[name]
        kernel_fn, plain_fn = calls[name]
        # In turns (kernel, plain, plain, kernel), each side averaged.
        k1, p1 = time_ms(lambda: kernel_fn(*args)), time_ms(lambda: plain_fn(*args))
        p2, k2 = time_ms(lambda: plain_fn(*args)), time_ms(lambda: kernel_fn(*args))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        source, tpu = replaces[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "sleap_tpu")]
    check(not leaked, f"JAX-side modules imported: {leaked[:5]}")

    log(f"top-down path: {fps:.1f} FPS ({card})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
