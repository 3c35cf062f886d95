#!/usr/bin/env python3
"""Drive sleap_tpu_torch's top-down and bottom-up inference once on one
CUDA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:

1. The card: CUDA must be available; print its name and power limit.
2. Build the CUDA kernels from ``sleap_tpu_torch/csrc``; print the build time.
3. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (planted-Gaussian maps plus noise; crop boxes hanging
   off every edge; local peaks with and without refinement; kernel 4 on
   bf16 maps of 16 x 256^2 x 13, channels-last and as an NCHW view, with
   more equal peaks than K in one map).
4. Run the top-down path: ``bench.py``'s top-down configuration at full
   width (1024^2 uint8 frames, UNets with filters 64 and an s2d-4 stem,
   centroid input scaling 0.25, 13 nodes, crop 160, batch 16, 4
   instances), seeded random weights, float32 with TF32 off, through
   ``TopDownPredictor.predict``. The launch counts of kernels 1-3 must rise
   in that run, and a batch of 4 must match the same predictor on the CPU.
   Labels are not assembled (``make_labels=False``): the card's Python has
   no ``h5py``, which ``sleap_tpu``'s ``Labels`` and ``Video`` import.
4b. Run the bottom-up path: ``bench.py``'s bottom-up configuration at full
   width (the same UNet, 13 nodes in a chain, confmaps at stride 4, PAFs at
   stride 8, K = 8 peaks per node, 3 instances kept, batch 16), bf16,
   through ``BottomUpPredictor.predict``. Kernel 4's launch count must rise
   and a frame must hold an assembled instance of 2 or more nodes; the
   card's bf16 head outputs, grouped on the CPU, must give the card's
   instances; the float32 model must match the CPU on a batch of 4.
5. Time each kernel and its plain version with CUDA events, and each
   path's frames per second.

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

# Bottom-up, the card's bf16 maps grouped on the card and on the CPU: the
# same instances, refined points within the kernel's tolerance.
BU_XY_TOL = 1e-4

IMG, CROP, N_NODES, BATCH, MAX_INSTANCES = 1024, 160, 13, 16, 4
TIMED_BATCHES = 8
# Bottom-up (``bench.py:128-157``): confmaps at stride 4, PAFs at stride 8,
# K = 8 peaks per node, 3 instances kept, bf16.
BU_CM_STRIDE, BU_PAF_STRIDE, BU_K, BU_MAX_INSTANCES = 4, 8, 8, 3
HWCS_HALF = 2


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
    inf = torch.isinf(a) | torch.isinf(b)
    if not torch.equal(a[inf], b[inf]):
        raise RuntimeError("chip_smoke check failed: infinite entries differ")
    fin = torch.isfinite(a) & torch.isfinite(b)
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


def check_hwcs(device, gen):
    """Phase 3, kernel 4: bf16 local peaks at the bottom-up main path's
    shape (16 samples x 256^2 x 13 channels, K = 8), as the head conv's
    channels-last output and as an NCHW permute view; one map holds more
    equal isolated peaks than K."""
    from sleap_tpu_torch.ops import cuda_peaks

    h = IMG // BU_CM_STRIDE
    maps = planted_maps(BATCH, h, h, N_NODES, 12, gen, device)  # NHWC view of NCHW
    rows = 2 + (h // 10) * torch.arange(10, device=device)
    cols = 1 + (h // 12) * torch.arange(10, device=device)
    tied = torch.zeros(h, h, device=device)
    tied[rows, cols] = 0.5
    maps[0, :, :, 0] = tied  # ten equal isolated peaks: the first eight by index win
    nchw_view = maps.to(torch.bfloat16)
    channels_last = nchw_view.contiguous()
    err = 0.0
    for name, cms in (("channels-last", channels_last), ("NCHW view", nchw_view)):
        for half in (HWCS_HALF, -1):
            pk_k, v_k = cuda_peaks.local_peaks_hwcs_cuda(cms, BU_K, 0.2, half)
            pk_p, v_p = cuda_peaks.local_peaks_hwcs_plain(cms, BU_K, 0.2, half)
            e_xy, e_v = max_abs(pk_k, pk_p), max_abs(v_k, v_p)
            log(f"local_peaks_hwcs {name} {tuple(cms.shape)} refine={half >= 0}: "
                f"max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}, "
                f"peaks {int(torch.isfinite(v_k).sum())}")
            check(e_v == 0.0, "local_peaks_hwcs values vs plain")
            check(e_xy <= (XY_TOL if half >= 0 else 0.0), "local_peaks_hwcs xy vs plain")
            err = max(err, e_xy, e_v)
    want = torch.stack([cols, rows], dim=1)[:BU_K].tolist()
    got = cuda_peaks.local_peaks_hwcs_cuda(channels_last, BU_K, 0.2, -1)[0][0, 0]
    check(got.cpu().tolist() == want, "local_peaks_hwcs tie order")
    return err, (channels_last,)


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


def bench_bottomup(device, gen):
    """``bench.py``'s bottom-up predictor, full width, seeded weights: bf16
    on the card, and float32 on the card and on the CPU."""
    from sleap_tpu_torch.inference.bottomup import BottomUpPredictor
    from sleap_tpu_torch.inference.predictors import TrainedModel
    from sleap_tpu_torch.models.model import HeadSpec, PoseNet, init_params
    from sleap_tpu_torch.models.unet import UNet

    unet = UNet.from_config(SimpleNamespace(
        max_stride=16, output_stride=4, filters=64, filters_rate=2.0, up_interpolate=True,
        space_to_depth=4, stem_stride=None, middle_block=True, stacks=1,
    ))
    names = [f"n{i}" for i in range(N_NODES)]
    edges = list(zip(names[:-1], names[1:]))
    heads = [HeadSpec("MultiInstanceConfmapsHead", N_NODES, "linear", BU_CM_STRIDE),
             HeadSpec("PartAffinityFieldsHead", 2 * len(edges), "linear", BU_PAF_STRIDE)]
    net = init_params(PoseNet(unet, heads, 1), gen).eval()
    with torch.no_grad():  # maps above threshold, lines above min_line_scores
        for head in net.heads.values():
            head.weight.abs_()

    def predictor(dev, dtype, batch):
        module = PoseNet(unet, heads, 1, dtype)
        module.load_state_dict(net.state_dict())
        tm = TrainedModel(module=module.to(dev).eval(), input_scale=1.0,
                          output_stride=BU_CM_STRIDE, pad_to_stride=16, part_names=names,
                          paf_stride=BU_PAF_STRIDE, edges=edges)
        return BottomUpPredictor(device=torch.device(dev), bottomup_model=tm,
                                 max_peaks_per_node=BU_K, max_instances=BU_MAX_INSTANCES,
                                 batch_size=batch)

    return (predictor(device, torch.bfloat16, BATCH), predictor(device, torch.float32, 4),
            predictor("cpu", torch.float32, 4))


def merged(examples, n):
    """Concatenate per-batch outputs, trimmed to the n valid frames."""
    keys = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")
    return {k: np.concatenate([ex[k][:ex["n_valid"]] for ex in examples])[:n] for k in keys}


def frames_instances(examples):
    """Bottom-up: per-frame (points, values, scores) of the valid frames."""
    keys = ("instance_peaks", "instance_peak_vals", "instance_scores")
    return [tuple(ex[k][i] for k in keys) for ex in examples for i in range(ex["n_valid"])]


def run_path(name, pred, frames, wrappers):
    """Warm up on one batch, zero the launch counts, predict the rest of
    the frames; return (outputs, launches, FPS)."""
    pred.predict(frames[:BATCH], make_labels=False)  # warm-up: cuDNN plans, library
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = pred.predict(frames[BATCH:], make_labels=False)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_frames = len(frames) - BATCH
    fps = n_frames / path_s
    log(f"{name} path: {n_frames} frames in {path_s:.3f} s = {fps:.1f} FPS; launches {launches}")
    for k, count in launches.items():
        check(count > 0, f"{k} was not launched on the {name} path")
    return out, launches, fps


def check_topdown(gpu_pred, cpu_pred, frames, out):
    n_frames = len(frames) - BATCH
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


def check_bottomup(preds, frames, out):
    """The bottom-up path's outputs: shapes, assembled instances, the card's
    bf16 maps grouped on the CPU, and float32 GPU vs CPU on 4 frames."""
    from sleap_tpu_torch.inference.predictors import _preprocess

    bf16_pred, f32_gpu, f32_cpu = preds
    per_frame = frames_instances(out)
    check(len(per_frame) == len(frames) - BATCH, "one result per frame")
    n_inst = [len(p) for p, _, _ in per_frame]
    sizes = [int(np.isfinite(p[:, :, 0]).sum(1).max()) for p, _, _ in per_frame if len(p)]
    check(max(n_inst) <= BU_MAX_INSTANCES, "at most max_instances per frame")
    check(sizes and max(sizes) >= 2, "an assembled instance with 2 or more nodes")
    for p, v, sc in per_frame:
        check(p.shape[1:] == (N_NODES, 2) and v.shape[1:] == (N_NODES,), "instance shapes")
        check(np.array_equal(np.isnan(p[..., 0]), np.isnan(v)) and np.isfinite(sc).all(),
              "instance values where its points are")
    log(f"bottom-up instances: {sum(n_inst)} over {len(per_frame)} frames, "
        f"largest {max(sizes)} of {N_NODES} nodes")

    # The card's bf16 head outputs grouped on the card and on the CPU.
    tm = bf16_pred.bottomup_model
    with torch.inference_mode():
        imgs = torch.from_numpy(frames[:4]).to(bf16_pred.device)
        heads = tm.module(_preprocess(imgs, tm.grayscale, 1.0, tm.pad_to_stride))
        g = {k: v.cpu() for k, v in bf16_pred.group_heads(heads).items()}
        c = bf16_pred.group_heads({k: v.cpu() for k, v in heads.items()})
    check(torch.equal(g["instance_valid"], c["instance_valid"]), "bf16 maps: GPU vs CPU instances")
    d_xy = max_abs(g["instances"], c["instances"])
    d_val = max_abs(g["instance_peak_vals"], c["instance_peak_vals"])
    d_sc = max_abs(g["instance_scores"], c["instance_scores"])
    log(f"bf16 maps grouped, GPU vs CPU: {int(g['instance_valid'].sum())} instances, "
        f"max |dxy| {d_xy:.3g}, max |dval| {d_val:.3g}, max |dscore| {d_sc:.3g}")
    check(d_xy <= BU_XY_TOL and d_val == 0.0 and d_sc <= PATH_VAL_TOL,
          "bf16 maps: GPU vs CPU grouping")

    # Float32, GPU vs CPU on one batch of 4.
    g, c = (frames_instances(p.predict(frames[:4], make_labels=False)) for p in (f32_gpu, f32_cpu))
    check([len(x[0]) for x in g] == [len(x[0]) for x in c], "f32 GPU vs CPU instance counts")
    d_xy = d_val = 0.0
    for (gp, gv, gs), (cp, cv, cs) in zip(g, c):
        if len(gp):
            d_xy = max(d_xy, max_abs(torch.from_numpy(gp), torch.from_numpy(cp)))
            d_val = max(d_val, max_abs(torch.from_numpy(gv), torch.from_numpy(cv)),
                        max_abs(torch.from_numpy(gs), torch.from_numpy(cs)))
    log(f"f32 GPU vs CPU (batch 4): {sum(len(x[0]) for x in g)} instances, "
        f"max |dxy| {d_xy:.3g}, max |dval| {d_val:.3g}")
    check(d_xy <= PATH_XY_TOL and d_val <= PATH_VAL_TOL, "f32 GPU vs CPU instances")


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
    errs["local_peaks_hwcs"] = check_hwcs(device, gen)

    frames = synthetic_frames((1 + TIMED_BATCHES) * BATCH, seed=0)
    launches, fps = {}, {}

    # Phase 4: the top-down path.
    gpu_pred, cpu_pred = bench_topdown(device, torch.Generator().manual_seed(0))
    td_wrappers = {
        "local_peaks": cuda_peaks.local_peaks_cuda,
        "crop_unit": cuda_crops.crop_unit_cuda,
        "global_peaks": cuda_peaks.global_peaks_cuda,
    }
    out, counts, fps["top-down"] = run_path("top-down", gpu_pred, frames, td_wrappers)
    launches.update(counts)
    check_topdown(gpu_pred, cpu_pred, frames, out)

    # Phase 4b: the bottom-up path.
    bu_preds = bench_bottomup(device, torch.Generator().manual_seed(0))
    out, counts, fps["bottom-up"] = run_path(
        "bottom-up", bu_preds[0], frames, {"local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda}
    )
    launches.update(counts)
    check_bottomup(bu_preds, frames, out)

    # Phase 5: kernel and plain version times at the main-path shapes.
    calls = {
        "global_peaks": (lambda m: cuda_peaks.global_peaks_cuda(m, 0.2, 2),
                         lambda m: cuda_peaks.global_peaks_plain(m, 0.2, 2)),
        "local_peaks": (lambda m: cuda_peaks.local_peaks_cuda(m, MAX_INSTANCES, 0.2, 2),
                        lambda m: cuda_peaks.local_peaks_plain(m, MAX_INSTANCES, 0.2, 2)),
        "crop_unit": (lambda *a: cuda_crops.crop_unit_cuda(*a, (CROP, CROP)),
                      lambda *a: cuda_crops.crop_unit_plain(*a, (CROP, CROP))),
        "local_peaks_hwcs": (
            lambda m: cuda_peaks.local_peaks_hwcs_cuda(m, BU_K, 0.2, HWCS_HALF),
            lambda m: cuda_peaks.local_peaks_hwcs_plain(m, BU_K, 0.2, HWCS_HALF)),
    }
    replaces = {
        "local_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:101"),
        "crop_unit": ("sleap_tpu_torch/csrc/crops.cu", "sleap_tpu/ops/pallas_crops.py:56"),
        "global_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:68"),
        "local_peaks_hwcs": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:487"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        err, args = errs[name]
        kernel_fn, plain_fn = calls[name]
        # In turns (kernel, plain, plain, kernel), each side averaged.
        k1, p1 = time_ms(lambda: kernel_fn(*args)), time_ms(lambda: plain_fn(*args))
        p2, k2 = time_ms(lambda: plain_fn(*args)), time_ms(lambda: kernel_fn(*args))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "sleap_tpu", "networkx")]
    check(not leaked, f"JAX-side modules imported: {leaked[:5]}")

    log(f"top-down path: {fps['top-down']:.1f} FPS ({card})")
    log(f"bottom-up path: {fps['bottom-up']:.1f} FPS ({card})")
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
