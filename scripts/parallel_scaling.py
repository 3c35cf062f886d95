#!/usr/bin/env python3
"""Data-parallel scaling over the cards of one machine: sharded top-down
inference FPS and data-parallel training images/s on 1, 2, ... cards.

    python3 scripts/parallel_scaling.py [--cards 1,2,4]

Inference: ``chip_smoke.py`` phase 4's float32 top-down pair (seeded
weights, full width, 1024^2 frames) at 16 frames a card, through
``make_sharded_predictor`` over the first n cards (n = 1: the predictor
itself): a warm-up global batch, then TIMED_BATCHES timed ones, three
times in turns; on the same 64 frames, the points held within 1e-3 px of the
one-card run.
Training: phase 7's centroid UNet at full width, 16 frames a card,
``Trainer.from_config(..., devices=<first n cards>).train()`` (n = 1: one
process; else a spawned rank a card over NCCL) for EPOCHS epochs of STEPS
steps and one validation step, no run folder; images/s from the epochs after
the first (its seconds hold the ranks' start). Prints the card line, then
one JSON line per measurement. Needs as many cards as the largest n.

    python3 scripts/parallel_scaling.py --spatial 1,2,4 [--cards 1,2,4] [--sizes 1024,2048]

Spatial sharding instead (only it runs): phase 7's centroid UNet on frames
of each size, SPATIAL_BATCH frames a data index, on every ``(n/s, s)`` mesh
of the first n cards for each n of ``--cards`` and s of ``--spatial`` that
divides it. One process a card, spawned once for all meshes (``torchrun``'s
way: each mesh opens a group of its n ranks, NCCL between cards, and
``Trainer.from_config(..., n_devices=n, spatial_sharding=s).train()`` joins
it; n = 1: one process, no group) for EPOCHS epochs of SPATIAL_STEPS steps
and one validation step, no run folder: images/s from the epochs after the
first, each card's peak memory (``max_memory_allocated``, the rank's
process: activations and cuDNN's workspace, which cuDNN sizes to the free
memory) and the bytes its first step saves for the backward (distinct
storages, the activations a band divides). Each spatially sharded mesh's
epoch losses are held to those of its data axis alone, ``(n/s, 1)``, where
that mesh ran too: the first epoch's within SPATIAL_FIRST_RTOL, every
epoch's within SPATIAL_RTOL (float32 rounding that Adam amplifies after the
first updates); a JSON line says so, and the script exits with 1 past
either. ``--device cpu`` rehearses it on the CPU over gloo at a small
``--sizes``.
"""

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TIMED_BATCHES, REPEATS = 6, 3
EPOCHS, STEPS = 3, 10
SPATIAL_BATCH, SPATIAL_STEPS = 2, 5
SPATIAL_FIRST_RTOL, SPATIAL_RTOL = 1e-5, 1e-4


def topdown_predictor():
    import sleap_tpu_torch

    with tempfile.TemporaryDirectory() as root:
        folders = cs.write_run_folders(root)
        gen = torch.Generator().manual_seed(0)
        paths = [folders["centroid"], folders["instance"]]
        params = {p: cs.seeded_params(p, gen) for p in paths}
        return sleap_tpu_torch.load_model(paths, params=params, batch_size=cs.BATCH,
                                          max_instances=cs.MAX_INSTANCES)


def inference(pred, cards):
    from sleap_tpu_torch.parallel.distributed import make_sharded_predictor
    from sleap_tpu_torch.parallel.mesh import make_mesh

    frames = cs.synthetic_frames((1 + TIMED_BATCHES) * cs.BATCH * max(cards), seed=0)
    runs = {n: make_sharded_predictor(dataclasses.replace(pred), make_mesh(n)) if n > 1 else pred
            for n in cards}
    fps, outs = {n: [] for n in cards}, {}
    for _ in range(REPEATS):
        for n, p in runs.items():
            gb = p.batch_size
            use = frames[:(1 + TIMED_BATCHES) * gb]
            p.predict(use[:gb], make_labels=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p.predict(use[gb:], make_labels=False)
            torch.cuda.synchronize()
            fps[n].append((len(use) - gb) / (time.perf_counter() - t0))
    for n, p in runs.items():  # the same frames through each
        outs[n] = cs.merged(p.predict(frames[:4 * cs.BATCH], make_labels=False), 4 * cs.BATCH)
    for n in cards:
        diff = cs.same_points(f"{n} cards", outs[n], outs[cards[0]], ("centroids", "instance_peaks"))
        print(json.dumps({"inference": {"cards": n, "global_batch": runs[n].batch_size,
                                        "fps": fps[n], "fps_median": float(np.median(fps[n])),
                                        "max_dxy_vs_first": diff}}), flush=True)


def training(cards):
    from sleap_tpu_torch.training.trainer import Trainer

    labels = cs.labels_of(*cs.phase7_recipe(16, seed=5))
    for n in cards:
        cfg = cs.train_config("centroid", batch=cs.TRAIN_BATCH * n)
        cfg.optimization.epochs = EPOCHS
        cfg.optimization.batches_per_epoch = STEPS
        cfg.optimization.val_batches_per_epoch = 1
        devices = [torch.device("cuda", i) for i in range(n)] if n > 1 else None
        trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels,
                                      devices=devices)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        steady = trainer.epoch_seconds[1:]
        print(json.dumps({"training": {
            "cards": n, "global_batch": cs.TRAIN_BATCH * n, "train_s": time.perf_counter() - t0,
            "epoch_s": trainer.epoch_seconds, "losses": [r["loss"] for r in trainer.log_rows],
            "images_per_s": STEPS * cs.TRAIN_BATCH * n * len(steady) / sum(steady)}}), flush=True)


def spatial_rank(rank, world, meshes, sizes, device_type, tmp):
    """One process of ``spatial``: for each size and ``(n, s)`` mesh with
    ``n > rank``, join that mesh's group (rendezvous file of its own) and
    train; its seconds, images/s and peak memory pickled into ``tmp``."""
    import os
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from sleap_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1 if device_type == "cpu" else torch.get_num_threads())
    os.environ["LOCAL_RANK"] = str(rank)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    rows = []
    try:
        for size in sizes:
            rng = np.random.default_rng(5)
            frames = rng.integers(0, 255, (4, size, size, 1), np.uint8)
            labels = cs.labels_of(frames, rng.uniform(size / 10, size * 0.9,
                                                      (4, 3, cs.N_NODES, 2)))
            for n, s in meshes:
                if rank >= n:
                    continue
                if n > 1:
                    dist.init_process_group(
                        "nccl" if device.type == "cuda" else "gloo", world_size=n, rank=rank,
                        init_method=f"file://{tmp}/rendezvous_{size}_{n}_{s}",
                        timeout=timedelta(seconds=600))
                cfg = cs.train_config("centroid", batch=SPATIAL_BATCH * (n // s))
                cfg.optimization.epochs = EPOCHS
                cfg.optimization.batches_per_epoch = SPATIAL_STEPS
                cfg.optimization.val_batches_per_epoch = 1
                trainer = Trainer.from_config(cfg, training_labels=labels,
                                              validation_labels=labels, device=device,
                                              n_devices=n if n > 1 else None, spatial_sharding=s)
                saved = cs.count_saved_activations(trainer)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer.train()
                peak = None
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    peak = torch.cuda.max_memory_allocated() / 2**30
                steady = trainer.epoch_seconds[1:]
                rows.append({"size": size, "cards": n, "mesh": {"data": n // s, "spatial": s},
                             "rank": rank, "global_batch": SPATIAL_BATCH * (n // s),
                             "train_s": time.perf_counter() - t0,
                             "epoch_s": trainer.epoch_seconds,
                             "images_per_s": SPATIAL_STEPS * SPATIAL_BATCH * (n // s)
                             * len(steady) / sum(steady),
                             "losses": [r["loss"] for r in trainer.log_rows], "peak_gib": peak,
                             "saved_gib": saved["gib"]})
                del trainer
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                if dist.is_initialized():
                    dist.destroy_process_group()
        result = (True, rows)
    except BaseException:
        result = (False, traceback.format_exc())
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def spatial(cards, spatial_sizes, sizes, device_type) -> bool:
    """Spatially sharded training on every ``(n/s, s)`` mesh: one JSON line
    a mesh and size, each rank's images/s and peak memory; then one line of
    each spatial mesh's epoch losses relative to its data axis's run.
    Whether every such mesh held within the bounds."""
    import pickle
    import shutil

    meshes = [(n, s) for n in cards for s in spatial_sizes if n % s == 0]
    world = max(n for n, _ in meshes)
    tmp = tempfile.mkdtemp(prefix="parallel_scaling_")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=spatial_rank, args=(r, world, meshes, sizes, device_type, tmp))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        results = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ok, value = pickle.load(f)
            if not ok:
                raise RuntimeError(f"parallel_scaling: rank {r} failed:\n{value}")
            results.extend(value)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    for size in sizes:
        for n, s in meshes:
            ranks = sorted((row for row in results if row["size"] == size and row["cards"] == n
                            and row["mesh"]["spatial"] == s), key=lambda row: row["rank"])
            first = ranks[0]
            print(json.dumps({"spatial": {
                "size": size, "cards": n, "mesh": first["mesh"],
                "global_batch": first["global_batch"], "images_per_s": first["images_per_s"],
                "train_s": [row["train_s"] for row in ranks], "epoch_s": first["epoch_s"],
                "losses": first["losses"], "peak_gib": [row["peak_gib"] for row in ranks],
                "saved_gib": [row["saved_gib"] for row in ranks]}}),
                flush=True)
    losses = {(row["size"], row["cards"], row["mesh"]["spatial"]): row["losses"]
              for row in results if row["rank"] == 0}
    held = True
    for (size, n, s), got in losses.items():
        want = losses.get((size, n // s, 1))
        if s == 1 or want is None:
            continue
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        ok = len(got) == len(want) and rel[0] <= SPATIAL_FIRST_RTOL and max(rel) <= SPATIAL_RTOL
        held &= ok
        print(json.dumps({"spatial_vs_data_axis": {
            "size": size, "mesh": {"data": n // s, "spatial": s}, "loss_rel": rel,
            "first_rtol": SPATIAL_FIRST_RTOL, "rtol": SPATIAL_RTOL, "held": ok}}), flush=True)
    return held


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", default="1,2,4")
    ap.add_argument("--spatial", default=None,
                    help="spatial sizes (e.g. 1,2,4): run spatially sharded training only")
    ap.add_argument("--sizes", default="1024,2048", help="frame sizes of --spatial")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: rehearse --spatial over gloo at a small --sizes")
    args = ap.parse_args()
    cards = [int(c) for c in args.cards.split(",")]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("parallel_scaling: CUDA is not available; this script needs the "
                             "cards.")
        if max(cards) > torch.cuda.device_count():
            raise SystemExit(f"parallel_scaling: {max(cards)} cards asked for, "
                             f"{torch.cuda.device_count()} visible.")
        from sleap_tpu_torch.ops import _build

        _build.build_library()
        print(cs.card_line(), flush=True)
    elif args.spatial is None:
        raise SystemExit("parallel_scaling: --device cpu rehearses --spatial only.")
    if args.spatial is not None:
        held = spatial(cards, [int(s) for s in args.spatial.split(",")],
                       [int(s) for s in args.sizes.split(",")], args.device)
        return 0 if held else 1
    inference(topdown_predictor(), cards)
    training(cards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
