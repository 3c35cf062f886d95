#!/usr/bin/env python3
"""Drive sleap_tpu_torch's top-down, single-instance, bottom-up and multiclass
inference, flow-shift tracking, training and the ``sleap-track``,
``sleap-train`` and ``sleap-inspect`` CLIs once on one CUDA card, through the
run-folder loader, the trainer and the CLIs a user calls, the repo's
trained run folders from their own checkpoints, and the other backbones
(ResNet, pretrained-encoder UNets, HRNet, Hourglass, LEAP) in inference,
float32 and bf16, and in training.

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed:

1. The card: CUDA must be available; print its name and power limit, then
   what the machine offers to decode H.264 (print only, never fails):
   ``ffmpeg`` on the path, the NVDEC library ``libnvcuvid`` (found, and
   whether it loads), and whether ``torchvision``, ``torchcodec``, ``av``
   and ``imageio_ffmpeg`` are installed (``find_spec``; nothing imported).
2. Build the CUDA kernels from ``sleap_tpu_torch/csrc``; print the build time.
   Write run folders (``training_config.json`` with the skeleton in its
   jsonpickle form) for ``bench.py``'s top-down pair, its single-instance
   model and its bottom-up model at full width: UNets with filters 64,
   filters rate 2, max stride 16, output stride 4, ``up_interpolate`` and an
   s2d-4 stem; 13 nodes in a chain; centroid input scaling 0.25, crop 160.
   Weights are seeded, the heads made non-negative (so maps cross the 0.2
   threshold and every stage works), and handed over as params trees
   (``flax_from_state_dict``). Every path loads with
   ``sleap_tpu_torch.load_model(folder, params=...)`` and no device
   argument: the card is the default. The top-down pair is written again
   with the instance folder as ``multi_class_topdown`` (the same UNet and
   crop, class vectors of 4 classes: 3 dense layers of 64 units on the
   globally pooled stride-16 feature, as in the repo's trained multiclass
   folder), and the bottom-up UNet as ``multi_class_bottomup`` (confmaps at
   stride 4, sigma 2.5; class maps of 4 classes at stride 4); their seeded
   weights keep the dense and class layers' signs.
3. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (planted-Gaussian maps plus noise; crop boxes hanging
   off every edge; local peaks with and without refinement) and on the cases
   each design splits on. Kernel 1: the float32 top-down maps (the NHWC
   view of NCHW), the same maps in bf16 channels-last and as the NCHW view,
   the single-instance path's 4 x 48^2 x 13 bf16, one 512^2 x 13 bf16 map
   (the band route), 37 x 41 maps (rows no multiple of 16 bytes) in both
   layouts and dtypes, slabs starting off a 16-byte boundary, a channel
   slice and a strided slice, ten equal maxima, maps all below threshold,
   half 1 and 3, maps holding one NaN, several NaNs, and a NaN after the
   finite maximum, in both dtypes and layouts (on the grid route, half -1,
   the first NaN's xy with value NaN, as JAX's rough peaks); float16 and
   float64 maps refused.
   Crops bitwise: float32 frames at the path size,
   C = 3, 5 and 6 (every C mod 4), odd crop sizes, non-contiguous frame strides, box
   indices -1 and B, rows of more than 512 flat elements (several segments
   a row, C = 1 and 3) and 300 channels (shorter bands). Kernel 2: a 512^2 map, 13 channels channels-last and
   as the NCHW view, 70 x 45, 16 x 9000, K = 1 and 64, ten equal peaks,
   threshold 0 and -1, integral windows of half 1 and 3. Kernel 4 on
   bf16 maps of 16 x 256^2 x 13 channels-last (with ten equal peaks in one
   map), as an NCHW view, on the bottom-up path's own head maps, with
   H = 250 (not a multiple of the band), on 16 x 100^2 x 3 (W*C*2 % 16 != 0),
   with K = 1, K = 16 (the trained bottom-up folder's default) and
   K = 64, and on 16 x 64^2 x 1 (the bf16 top-down centroid maps): values,
   keys and integer peaks exact, refined xy within 1e-4 px.
4. Top-down (1024^2 uint8 frames, batch 16, 4 instances, float32 with TF32
   off): 8 timed batches of ``predict(make_labels=False)``; kernels 1-3 must
   be launched once per batch in them. One more batch with
   ``make_labels=True`` must give the port's ``Labels`` with the example
   dicts' instance count, and a batch of 4 must match the same folders
   loaded on the CPU.
4b. Bottom-up (K = 8 peaks per node, 3 instances kept, batch 16, bf16): the
   same, with kernel 4; the card's bf16 head maps grouped on the CPU must
   give the card's instances, and the float32 model must match the CPU on
   a batch of 4.
4c. Top-down in bf16 (``load_model(..., compute_dtype=torch.bfloat16)``):
   8 timed batches with kernels 4, 3 and 1 launched once per batch, one
   batch with ``Labels``; the card's bf16 instance maps of one batch,
   post-processed on the CPU by the plain version, must give the kernel's
   peaks (values exact, xy within 1e-4 px).
4d. Single-instance in bf16 (192^2 uint8 frames, batch 4): the same, with
   kernel 1 once per batch.
4e. Top-down multiclass (float32, TF32 off; 1024^2 uint8, batch 16, 4
   instances) on frames holding one blob in each quadrant, of four sizes,
   with the seeded class layer's output set (``fit_class_head``) to tell
   the sizes apart: 8 timed batches with kernels 2, 3 and 1 launched once
   per batch, at least two classes assigned in every frame; one batch with
   ``Labels``, which must hold the 4 class tracks; a batch of 4 must match
   the same folders loaded on the CPU (points within PATH_XY_TOL, values
   within PATH_VAL_TOL, class probabilities within PROB_TOL).
4f. Bottom-up multiclass in bf16 (batch 16, K = 8): 8 timed batches with
   kernel 4 once per batch; the card's bf16 confmaps and class maps of 4
   frames, through the plain peaks and ``classify_peaks_from_maps`` on the
   CPU, must give the card's points (values and probabilities exact, xy
   within BU_XY_TOL).
4g. The trained ``.convergence_runs`` folders, loaded with
   ``load_model(folder)`` and no params, their weights read by the port's
   own orbax reader (each checkpoint's read time printed): the
   ``minimal_instance`` top-down pair, its bottom-up folder (offset heads),
   ``minimal_robot`` single-instance, and the ``min_tracks_2node``
   multiclass folder paired with the ``minimal_instance`` centroid folder;
   on a batch of 4 synthetic frames at the CPU tests' sizes, each with two
   blobs of sigma 14 px, each folder must find an animal with finite points
   in every frame (the multiclass folder an animal of each class), and
   match the same folders on the CPU.
6. Tracking (``load_model(..., tracker="flow")``, the CLI defaults: window 5,
   instance similarity, greedy matching, img_scale 1, flow window 21, 3
   levels). 6a: phase 4's top-down float32 folders on 1 + 8 batches of
   1024^2 frames where 4 blobs (sigma 8 px) move on smooth paths of at most
   4 px a frame over seeded noise; ``predict`` with ``Labels`` must launch
   kernels 2, 3 and 1 once per batch, give every instance a track and run
   every flow call on the card; prints FPS with tracking beside phase 4's,
   the tracker's host ms a frame, and the flow's device ms and launches per
   call and the tracker's device launches per frame (``torch.profiler``,
   one call a session, from two sessions that agree on every count).
   6b: the card's instances of 32 of those frames tracked by a card tracker
   and a CPU tracker: the same track per instance, tracking scores within
   TRACK_SCORE_TOL, the saved flow-shifted instances within SHIFT_TOL px
   with the same status. 6c: the trained top-down pair from its checkpoint
   at 384^2 on 32 frames of two sigma-9 blobs over a static background
   whose paths stay over 60 px apart: flow gives exactly 2 tracks, every
   instance tracked, and over the frames where the detector puts one
   instance on each blob no track changes blob; ``tracker="simple"`` and
   the Kalman route (``kf_init_frame_count`` 5, ``kf_node_indices``
   [0, 1], ``max_tracks`` 2) give 2 tracks each. The same paths with 4g's
   sigma-14 blobs over fresh noise are tracked by flow and printed only.
7. Training (``sleap_tpu_torch.training``), after phase 6. 7a and 7b:
   ``bench.py``'s train cells (``_train_throughput``): the UNet above on
   1024^2 uint8 frames of 3 instances, batch 16, float32 with TF32 off,
   Adam at 1e-4, augmentation off; 7a centered-instance confmaps on crops
   of 160 (13 nodes, sigma 2.5, stride 4), 7b confmaps and PAFs (stride 8,
   sigma 5, 12 edges). ``Trainer.from_config`` on the card by default;
   2 warm-up steps, then 20 timed and synchronised: images/s, ms a step,
   one step's device time and launches (``torch.profiler``, two sessions
   agreeing) and so the device's busy share, peak memory. 7e: 7a in mixed
   precision (bf16 autocast, channels-last): float32 parameters and
   optimizer state, finite losses, images/s. 7d: one step of a small
   top-down and bottom-up config (filters 16, 256^2) on the card and on the
   CPU from the same initial weights and batch: loss within 1e-5 relative,
   each gradient within 1e-4 of its largest value. 7c: the top-down pair
   (centroid at input scale 0.25, then centered instance) trained from
   scratch for 300 steps each on frames of blob animals; each model's last
   epoch loss at most half its first; the run folders loaded with
   ``load_model`` and no params (``best_model.pt``) predict 16 held-out
   frames with kernels 2, 3 and 1 once a batch, find every held-out animal
   within PAIR_BOUND_PX of mean node error, and match the CPU as phase 4.
8. ``sleap-track`` (``sleap_tpu_torch.cli.track.main``, in this process),
   after phase 7, with no ``h5py`` or ``cv2``. 8a: 32 frames of 1024^2 (4
   sigma-8 blobs moving at most 4 px a frame over noise) written by the
   port's ``write_labels`` as a ``.slp`` (raw ``video0_raw``), tracked by the
   CLI with ``--tracking.tracker flow --batch_size 16`` on phase 4's float32
   top-down folders (their weights saved as ``best_model.pt``); the output
   read back must hold 32 frames whose instances, points, scores and tracks
   equal ``load_model(..., tracker="flow").predict(frames)`` in this process
   within CLI_TOL, and the CLI must launch kernels 2, 3 and 1 once a batch;
   prints the write and read seconds, the CLI's end-to-end FPS (read,
   predict, track, write) beside the in-process tracked FPS. 8b: the
   committed fixtures ``tests/torch_data/{raw,pkg}.slp`` (a chunked gzip
   ``video0_raw``; PNG rows) with the trained folders: the top-down pair,
   the centered-instance folder alone (ground-truth centroids: one instance
   per user instance), the centroid folder alone, and bottom-up in float32,
   each equal to the same CLI with ``--cpu`` within PATH_XY_TOL and
   PATH_VAL_TOL; and bottom-up in bf16 (``--compute_dtype bfloat16``, kernel
   4), equal to ``load_model`` in this process. Together they must launch
   all four kernels. Prints the PNG frames' read and decode ms a frame (the
   package's rows cycle through all five row filters), and the decode ms of
   1024^2 frames whose rows are all Average, all Paeth, or cycle through all
   five (``scripts/png_decode_time.py``'s frames), each decoded exactly.
9. ``sleap-train`` from ``.slp`` to scored run folders, after phase 8, with no
   ``h5py`` or ``cv2``. 9a: the port's ``write_labels`` writes a ``.slp`` of
   two HDF5 videos (TRAIN_CLI_FRAMES frames of 1024^2 and as many of 768^2,
   which size matching scales by 4/3: the port's own uint8 bilinear resize
   on every frame of them) of 3 blob animals a frame; ``cli.train.main``
   trains, on the card by default, the port's copies of the shipped
   ``baseline.centroid.json`` and ``baseline_medium_rf.topdown.json`` at
   their own widths, strides, scaling, batch size and augmentation, with
   epochs, batches, validation batches and learning rate cut
   (TRAIN_CLI_*). Each run folder must hold ``best_model.pt``, the configs,
   ``training_log.csv``, ``labels_gt``/``labels_pr`` of both splits and
   ``metrics.{train,val}.npz``; ``load_metrics`` must read each metrics file,
   equal to the evaluation's and to ``evaluate`` of the two label files read
   back; the centroid folder's evaluations must launch kernel 2 alone, the
   centered-instance folder's (ground-truth centroids) kernels 3 and 1; the
   card's validation predictions must equal the same folder evaluated on the
   CPU within PATH_XY_TOL and PATH_VAL_TOL; the instance model's validation
   ``dist.p50`` and ``oks_voc.mAP`` must pass their bounds; ``sleap-track``
   of the pair on the validation frames must find every animal within
   TRAIN_CLI_TRACK_PX. Prints each model's CLI seconds split into setup,
   training (images/s) and evaluation, each evaluation's seconds and scores.
   9b: ``sleap-inspect`` (``info.labels.main``) of the instance run folder
   must print its config's backbone, head and nodes and its log's epochs and
   best ``val_loss``; of the project, its frames, tracks and videos.
10. The other backbones at their configs' default widths, after phase 9,
   float32 with TF32 off. Folders written as phase 2's, weights seeded:
   He-normal kernels, non-negative heads, batch-norm running means
   N(0, 0.1^2) and variances U(0.5, 2), then each conv's kernel and bias
   scaled so that its output has unit standard deviation on a calibration
   batch (LSUV), handed over as flax variables. 10a: top-down 1024^2, batch
   16, phase 4's centroid UNet with a centered-instance pretrained-encoder
   ResNet-50 UNet (decoder 256 filters, output stride 2, crops of 160);
   10b: the same with ``resnet`` ResNet50 (default upsampling); kernels 2,
   3 and 1 once a batch. 10c: single-instance 512^2, batch 4, on
   Hourglass (3 stacks), HRNet (C 18), LEAP and the pretrained-encoder
   EfficientNet-b0 UNet; kernel 1 once a batch. Each: 8 timed batches (FPS,
   device ms a batch from ``torch.profiler``), one batch with ``Labels``,
   and the card against the same folders loaded with ``device="cpu"`` on
   BB_CPU_FRAMES frames within PATH_XY_TOL and PATH_VAL_TOL. 10d: a library
   ``predict`` leaves the caller's TF32 flags as it found them; and
   ``python -m sleap_tpu_torch.cli.track`` in a fresh process (no TF32
   flag set by this one) on the card against ``--cpu``, on 8b's float32
   pair and on 10b's folders, within PATH_XY_TOL and PATH_VAL_TOL.
11. Training the other backbones, and their bf16 inference, after phase 10,
   on its configs. 11a: one train step of LEAP, Hourglass (3 stacks), HRNet
   (C 18), ``resnet`` ResNet50 and the pretrained-encoder EfficientNet-b0
   and ResNet-50 UNets at full width on BB_STEP_BATCH frames of
   BB_STEP_SIZE^2, on the card and on the CPU from the same lecun-seeded
   weights, TF32 off: in float32 through the trainer (the loss held; the
   gradients and statistics printed), and in float64 on the same images and
   ground truth (loss, gradients and statistics held; every statistic
   moved). 11b: TRAIN_STEPS synchronised train steps after TRAIN_WARMUP,
   float32 and mixed precision, single-instance BB_SI_IMG^2 batch
   BB_SI_BATCH on Hourglass, HRNet, LEAP, EfficientNet-b0 and ResNet50, and
   top-down pretrained-encoder ResNet-50 on crops of CROP of 1024^2 frames,
   batch TRAIN_BATCH: images/s, ms a step, one step's device ms and launches,
   busy share, peak memory; batch norm float32 throughout. 11c: a
   batch-norm Hourglass through ``cli.train.main`` from a ``.slp`` written
   here; ``best_model.pt``'s statistics moved; the folder on the card
   (kernel 1 once a batch) finds every held-out animal within
   BB_CLI_BOUND_PX and agrees with ``device="cpu"`` within PATH_XY_TOL and
   PATH_VAL_TOL. 11d: phase 10's folders and weights with
   ``compute_dtype=torch.bfloat16`` (kernels 4, 3, 1 top-down, kernel 1
   single-instance, once a batch; batch norm float32), 8 timed batches and
   one profiled, the card's bf16 maps through kernel 1 against the plain
   version on the CPU (values exact, xy within XY_TOL).
5. (Run after 4d, before 4e; the launches of 4e-4g, 6, 7c, 8, 9, 10 and 11 join its
   rows at the end.) Time each kernel and its plain version: per call with CUDA events (50
   back-to-back calls, in turns), device time with ``torch.profiler`` (the
   kernel's own device functions over 20 calls), the bound (bytes moved at
   3.35 TB/s, or operations at the card's peak, whichever is larger) and,
   for crops, ``F.grid_sample`` on the float32 form of the same boxes.
   Kernel 1 on both the float32 and the bf16 top-down maps; a bf16
   ``find_global_peaks`` call must launch kernel 1 alone (no cast or copy).

Then a JSON line of phase 7's numbers, one of phase 11's; the line before the last is a JSON
object with each kernel's launches (all paths' and per path), error and
times; the last line is ``{"ok": true, "device": {...}}``.
"""

import csv
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

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
# Multiclass, GPU vs CPU class probabilities (softmax of f32 dense layers on
# convolution features that differ by ~1e-5).
PROB_TOL = 1e-3

IMG, CROP, N_NODES, BATCH, MAX_INSTANCES = 1024, 160, 13, 16, 4
# Phase 10c: single-instance folders of the other backbones at 512^2, batch
# 4; every phase-10 path is held against the CPU on BB_CPU_FRAMES frames.
BB_SI_IMG, BB_SI_BATCH, BB_CPU_FRAMES = 512, 4, 2
TIMED_BATCHES = 8
# Single-instance (``bench.py:160-175,287``): 192^2 frames, batch 4, bf16.
SI_IMG, SI_BATCH = 192, 4
# Bottom-up (``bench.py:128-157``): confmaps at stride 4, PAFs at stride 8,
# K = 8 peaks per node, 3 instances kept, bf16.
BU_CM_STRIDE, BU_PAF_STRIDE, BU_K, BU_MAX_INSTANCES = 4, 8, 8, 3
HWCS_HALF = 2
# Multiclass folders: 4 classes (``bench.py``'s top-down and bottom-up UNets).
CLASSES = [f"id{i}" for i in range(4)]
# Top-down multiclass frames: four blobs a frame, one in each quadrant, of
# these sigmas in px in a random order: animals of four sizes, which the
# class layer ``fit_class_head`` sets tells apart.
MC_SIGMAS = (8, 14, 20, 26)
# The trained folders, at the sizes the CPU tests drive them: (name, run
# folders under .convergence_runs, frame size). Their frames hold two blobs
# of sigma 14 px, on which every folder finds an animal in each frame and
# the multiclass folder finds both of its classes.
TRAINED = [
    ("trained top-down", ["minimal_instance.UNet.centroid",
                          "minimal_instance.UNet.centered_instance"], 384),
    ("trained bottom-up", ["minimal_instance.UNet.bottomup"], 128),
    ("trained single-instance", ["minimal_robot.UNet.single_instance"], 160),
    ("trained multiclass", ["minimal_instance.UNet.centroid",
                            "min_tracks_2node.UNet.topdown_multiclass"], 384),
]
TRAINED_BLOBS, TRAINED_SIGMA = 2, 14.0
# Phase 6: blob paths of at most this many px a frame; the card's and the
# CPU's trackers on this many frames; their tracking scores (exp(-d^2) of
# flow points that differ by ~1e-5 px) and flow-shifted points.
TRACK_MAX_STEP, CARD_CPU_FRAMES = 4.0, 32
TRACK_SCORE_TOL, SHIFT_TOL = 1e-4, 1e-3
# 6c: the trained top-down pair on 32 frames of two blobs over one static
# noise background. On sigma-14 blobs over fresh noise (4g's blobs) the
# detector often puts both instances on one blob and its points jump by
# more than the instance similarity's few px from frame to frame (6c
# prints how often; the JAX package gives the same detections and tracks),
# so no tracker could keep identities there; on sigma-9 blobs it finds
# one instance per blob in nearly every frame.
TRACKED_TRAINED = ["minimal_instance.UNet.centroid", "minimal_instance.UNet.centered_instance"]
TRACKED_SIZE, TRACKED_FRAMES, TRACKED_SIGMA, TRACKED_AMPLITUDE = 384, 32, 9.0, 240.0
TRACKED_GAP, TRACKED_MIN_CLEAN = 60.0, 28

# Phase 7, training. 7a/7b/7e: ``bench.py``'s train cells
# (``_train_throughput``, bench.py:745-806): batch 16 of 1024^2 frames of 3
# instances, Adam at 1e-4, augmentation off; 2 warm-up steps, 20 timed.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 16, 2, 20
# 7c: the top-down pair (centroid at input scale 0.25, then centered
# instance at crop 160; the UNet of 7a) trained from scratch for a fixed
# number of steps at learning rate 1e-3 on 1024^2 frames of 3 blob animals
# (sigma 10 px, 13 nodes on a 6-px ring around the centre, centres 200 px
# apart and 150 px inside); 32 held-out frames (a warm-up batch and a timed
# one). Every held-out animal must be found, the nearest predicted
# instance's mean node error within PAIR_BOUND_PX: about twice the largest
# error read on an H100 (max 0.681-0.739 px over four runs, PERF.md
# section 6).
PAIR_TRAIN_FRAMES, PAIR_HELD_OUT, PAIR_EPOCHS, PAIR_BATCHES, PAIR_LR = 64, 32, 20, 15, 1e-3
PAIR_ANIMALS, PAIR_SIGMA, PAIR_RING, PAIR_GAP, PAIR_MARGIN = 3, 10.0, 6.0, 200, 150
PAIR_BOUND_PX = 1.5
# 7d: one step on the card and on the CPU, from one init and batch, at a
# small width; the loss within 1e-5 relative, each gradient within 1e-4 of
# its largest magnitude (float32 convs summing in another order).
STEP_SIZE, STEP_FILTERS, STEP_CROP = 256, 16, 64
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-4

# Phase 8a: the CLI against ``load_model`` in the same process on the same
# frames: the same kernels, plans and tracker, so the same instances and
# tracks; points and scores within CLI_TOL.
CLI_FRAMES, CLI_TOL = 32, 1e-4
# 8b: the committed fixtures (``scripts/make_torch_slp_fixtures.py``) and the
# trained folders the CPU tests drive on them.
FIXTURE_DIR = ("tests", "torch_data")
CLI_TRAINED = ("minimal_instance.UNet.centroid", "minimal_instance.UNet.centered_instance",
               "minimal_instance.UNet.bottomup")

# Phase 9: ``sleap-train`` (``sleap_tpu_torch.cli.train.main``) of the port's
# copies of two shipped profiles, at their own widths, strides, input
# scaling, batch size and augmentation, on a project of two HDF5 videos:
# TRAIN_CLI_FRAMES frames of IMG^2 and as many of TRAIN_CLI_SMALL^2, whose
# animals are 7c's blob animals drawn TRAIN_CLI_SMALL / IMG times smaller,
# so size matching (4/3) makes them alike. Cuts: epochs, batches per epoch,
# validation batches and the learning rate (1e-4 in the profiles); a CPU
# rehearsal (scripts/train_cli_cpu.py) sized them.
TRAIN_CLI_PROFILES = (("centroid", "baseline.centroid.json"),
                      ("instance", "baseline_medium_rf.topdown.json"))
TRAIN_CLI_FRAMES, TRAIN_CLI_SMALL = 24, 768
# Animals of a size users film at 1024^2 (a blob of sigma 16 px, the nodes
# on a ring of 24 px): OKS, whose scale is the animal's area, then reads
# localisation errors of a fraction of a pixel as it would on real data.
TRAIN_CLI_SIGMA, TRAIN_CLI_RING = 16.0, 24.0
TRAIN_CLI_EPOCHS, TRAIN_CLI_BATCHES, TRAIN_CLI_VAL_BATCHES, TRAIN_CLI_LR = 20, 20, 2, 1e-3
# Bounds from three runs on an H100 and a CPU rehearsal (PERF.md section 6,
# PR 10): ``sleap-track`` of the trained pair on the validation frames finds
# every animal within TRAIN_CLI_TRACK_PX of mean node error (worst max read
# 0.647 px); the instance model's validation ``dist.p50`` is at most
# TRAIN_CLI_P50_PX (worst 0.698 px: ground-truth centroids carry the
# reference's half-pixel crop offset, ROADMAP queue 3) and its
# ``oks_voc.mAP`` at least TRAIN_CLI_MAP (every reading 1.0). About twice
# the worst error, half the worst mAP.
TRAIN_CLI_TRACK_PX, TRAIN_CLI_P50_PX, TRAIN_CLI_MAP = 1.3, 1.4, 0.5

# Phase 11: the other backbones (phase 10's configs) in training. 11a: one
# step on the card and on the CPU from the same init and batch, at full width
# on BB_STEP_BATCH frames of BB_STEP_SIZE^2; float32: the loss within
# BB_STEP_LOSS_RTOL relative; float64 on the same images and ground truth:
# the loss and each running statistic within BB_STEP_LOSS_RTOL and
# BB_STEP_STATS_RTOL, each gradient within BB_STEP_GRAD_RTOL of its largest
# value (the first H100 run read at most 4.7e-15, 3.3e-14 and 4.1e-12; in
# float32 the gradients differ by up to 0.40 of their largest value, PERF.md
# section 6, PR 12). 11b: BB_TRAIN_BACKBONES timed (single-instance
# BB_SI_IMG^2 batch BB_SI_BATCH; the pretrained-encoder ResNet-50 top-down on
# crops of CROP, batch TRAIN_BATCH). 11c: a single-instance Hourglass of
# BB_CLI_STACKS stack (the other widths its config's defaults; sigma
# BB_CLI_SIGMA at stride 4, the shipped baseline_large_rf.single.json's head)
# through ``cli.train.main`` on BB_CLI_FRAMES frames of BB_CLI_IMG^2 of one
# blob animal of phase 9's shape, held out on BB_CLI_HELD_OUT frames (a
# warm-up batch first); every held-out animal within BB_CLI_BOUND_PX of mean
# node error: about twice the worst read on an H100 (2.419 px, PERF.md
# section 6, PR 12).
BB_STEP_BACKBONES = ("LEAP", "Hourglass", "HRNet", "resnet ResNet50",
                     "pretrained-encoder EfficientNet-b0", "pretrained-encoder ResNet-50")
BB_STEP_SIZE, BB_STEP_BATCH = 128, 2
BB_STEP_LOSS_RTOL, BB_STEP_GRAD_RTOL, BB_STEP_STATS_RTOL = 1e-5, 1e-4, 1e-5
BB_TRAIN_BACKBONES = ("Hourglass", "HRNet", "LEAP", "pretrained-encoder EfficientNet-b0",
                      "resnet ResNet50", "pretrained-encoder ResNet-50")
BB_CLI_IMG, BB_CLI_FRAMES, BB_CLI_HELD_OUT, BB_CLI_BATCH = 256, 32, 12, 4
BB_CLI_STACKS, BB_CLI_SIGMA = 1, 5.0
BB_CLI_EPOCHS, BB_CLI_BATCHES, BB_CLI_LR = 20, 40, 1e-3
BB_CLI_BOUND_PX = 5.0

# The card's peaks (H100 SXM data sheet): memory rate, and float32 outside
# the tensor cores for the kernels' few operations per byte.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def device_events(fn, names=None, iters=20, tries=8):
    """``torch.profiler``'s device functions over ``iters`` calls of ``fn``,
    those whose names hold one of ``names`` (all of them if None). Every
    call launches the same device functions, so a session in which one of
    them did not run a multiple of ``iters`` times lost events (the profiler
    now and then drops a session's device events, wholly or in part); it is
    run again, and nothing is read from it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0
                  and (names is None or any(n in e.key for n in names))]
        if events and all(e.count % iters == 0 for e in events):
            return events
    raise RuntimeError(f"chip_smoke: torch.profiler lost device events in {tries} sessions")


def repeated_events(fn, tries=8):
    """``torch.profiler``'s device functions of one call of ``fn``, from the
    first two sessions that agree on every function's count: a session of
    a call of thousands of launches now and then drops some of its events,
    so a count seen twice is taken as whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        counts = tuple(sorted((e.key, e.count) for e in events))
        if counts in seen:
            return events
        seen.add(counts)
    raise RuntimeError(f"chip_smoke: no two of {tries} profiler sessions saw the same launches")


def device_ms(fn, names=None, iters=20) -> float:
    """Device time per call of the device functions ``device_events`` reads."""
    return sum(e.self_device_time_total for e in device_events(fn, names, iters)) / 1e3 / iters


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


def synthetic_frames(n, seed, size=IMG, blobs=MAX_INSTANCES, sigma=8.0) -> np.ndarray:
    """(n, size, size, 1) uint8: noise plus bright Gaussian blobs of ``sigma`` px."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 40, (n, size, size, 1), dtype=np.uint8)
    r = int(3 * sigma)
    g = np.mgrid[-r:r + 1, -r:r + 1]
    blob = np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * sigma**2))
    for i in range(n):
        for _ in range(blobs):
            y, x = rng.integers(r, size - r, 2)
            patch = frames[i, y - r:y + r + 1, x - r:x + r + 1, 0].astype(np.float32)
            frames[i, y - r:y + r + 1, x - r:x + r + 1, 0] = np.clip(patch + 200 * blob, 0, 255)
    return frames


def mc_frames(n, seed, size=IMG) -> np.ndarray:
    """(n, size, size, 1) uint8: noise plus one bright Gaussian blob in each
    quadrant, at least 96 px inside it, of the sigmas ``MC_SIGMAS``."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 40, (n, size, size, 1), dtype=np.uint8)
    half = size // 2
    for i in range(n):
        for q, sigma in enumerate(rng.permutation(MC_SIGMAS)):
            r = 3 * int(sigma)
            g = np.mgrid[-r:r + 1, -r:r + 1]
            blob = np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * float(sigma) ** 2))
            y = (q // 2) * half + rng.integers(96, half - 96)
            x = (q % 2) * half + rng.integers(96, half - 96)
            patch = frames[i, y - r:y + r + 1, x - r:x + r + 1, 0].astype(np.float32)
            frames[i, y - r:y + r + 1, x - r:x + r + 1, 0] = np.clip(patch + 200 * blob, 0, 255)
    return frames


# --------------------------------------------------------------------------- #
# Run folders and loading
# --------------------------------------------------------------------------- #


def write_run_folders(root):
    """``bench.py``'s top-down pair, single-instance and bottom-up models as
    run folders."""
    from sleap_tpu_torch import config as c
    from sleap_tpu_torch.core.skeleton import Skeleton

    names = [f"n{i}" for i in range(N_NODES)]
    skeleton = Skeleton("chain13")
    for n in names:
        skeleton.add_node(n)
    for a, b in zip(names[:-1], names[1:]):
        skeleton.add_edge(a, b)
    unet = c.UNetConfig(max_stride=16, output_stride=4, filters=64, filters_rate=2.0,
                        up_interpolate=True, space_to_depth=4)

    def folder(name, heads, input_scaling, crop_size=None):
        cfg = c.TrainingJobConfig(
            data=c.DataConfig(
                labels=c.LabelsConfig(skeletons=[skeleton]),
                preprocessing=c.PreprocessingConfig(input_scaling=input_scaling, pad_to_stride=16),
                instance_cropping=c.InstanceCroppingConfig(crop_size=crop_size),
            ),
            model=c.ModelConfig(backbone=c.BackboneConfig(unet=unet), heads=heads),
        )
        path = os.path.join(root, name)
        os.makedirs(path)
        cfg.save_json(os.path.join(path, "training_config.json"))
        return path

    return {
        "centroid": folder("centroid", c.HeadsConfig(
            centroid=c.CentroidsHeadConfig(output_stride=4, sigma=2.5)), 0.25),
        "instance": folder("instance", c.HeadsConfig(
            centered_instance=c.CenteredInstanceConfmapsHeadConfig(output_stride=4, sigma=2.5)),
            1.0, crop_size=CROP),
        "single": folder("single", c.HeadsConfig(
            single_instance=c.SingleInstanceConfmapsHeadConfig(output_stride=4, sigma=2.5)), 1.0),
        "bottomup": folder("bottomup", c.HeadsConfig(multi_instance=c.MultiInstanceConfig(
            confmaps=c.MultiInstanceConfmapsHeadConfig(output_stride=BU_CM_STRIDE, sigma=2.5),
            pafs=c.PartAffinityFieldsHeadConfig(output_stride=BU_PAF_STRIDE, sigma=5.0))), 1.0),
        "mc_instance": folder("mc_instance", c.HeadsConfig(
            multi_class_topdown=c.MultiClassTopDownConfig(
                confmaps=c.CenteredInstanceConfmapsHeadConfig(output_stride=4, sigma=2.5),
                class_vectors=c.ClassVectorsHeadConfig(
                    classes=CLASSES, num_fc_layers=3, num_fc_units=64, global_pool=True,
                    output_stride=16))),
            1.0, crop_size=CROP),
        "mc_bottomup": folder("mc_bottomup", c.HeadsConfig(
            multi_class_bottomup=c.MultiClassBottomUpConfig(
                confmaps=c.MultiInstanceConfmapsHeadConfig(output_stride=BU_CM_STRIDE, sigma=2.5),
                class_maps=c.ClassMapsHeadConfig(classes=CLASSES, output_stride=BU_CM_STRIDE))),
            1.0),
    }


def seeded_params(path, gen):
    """Seeded random weights for a run folder, non-negative in the
    confidence-map and offset heads (the class heads keep their signs), as
    the params tree ``load_model`` takes."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.models.model import Model, init_params
    from sleap_tpu_torch.models.params import flax_from_state_dict

    cfg = TrainingJobConfig.load_json(path)
    crop = cfg.data.instance_cropping.crop_size
    model = Model.from_config(cfg.model, skeleton=cfg.data.labels.skeletons[0])
    net = model.make_module(1, input_hw=(crop, crop) if crop else None)
    init_params(net, gen)
    with torch.no_grad():
        for name, head in net.heads.items():
            if isinstance(head, torch.nn.Conv2d) and "Class" not in name:
                head.weight.abs_()
    return flax_from_state_dict(net)


def load_predictors(folders):
    """(top-down on the card, top-down on the CPU, bottom-up bf16 on the
    card, bottom-up float32 on the card, bottom-up float32 on the CPU),
    top-down bf16 on the card, single-instance bf16 on the card, and the
    top-down folders again with a flow tracker."""
    import sleap_tpu_torch

    gen = torch.Generator().manual_seed(0)
    td_paths = [folders["centroid"], folders["instance"]]
    params = {p: seeded_params(p, gen) for p in (*td_paths, folders["bottomup"])}
    params[folders["single"]] = seeded_params(folders["single"], gen)
    td = sleap_tpu_torch.load_model(td_paths, params=params, batch_size=BATCH,
                                    max_instances=MAX_INSTANCES)
    td_cpu = sleap_tpu_torch.load_model(td_paths, device="cpu", params=params, batch_size=4,
                                        max_instances=MAX_INSTANCES)
    td_bf16 = sleap_tpu_torch.load_model(td_paths, params=params, batch_size=BATCH,
                                         max_instances=MAX_INSTANCES, compute_dtype=torch.bfloat16)
    si = sleap_tpu_torch.load_model(folders["single"], params=params, batch_size=SI_BATCH,
                                    compute_dtype=torch.bfloat16)
    bu = []
    for device, dtype, batch in ((None, torch.bfloat16, BATCH), (None, torch.float32, 4),
                                 ("cpu", torch.float32, 4)):
        kwargs = {} if device is None else {"device": device}
        pred = sleap_tpu_torch.load_model(folders["bottomup"], params=params, batch_size=batch,
                                          max_instances=BU_MAX_INSTANCES, compute_dtype=dtype,
                                          **kwargs)
        pred.max_peaks_per_node = BU_K
        bu.append(pred)
    td_tracked = sleap_tpu_torch.load_model(td_paths, params=params, batch_size=BATCH,
                                            max_instances=MAX_INSTANCES, tracker="flow")
    check(all(p.device.type == "cuda" for p in (td, bu[0], td_bf16, si, td_tracked)),
          "the card is the default")
    return td, td_cpu, bu, td_bf16, si, td_tracked


def load_multiclass(folders):
    """(top-down multiclass float32 on the card, the same on the CPU,
    bottom-up multiclass bf16 on the card), weights from their own
    generator."""
    import sleap_tpu_torch

    gen = torch.Generator().manual_seed(1)
    paths = [folders["centroid"], folders["mc_instance"], folders["mc_bottomup"]]
    params = {p: seeded_params(p, gen) for p in paths}
    td_paths = paths[:2]
    td = sleap_tpu_torch.load_model(td_paths, params=params, batch_size=BATCH,
                                    max_instances=MAX_INSTANCES)
    td_cpu = sleap_tpu_torch.load_model(td_paths, device="cpu", params=params, batch_size=4,
                                        max_instances=MAX_INSTANCES)
    bu = sleap_tpu_torch.load_model(paths[2], params=params, batch_size=BATCH,
                                    compute_dtype=torch.bfloat16)
    check(bu.max_peaks_per_node == BU_K, "bottom-up multiclass K")
    check(td.device.type == bu.device.type == "cuda", "the card is the default")
    return td, td_cpu, bu


def fit_class_head(preds, frames):
    """Set the output layer of the seeded class-vector head so that it tells
    4e's blobs apart by size (the seeded layer gives every crop one class).
    ``t``, the least-squares fit of the crops' mean brightness on their last
    hidden features, is cut into four ranges, each cut in the
    widest gap between sorted crops within an eighth of the crops of a
    quartile; class c's logit is the line ``s * (c * t + b_c)``, which tops
    the others on range c. Sets the layer in every predictor of ``preds``
    (the card's first); returns the cuts, and the smallest distance of a
    crop to a cut over the spread of ``t``."""
    module = preds[0].confmap_model.module
    layer = module.heads["ClassVectorsHead"]
    crops, feats = [], []
    hooks = [
        module.register_forward_pre_hook(lambda m, args: crops.append(args[0].double().cpu())),
        layer.register_forward_hook(lambda m, args, out: feats.append(args[0].double().cpu())),
    ]
    try:
        preds[0].predict(frames, make_labels=False)
    finally:
        for hook in hooks:
            hook.remove()
    bright = torch.cat(crops).mean(dim=(1, 2, 3))
    h = torch.cat(feats)
    mean = h.mean(0)
    u = torch.linalg.lstsq(h - mean, (bright - bright.mean())[:, None]).solution[:, 0]
    ts = ((h - mean) @ u).sort().values
    n, k = len(ts), len(CLASSES)
    cuts = []
    for q in range(1, k):
        lo, hi = q * n // k - n // (2 * k), q * n // k + n // (2 * k)
        i = lo + int(torch.argmax(ts[lo + 1:hi + 1] - ts[lo:hi]))
        cuts.append(float(ts[i] + ts[i + 1]) / 2)
    margin = float((ts[:, None] - torch.tensor(cuts, dtype=ts.dtype)).abs().min())
    scale = 8.0 / margin  # logit gap >= 8 at every crop: probabilities >= 0.999
    slopes = torch.arange(k, dtype=torch.float64)
    offsets = torch.tensor([0.0] + list(-np.cumsum(cuts)), dtype=torch.float64)
    weight = scale * slopes[:, None] * u[None, :]
    bias = scale * (offsets - slopes * float(u @ mean))
    with torch.no_grad():
        for pred in preds:
            out = pred.confmap_model.module.heads["ClassVectorsHead"]
            out.weight.copy_(weight.to(out.weight))
            out.bias.copy_(bias.to(out.bias))
    return cuts, margin / float(ts[-1] - ts[0])


# --------------------------------------------------------------------------- #
# Phase 3: kernels vs plain versions
# --------------------------------------------------------------------------- #


def off_boundary(maps, channels_last):
    """``maps`` copied into storage that starts one element past a 16-byte
    boundary, channels-last or channel-major (the NHWC view of NCHW)."""
    S, H, W, C = maps.shape
    store = torch.empty(maps.numel() + 1, dtype=maps.dtype, device=maps.device)[1:]
    if channels_last:
        return store.view(S, H, W, C).copy_(maps)
    return store.view(S, C, H, W).copy_(maps.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def check_global(device, gen):
    """Kernel 1 at the top-down path's shapes: 64 crops x 13 nodes of
    40 x 40 (instance maps, stride 4), float32 as the NHWC view of NCHW and
    bf16 channels-last and as that view, with integral refinement (half 2)
    and the grid peak (half -1, the rough peaks under learned offsets); then
    every case the design splits on (see the module docstring). Values and
    integer peaks exact, refined xy within XY_TOL. The extra cases draw from
    their own generator, so ``gen`` gives the later phases the same inputs as
    before they were added."""
    from sleap_tpu_torch.ops import cuda_peaks

    bf16 = torch.bfloat16
    cms = planted_maps(BATCH * MAX_INSTANCES, CROP // 4, CROP // 4, N_NODES, 2, gen, device)
    bf16_cl = cms.to(bf16).contiguous()
    g1 = torch.Generator(device=device).manual_seed(1)
    odd = planted_maps(3, 37, 41, 5, 2, g1, device)
    tied_maps = cms.clone()
    tied, want_tied = tied_map(CROP // 4, CROP // 4, device)
    tied_maps[5, :, :, 0] = tied
    nan_maps = cms.clone()
    nan_maps[7, 10, 20, 3] = float("nan")
    nan_maps[9, CROP // 4 - 1, 1, 5] = float("nan")  # in the window around (0, H)
    several = cms.clone()  # the first NaN in row-major order is (y 3, x 30)
    for y, x in ((20, 5), (3, 31), (3, 30), (39, 0)):
        several[2, y, x, 4] = float("nan")
    after_max = cms.clone()  # a NaN after the map's finite maximum
    after_max[4, 2, 2, 6] = 5.0
    after_max[4, 30, 30, 6] = float("nan")
    nan_rough = [
        ("several NaNs float32 NCHW view", several),
        ("several NaNs float32 channels-last", several.contiguous()),
        ("several NaNs bf16 channels-last", several.to(bf16).contiguous()),
        ("several NaNs bf16 NCHW view", several.to(bf16)),
        ("NaN after max float32 NCHW view", after_max),
        ("NaN after max bf16 channels-last", after_max.to(bf16).contiguous()),
        ("one NaN float32", nan_maps),
        ("one NaN bf16 channels-last", nan_maps.to(bf16).contiguous()),
    ]
    cases = [
        ("path float32 NCHW view", cms, (2, -1)),
        ("path bf16 channels-last", bf16_cl, (2, -1)),
        ("path bf16 NCHW view", cms.to(bf16), (2, -1)),
        ("single-instance bf16", planted_maps(SI_BATCH, SI_IMG // 4, SI_IMG // 4, N_NODES, 1, g1,
                                              device).to(bf16).contiguous(), (2, -1)),
        ("512^2 x 13 bf16", planted_maps(1, 512, 512, N_NODES, 4, g1, device).to(bf16).contiguous(),
         (2, -1)),
        ("37x41 float32 NCHW view", odd, (2, -1)),
        ("37x41 float32 channels-last", odd.contiguous(), (2, -1)),
        ("37x41 bf16 NCHW view", odd.to(bf16), (2, -1)),
        ("37x41 bf16 channels-last", odd.to(bf16).contiguous(), (2, -1)),
        ("float32 NCHW view off 16 B", off_boundary(odd, False), (2, -1)),
        ("bf16 channels-last off 16 B", off_boundary(odd.to(bf16).contiguous(), True), (2, -1)),
        ("17x9 bf16, empty blocks", planted_maps(2, 17, 9, 3, 1, g1, device).to(bf16).contiguous(),
         (2, -1)),
        ("channel slice", cms[..., 2:9], (2, -1)),
        ("strided slice", cms[:, 3:37, 2:39:2, 1:12], (2, -1)),
        ("ten equal maxima", tied_maps, (2, -1)),
        ("all below threshold", cms * 0.01, (2, -1)),
        ("half 1", cms, (1,)),
        ("half 3", cms, (3,)),
    ] + [(name, maps, (2, -1)) for name, maps in nan_rough]
    plans = {}
    err = 0.0
    for name, maps, halves in cases:
        for half in halves:
            plans[name] = parts = cuda_peaks.global_peaks_plan(maps, half)
            xy_k, v_k = cuda_peaks.global_peaks_cuda(maps, 0.2, half)
            xy_p, v_p = cuda_peaks.global_peaks_plain(maps, 0.2, half)
            e_xy, e_v = max_abs(xy_k, xy_p), max_abs(v_k, v_p)
            log(f"global_peaks {name} {tuple(maps.shape)} {maps.dtype} strides {maps.stride()} "
                f"{f'slab x{parts}' if parts else 'band'} half={half}: max |dxy| {e_xy:.3g}, "
                f"max |dval| {e_v:.3g}, "
                f"NaN xy {int(torch.isnan(xy_k[..., 0]).sum())}")
            check(e_v == 0.0, f"global_peaks values vs plain ({name})")
            check(e_xy <= (XY_TOL if half >= 0 else 0.0), f"global_peaks xy vs plain ({name})")
            err = max(err, e_xy, e_v)
    # Plans (blocks a map or sample; 0 for the band route) of the half -1 calls.
    check(plans["path float32 NCHW view"] == plans["path bf16 channels-last"] == 1
          and plans["single-instance bf16"] == plans["17x9 bf16, empty blocks"] == 8
          and plans["channel slice"] == 1
          and plans["512^2 x 13 bf16"] == plans["strided slice"] == 0,
          f"global_peaks plans {plans}")
    rough = cuda_peaks.global_peaks_cuda(tied_maps, 0.2, -1)[0][5, 0]
    check(rough.cpu().tolist() == want_tied[0], "global_peaks first of equal maxima")
    check(bool(torch.isnan(cuda_peaks.global_peaks_cuda(cms * 0.01, 0.2, 2)[0]).all()),
          "global_peaks below threshold")
    v_nan = cuda_peaks.global_peaks_cuda(nan_maps, 0.2, 2)[1]
    check(int(torch.isnan(v_nan).sum()) == 2, "global_peaks NaN values")
    for name, maps in nan_rough:  # the grid route: the first NaN, value NaN
        xy, v = cuda_peaks.global_peaks_cuda(maps, 0.2, -1)
        S, H, W, C = maps.shape
        flat = maps.float().permute(0, 3, 1, 2).reshape(S * C, H * W).isnan()
        has = flat.any(1)
        first = flat.int().argmax(1)[has]
        want = torch.stack([first % W, first // W], 1).float()
        got = xy.reshape(S * C, 2)[has]
        log(f"global_peaks {name} grid route: first NaNs at {want.cpu().tolist()}, "
            f"kernel {got.cpu().tolist()}")
        check(torch.equal(got, want) and bool(v.reshape(-1)[has].isnan().all())
              and int(v.isnan().sum()) == int(has.sum()), f"global_peaks first NaN ({name})")
    for dtype in (torch.float16, torch.float64):
        try:
            cuda_peaks.global_peaks_cuda(cms.to(dtype), 0.2, 2)
        except ValueError:
            continue
        check(False, f"global_peaks refuses {dtype} maps")
    return err, (cms, bf16_cl)


def tied_map(h, w, device):
    """An (h, w) map of ten equal isolated peaks, and their (x, y) in
    row-major order."""
    rows = 2 + (h // 10) * torch.arange(10, device=device)
    cols = 1 + (w // 12) * torch.arange(10, device=device)
    tied = torch.zeros(h, w, device=device)
    tied[rows, cols] = 0.5
    return tied, torch.stack([cols, rows], dim=1).tolist()


def check_local(device, gen):
    """Kernel 2 on the top-down path's 16 centroid maps of 64 x 64 and on
    every case its design splits on: a 512^2 map, 13 channels channels-last
    and as the NCHW view, H and W off the 8-row band (70 x 45), a map wider
    than 32 column tiles, K = 1 and 64 (above the peak count), ten equal
    peaks, threshold 0 and -1 (every noise maximum is a peak; the -inf border
    decides at the edges), integral windows of half 1, 2 and 3. Values and
    integer peaks exact, refined xy within XY_TOL."""
    from sleap_tpu_torch.ops import cuda_peaks

    h = IMG // 16
    path = planted_maps(BATCH, h, h, 1, 8, gen, device)  # 1024 * 0.25 / 4
    tied_path = path.clone()
    tied, want_tied = tied_map(h, h, device)
    tied_path[3, :, :, 0] = tied
    multi = planted_maps(4, h, h, N_NODES, 6, gen, device)
    cases = [
        ("path", path, MAX_INSTANCES, 0.2, (2, -1)),
        ("512^2", planted_maps(2, 512, 512, 1, 40, gen, device), 16, 0.2, (2, -1)),
        ("13ch channels-last", multi.contiguous(), 8, 0.2, (2, -1)),
        ("13ch NCHW view", multi, 8, 0.2, (2, -1)),
        ("70x45", planted_maps(3, 70, 45, 2, 6, gen, device), 8, 0.2, (2, -1)),
        ("16x9000", planted_maps(1, 16, 9000, 1, 60, gen, device), 8, 0.2, (2, -1)),
        ("K=1", path, 1, 0.2, (2, -1)),
        ("K=64", path, 64, 0.2, (2, -1)),
        ("ten equal peaks", tied_path, 12, 0.2, (-1,)),
        ("threshold 0", path, 64, 0.0, (2, -1)),
        ("threshold -1", path, 64, -1.0, (-1,)),
        ("half 1", path, MAX_INSTANCES, 0.2, (1,)),
        ("half 3", path, MAX_INSTANCES, 0.2, (3,)),
    ]
    err = 0.0
    for name, cms, K, thr, halves in cases:
        for half in halves:
            pk_k, v_k = cuda_peaks.local_peaks_cuda(cms, K, thr, half)
            pk_p, v_p = cuda_peaks.local_peaks_plain(cms, K, thr, half)
            e_xy, e_v = max_abs(pk_k, pk_p), max_abs(v_k, v_p)
            n_found = int(torch.isfinite(v_k).sum())
            log(f"local_peaks {name} {tuple(cms.shape)} K={K} threshold={thr} half={half}: "
                f"max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}, peaks {n_found}")
            check(e_v == 0.0, f"local_peaks values vs plain ({name})")
            check(e_xy <= (XY_TOL if half >= 0 else 0.0), f"local_peaks xy vs plain ({name})")
            err = max(err, e_xy, e_v)
    got = cuda_peaks.local_peaks_cuda(tied_path, 12, 0.2, -1)[0][3, 0, :10]
    check(got.cpu().tolist() == want_tied, "local_peaks tie order")
    return err, (path,)


def crop_boxes(n, size, crop, gen, device):
    """n top-left corners spread over and around a size^2 frame, the first
    eight hanging off every edge and corner."""
    top_left = torch.rand(n, 2, generator=gen, device=device) * (size + crop) - crop
    corners = torch.tensor(
        [[-100.5, 300.25], [950.75, 10.5], [400.125, -90.5], [10.0, 940.0],
         [-50.3, -60.7], [900.9, 920.1], [-170.0, 500.0], [1030.5, 1030.5]],
        device=device,
    )
    top_left[:8] = corners * (size / IMG)
    return top_left


def check_crops(device, gen):
    """Kernel 3 bitwise against its plain version: the path's 64 boxes of
    160^2 from 16 uint8 frames of 1024^2 (boxes off every edge) and the same
    boxes on float32 frames; C = 3 uint8 and float32; C = 5 and 6 (with C = 1,
    3 and 300, every C mod 4, which picks the +C taps); odd crop sizes
    (7, 5) and (161, 33); frames read through non-contiguous strides (an NCHW
    tensor viewed as NHWC, a strided slice); crop rows of more than 512 flat
    elements, so a row spans several segments ((9, 600) at C = 1 and
    (33, 257) at C = 3, wider than the frame); 300 float32 channels, whose
    window fills shared memory in bands of 14 rows; box indices -1 and B."""
    from sleap_tpu_torch.ops import cuda_crops

    images = torch.randint(0, 256, (BATCH, IMG, IMG, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    n = BATCH * MAX_INSTANCES
    top_left = crop_boxes(n, IMG, CROP, gen, device)
    box_inds = torch.arange(BATCH, device=device).repeat_interleave(MAX_INSTANCES)
    rgb_nchw = torch.randint(0, 256, (2, 3, 300, 200), generator=gen, device=device,
                             dtype=torch.uint8)
    rgb = rgb_nchw.permute(0, 2, 3, 1).contiguous()
    small_tl, small_inds = crop_boxes(12, 300, 40, gen, device), torch.arange(12, device=device) % 2
    off_inds = box_inds.clone()
    off_inds[:2] = torch.tensor([-1, BATCH], device=device)
    five = torch.rand((2, 120, 90, 5), generator=gen, device=device) * 255
    six = torch.randint(0, 256, (2, 70, 50, 6), generator=gen, device=device, dtype=torch.uint8)
    wide = torch.rand((2, 40, 30, 300), generator=gen, device=device) * 255
    cases = [
        ("path uint8", images, top_left, box_inds, (CROP, CROP)),
        ("path float32", images.float(), top_left, box_inds, (CROP, CROP)),
        ("path odd (7, 5)", images, top_left, box_inds, (7, 5)),
        ("path odd (161, 33)", images, top_left, box_inds, (161, 33)),
        ("C=3 uint8", rgb, small_tl, small_inds, (40, 24)),
        ("C=3 uint8 (7, 5)", rgb, small_tl, small_inds, (7, 5)),
        ("C=3 float32 (161, 33)", rgb.float(), small_tl, small_inds, (161, 33)),
        ("C=3 NCHW view", rgb_nchw.permute(0, 2, 3, 1), small_tl, small_inds, (40, 24)),
        ("strided slice", images[:, 1::2, ::3], small_tl, small_inds, (41, 23)),
        ("C=5 float32", five, small_tl * 0.3, small_inds, (17, 29)),
        ("C=6 uint8", six, small_tl * 0.2, small_inds, (19, 27)),
        ("segments C=1 (9, 600)", images, top_left, box_inds, (9, 600)),
        ("segments C=3 (33, 257)", rgb, small_tl, small_inds, (33, 257)),
        ("C=300 float32 (17, 9)", wide, small_tl * 0.1, small_inds, (17, 9)),
    ]
    err = 0.0
    for name, imgs, tl, inds, size in cases:
        c_k = cuda_crops.crop_unit_cuda(imgs, tl, inds, size)
        c_p = cuda_crops.crop_unit_plain(imgs, tl, inds, size)
        e = max_abs(c_k, c_p)
        log(f"crop_unit {name} {tuple(imgs.shape)} strides {imgs.stride()} -> "
            f"{tuple(c_k.shape)}: max |d| {e:.3g}")
        check(e <= CROP_TOL and torch.equal(c_k, c_p), f"crop_unit kernel vs plain ({name})")
        err = max(err, e)
    # Box indices -1 and B read zeros (the plain version would index frame -1
    # and fail on B); the other boxes of the batch are unchanged.
    c_k = cuda_crops.crop_unit_cuda(images, top_left, off_inds, (CROP, CROP))
    c_p = cuda_crops.crop_unit_plain(images, top_left[2:], off_inds[2:], (CROP, CROP))
    log(f"crop_unit box indices -1 and {BATCH}: zero crops {not c_k[:2].any()}, "
        f"the others bitwise {torch.equal(c_k[2:], c_p)}")
    check(not c_k[:2].any() and torch.equal(c_k[2:], c_p), "crop_unit box index -1 and B")
    return err, (images, top_left, box_inds)


def check_kernels(device, gen):
    """Kernels 1-3 at the top-down path's shapes and the cases their designs
    split on."""
    return {
        "global_peaks": check_global(device, gen),
        "local_peaks": check_local(device, gen),
        "crop_unit": check_crops(device, gen),
    }


def path_head_maps(pred, frames):
    """The bottom-up module's bf16 confidence maps (channels-last) on the
    card, and its head outputs, for the given frames."""
    from sleap_tpu_torch.inference.predictors import _preprocess
    from sleap_tpu_torch.models.model import find_head

    tm = pred.bottomup_model
    with torch.inference_mode():
        imgs = torch.from_numpy(frames).to(pred.device)
        heads = tm.module(_preprocess(imgs, tm.grayscale, tm.input_scale, tm.pad_to_stride))
    return heads[find_head(heads, "MultiInstanceConfmapsHead")], heads


def check_hwcs(device, gen, path_maps):
    """Kernel 4 against its plain version on every layout and size the
    design distinguishes; returns (max error, the path maps)."""
    from sleap_tpu_torch.ops import cuda_peaks

    h = IMG // BU_CM_STRIDE
    maps = planted_maps(BATCH, h, h, N_NODES, 12, gen, device)  # NHWC view of NCHW
    tied, want_tied = tied_map(h, h, device)
    maps[0, :, :, 0] = tied  # ten equal isolated peaks: the first eight by index win
    nchw_view = maps.to(torch.bfloat16)
    channels_last = nchw_view.contiguous()
    # The bf16 top-down centroid maps (16 x 64^2 x 1, channels-last), from
    # their own generator so that ``gen`` gives the cases below as before.
    g1 = torch.Generator(device=device).manual_seed(1)
    centroids = planted_maps(BATCH, IMG // 16, IMG // 16, 1, 8, g1, device).to(torch.bfloat16)
    cases = [
        ("channels-last", channels_last, BU_K),
        ("NCHW view", nchw_view, BU_K),
        ("path maps", path_maps, BU_K),
        ("H=250", planted_maps(4, 250, h, N_NODES, 12, gen, device).to(torch.bfloat16).contiguous(), BU_K),
        ("16x100^2x3", planted_maps(16, 100, 100, 3, 12, gen, device).to(torch.bfloat16).contiguous(), BU_K),
        ("K=1", channels_last, 1),
        ("K=16", path_maps, 16),
        ("K=64", path_maps, 64),
        ("16x64^2x1 top-down centroids", centroids.contiguous(), MAX_INSTANCES),
    ]
    err = 0.0
    for name, cms, K in cases:
        fast = cuda_peaks.hwcs_fast_rows(cms)
        for half in (HWCS_HALF, -1):
            pk_k, v_k = cuda_peaks.local_peaks_hwcs_cuda(cms, K, 0.2, half)
            pk_p, v_p = cuda_peaks.local_peaks_hwcs_plain(cms, K, 0.2, half)
            e_xy, e_v = max_abs(pk_k, pk_p), max_abs(v_k, v_p)
            log(f"local_peaks_hwcs {name} {tuple(cms.shape)} K={K} refine={half >= 0} "
                f"fast rows={fast}: max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}, "
                f"peaks {int(torch.isfinite(v_k).sum())}")
            check(e_v == 0.0, f"local_peaks_hwcs values vs plain ({name})")
            check(e_xy <= (XY_TOL if half >= 0 else 0.0), f"local_peaks_hwcs xy vs plain ({name})")
            err = max(err, e_xy, e_v)
    check(cuda_peaks.hwcs_fast_rows(path_maps), "the path's maps take the 16-byte row copies")
    got = cuda_peaks.local_peaks_hwcs_cuda(channels_last, BU_K, 0.2, -1)[0][0, 0]
    check(got.cpu().tolist() == want_tied[:BU_K], "local_peaks_hwcs tie order")
    return err, (path_maps,)


# --------------------------------------------------------------------------- #
# Phases 4 and 4b: the paths
# --------------------------------------------------------------------------- #


def merged(examples, n):
    """Concatenate per-batch outputs, trimmed to the n valid frames."""
    keys = ("instance_peaks", "instance_peak_vals", "centroids", "centroid_vals", "centroid_mask")
    return {k: np.concatenate([ex[k][:ex["n_valid"]] for ex in examples])[:n] for k in keys}


def frames_instances(examples):
    """Bottom-up: per-frame (points, values, scores) of the valid frames."""
    keys = ("instance_peaks", "instance_peak_vals", "instance_scores")
    return [tuple(ex[k][i] for k in keys) for ex in examples for i in range(ex["n_valid"])]


def run_path(name, pred, frames, wrappers, batch=BATCH):
    """Warm up on one batch, zero the launch counts, predict the rest of
    the frames; return (outputs, launches, FPS)."""
    pred.predict(frames[:batch], make_labels=False)  # warm-up: cuDNN plans, library
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = pred.predict(frames[batch:], make_labels=False)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    n_frames = len(frames) - batch
    fps = n_frames / path_s
    log(f"{name} path: {n_frames} frames in {path_s:.3f} s = {fps:.1f} FPS; launches {launches}")
    n_batches = -(-n_frames // batch)
    for k, count in launches.items():
        check(count == n_batches, f"{k}: {count} launches on the {name} path, want one per batch")
    return out, launches, fps


def check_labels(name, pred, frames, want_counts):
    """One batch with ``make_labels=True``: the port's Labels, one frame per
    input frame, the example dicts' instance counts."""
    from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
    from sleap_tpu_torch.core.labels import Labels

    labels = pred.predict(frames)
    check(type(labels) is Labels, f"{name}: predict returns the port's Labels")
    check([lf.frame_idx for lf in labels] == list(range(len(frames))), f"{name}: frame indices")
    check(all(type(lf) is LabeledFrame for lf in labels), f"{name}: labeled frames")
    got = [len(lf.instances) for lf in labels]
    insts = [i for lf in labels for i in lf.instances]
    check(all(type(i) is PredictedInstance and i.numpy().shape == (N_NODES, 2) for i in insts),
          f"{name}: predicted instances of {N_NODES} nodes")
    log(f"{name} labels: {len(labels)} frames, {sum(got)} instances (example dicts: "
        f"{sum(want_counts)})")
    check(got == want_counts, f"{name}: Labels hold the example dicts' instances")


def check_topdown_outputs(name, pred, frames, out):
    """Shapes and finite values of a top-down run, and one batch with
    ``Labels`` on the first timed batch's frames."""
    n_frames = len(frames) - BATCH
    res = merged(out, n_frames)
    check(res["instance_peaks"].shape == (n_frames, MAX_INSTANCES, N_NODES, 2), "peaks shape")
    check(res["centroids"].shape == (n_frames, MAX_INSTANCES, 2), "centroids shape")
    check(res["centroid_mask"].any(), f"{name}: centroids found")
    check(np.isfinite(res["centroids"][res["centroid_mask"]]).all(), "finite centroids")
    check(np.isfinite(res["instance_peak_vals"]).all(), "finite peak values")
    log(f"{name}: centroids found: {int(res['centroid_mask'].sum())} of "
        f"{res['centroid_mask'].size}; instance points: "
        f"{int(np.isfinite(res['instance_peaks'][..., 0]).sum())}")
    first = merged(out[:1], BATCH)
    want = [int(sum(m and not np.isnan(p).all() for m, p in zip(mask, pts)))
            for mask, pts in zip(first["centroid_mask"], first["instance_peaks"])]
    check_labels(name, pred, frames[BATCH:2 * BATCH], want)


def check_topdown(gpu_pred, cpu_pred, frames, out):
    check_topdown_outputs("top-down", gpu_pred, frames, out)

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


def head_maps(module, head, fn):
    """Call ``fn`` with a forward hook on ``module``; return the ``head``
    output of the module's last call."""
    from sleap_tpu_torch.models.model import find_head

    seen = []
    handle = module.register_forward_hook(lambda mod, inputs, outputs: seen.append(outputs))
    try:
        fn()
    finally:
        handle.remove()
    return seen[-1][find_head(seen[-1], head)]


def check_card_maps(name, maps, slab=True):
    """The card's bf16 maps of one batch through kernel 1 and, on the CPU,
    through the plain version: values exact, xy within XY_TOL. With
    ``slab``, the maps must take the slab route."""
    from sleap_tpu_torch.ops import cuda_peaks
    from sleap_tpu_torch.ops.peak_finding import find_global_peaks

    parts = cuda_peaks.global_peaks_plan(maps, 2)
    check(maps.dtype == torch.bfloat16 and maps.is_contiguous() and (parts > 0 or not slab),
          f"{name}: bf16 channels-last maps ({parts} blocks a sample on the slab route, 0: band)")
    xy_k, v_k = find_global_peaks(maps, 0.2, "integral")
    xy_p, v_p = find_global_peaks(maps.cpu(), 0.2, "integral")
    e_xy, e_v = max_abs(xy_k, xy_p), max_abs(v_k, v_p)
    log(f"{name}: the card's bf16 maps {tuple(maps.shape)}, kernel 1 vs plain on the CPU: "
        f"max |dxy| {e_xy:.3g}, max |dval| {e_v:.3g}, peaks {int(torch.isfinite(xy_k[..., 0]).sum())}")
    check(e_v == 0.0 and e_xy <= XY_TOL, f"{name}: card maps, kernel vs plain on the CPU")


def check_topdown_bf16(pred, frames, out):
    check_topdown_outputs("top-down bf16", pred, frames, out)
    maps = head_maps(pred.confmap_model.module, "CenteredInstanceConfmapsHead",
                     lambda: pred.predict(frames[BATCH:2 * BATCH], make_labels=False))
    check(maps.shape == (BATCH * MAX_INSTANCES, CROP // 4, CROP // 4, N_NODES), "instance maps")
    check_card_maps("top-down bf16", maps)


def check_single(pred, frames, out):
    n_frames = len(frames) - SI_BATCH
    peaks = np.concatenate([ex["instance_peaks"][:ex["n_valid"]] for ex in out])
    vals = np.concatenate([ex["instance_peak_vals"][:ex["n_valid"]] for ex in out])
    check(peaks.shape == (n_frames, N_NODES, 2) and vals.shape == (n_frames, N_NODES),
          "single-instance shapes")
    check(np.isfinite(vals).all() and np.isfinite(peaks).any(), "single-instance values")
    log(f"single-instance bf16: {int(np.isfinite(peaks[..., 0]).sum())} of {peaks[..., 0].size} "
        f"points above threshold")
    want = [int(not np.isnan(p).all()) for p in peaks[:SI_BATCH]]
    check_labels("single-instance bf16", pred, frames[SI_BATCH:2 * SI_BATCH], want)
    maps = head_maps(pred.confmap_model.module, "SingleInstanceConfmapsHead",
                     lambda: pred.predict(frames[SI_BATCH:2 * SI_BATCH], make_labels=False))
    check(maps.shape == (SI_BATCH, SI_IMG // 4, SI_IMG // 4, N_NODES), "single-instance maps")
    check_card_maps("single-instance bf16", maps)


def check_bottomup(preds, frames, out, heads):
    """The bottom-up path's outputs: shapes, assembled instances, Labels,
    the card's bf16 maps grouped on the CPU, and float32 GPU vs CPU on 4
    frames."""
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

    want = [int(sum(not np.isnan(q).all() for q in p)) for p, _, _ in per_frame[:BATCH]]
    check_labels("bottom-up", bf16_pred, frames[BATCH:2 * BATCH], want)

    # The card's bf16 head outputs (of frames[:4]) grouped on the card and on the CPU.
    with torch.inference_mode():
        four = {k: v[:4] for k, v in heads.items()}
        g = {k: v.cpu() for k, v in bf16_pred.group_heads(four).items()}
        c = bf16_pred.group_heads({k: v.cpu() for k, v in four.items()})
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


# --------------------------------------------------------------------------- #
# Phases 4e, 4f and 4g: multiclass and the trained folders
# --------------------------------------------------------------------------- #

MC_KEYS = ("points", "point_vals", "class_probs")


def merged_mc(examples, n):
    return {k: np.concatenate([ex[k][:ex["n_valid"]] for ex in examples])[:n] for k in MC_KEYS}


def check_mc_labels(name, pred, frames, points):
    """One batch with ``Labels``: the 4 class tracks, one instance per class
    that has a point, each on its class's track."""
    from sleap_tpu_torch.core.labels import Labels

    labels = pred.predict(frames)
    check(type(labels) is Labels, f"{name}: predict returns the port's Labels")
    check([t.name for t in labels.tracks] == CLASSES, f"{name}: tracks {labels.tracks}")
    got = [[labels.tracks.index(i.track) for i in lf.instances] for lf in labels]
    want = [[c for c in range(len(CLASSES)) if not np.isnan(p[c]).all()] for p in points]
    insts = [i for lf in labels for i in lf.instances]
    log(f"{name} labels: {len(labels)} frames, {len(insts)} instances on tracks "
        f"{sorted({i.track.name for i in insts})}, tracking scores "
        f"{[round(i.tracking_score, 4) for i in insts[:4]]}")
    check(got == want, f"{name}: one instance per class with points")
    check(all(np.isfinite(i.tracking_score) for i in insts), f"{name}: tracking scores")


def check_mc_outputs(name, pred, frames, out, min_classes=1):
    """The path's outputs: shapes, instances found, finite probabilities
    and values at the points, at least ``min_classes`` classes in every
    frame; then one batch with ``Labels``."""
    n_frames = len(frames) - BATCH
    res = merged_mc(out, n_frames)
    check(res["points"].shape == (n_frames, len(CLASSES), N_NODES, 2), f"{name}: points shape")
    check(res["class_probs"].shape == (n_frames, len(CLASSES), N_NODES), f"{name}: probs shape")
    found = ~np.isnan(res["points"][..., 0]).all(-1)
    check(found.any(), f"{name}: instances found")
    points = np.isfinite(res["points"][..., 0])
    check(np.isfinite(res["class_probs"][points]).all() and np.isfinite(res["point_vals"][points]).all(),
          f"{name}: class probabilities and values where the points are")
    per_frame = found.sum(1)
    log(f"{name}: {int(found.sum())} instances over {n_frames} frames, classes "
        f"{found.sum(0).tolist()}, frames with 1-4 classes "
        f"{[int((per_frame == k).sum()) for k in range(1, len(CLASSES) + 1)]}")
    check(per_frame.min() >= min_classes, f"{name}: at least {min_classes} classes in every frame")
    check_mc_labels(name, pred, frames[BATCH:2 * BATCH], merged_mc(out[:1], BATCH)["points"])


def check_topdown_mc(gpu_pred, cpu_pred, frames, out):
    check_mc_outputs("top-down multiclass", gpu_pred, frames, out, min_classes=2)
    small = frames[:4]
    g = merged_mc(dataclasses.replace(gpu_pred, batch_size=4).predict(small, make_labels=False), 4)
    c = merged_mc(cpu_pred.predict(small, make_labels=False), 4)
    d = {k: max_abs(torch.from_numpy(g[k]), torch.from_numpy(c[k])) for k in MC_KEYS}
    log(f"top-down multiclass GPU vs CPU (batch 4): {d}; instances "
        f"{int((~np.isnan(g['points'][..., 0]).all(-1)).sum())}")
    check(d["points"] <= PATH_XY_TOL and d["point_vals"] <= PATH_VAL_TOL
          and d["class_probs"] <= PROB_TOL, "top-down multiclass GPU vs CPU")


def module_heads(tm, device, frames):
    """A trained model's head outputs on ``frames``, on ``device``."""
    from sleap_tpu_torch.inference.predictors import _preprocess

    with torch.inference_mode():
        imgs = torch.from_numpy(frames).to(device)
        return tm.module(_preprocess(imgs, tm.grayscale, tm.input_scale, tm.pad_to_stride))


def check_bottomup_mc(pred, frames, out):
    check_mc_outputs("bottom-up multiclass bf16", pred, frames, out)
    heads = module_heads(pred.model, pred.device, frames[:4])
    check(all(v.dtype == torch.bfloat16 for v in heads.values()), "bf16 head outputs")
    with torch.inference_mode():
        g = {k: v.cpu() for k, v in pred.classify_heads(heads).items()}
        c = pred.classify_heads({k: v.cpu() for k, v in heads.items()})
    d = {k: max_abs(g[k], c[k]) for k in MC_KEYS}
    log(f"bottom-up multiclass, the card's bf16 maps classified on the card and on the CPU: "
        f"{d}; points {int(torch.isfinite(g['points'][..., 0]).sum())}")
    check(d["points"] <= BU_XY_TOL and d["point_vals"] == 0.0 and d["class_probs"] == 0.0,
          "bottom-up multiclass: card maps, kernel vs plain on the CPU")


def outputs_diff(g, c):
    """Largest |GPU - CPU| over the point keys and over the value keys of
    two runs' example dicts (arrays, or per-frame lists of arrays)."""
    d_xy = d_val = 0.0
    for eg, ec in zip(g, c):
        for k, vg in eg.items():
            if k in ("image", "video_ind", "frame_ind", "n_valid"):
                continue
            vc = ec[k]
            pairs = zip(vg, vc) if isinstance(vg, list) else [(vg, vc)]
            for a, b in pairs:
                check(np.shape(a) == np.shape(b), f"{k}: GPU {np.shape(a)} vs CPU {np.shape(b)}")
                if a.dtype == bool:
                    check(np.array_equal(a, b), f"{k}: GPU vs CPU masks")
                    continue
                e = max_abs(torch.from_numpy(np.asarray(a, np.float32)),
                            torch.from_numpy(np.asarray(b, np.float32)))
                if "peaks" in k or k in ("centroids", "points"):
                    d_xy = max(d_xy, e)
                else:
                    d_val = max(d_val, e)
    return d_xy, d_val


def check_trained_folders(wrappers, launches):
    """Phase 4g: each trained folder on the card and on the CPU, weights
    read from its checkpoint; returns the checkpoints' read times."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io.orbax import read_params

    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".convergence_runs")
    read_s = {}
    for name, folders, size in TRAINED:
        paths = [os.path.join(runs, f) for f in folders]
        for f, path in zip(folders, paths):
            if f not in read_s:
                t0 = time.perf_counter()
                tree = read_params(os.path.join(path, "best_model.ckpt"))
                read_s[f] = time.perf_counter() - t0
                n = sum(a.size for layer in tree.values() for w in layer.values()
                        for a in (w.values() if isinstance(w, dict) else [w]))
                log(f"read {f}/best_model.ckpt: {n} parameters in {read_s[f]:.3f} s")
        frames = synthetic_frames(4, seed=0, size=size, blobs=TRAINED_BLOBS, sigma=TRAINED_SIGMA)
        gpu = sleap_tpu_torch.load_model(paths, batch_size=4, peak_threshold=0.05)
        cpu = sleap_tpu_torch.load_model(paths, device="cpu", batch_size=4, peak_threshold=0.05)
        check(gpu.device.type == "cuda", f"{name}: on the card")
        gpu.predict(frames, make_labels=False)  # warm-up
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        g = gpu.predict(frames, make_labels=False)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items() if w.launches}
        for kernel, count in counts.items():
            launches[kernel][name] = count
        c = cpu.predict(frames, make_labels=False)
        d_xy, d_val = outputs_diff(g, c)
        labels = gpu.predict(frames)
        insts = [i for lf in labels for i in lf.instances]
        per_frame = [len(lf.instances) for lf in labels]
        n_points = sum(int(np.isfinite(i.numpy()).all(-1).sum()) for i in insts)
        tracks = sorted({i.track.name for i in insts if i.track is not None})
        log(f"{name} ({type(gpu).__name__}, {size}^2): launches {counts}; GPU vs CPU max |dxy| "
            f"{d_xy:.3g}, max |dval| {d_val:.3g}; instances per frame {per_frame}, "
            f"{n_points} finite points, tracks {tracks}")
        check(counts, f"{name}: the kernels ran")
        check(len(labels) == len(frames) and min(per_frame) >= 1
              and all(np.isfinite(i.numpy()).all(-1).any() for i in insts),
              f"{name}: an animal with finite points in every frame")
        if labels.tracks:
            want = gpu.confmap_model.classes
            check([t.name for t in labels.tracks] == want and tracks == sorted(want),
                  f"{name}: an instance of every class")
        check(d_xy <= PATH_XY_TOL and d_val <= PATH_VAL_TOL, f"{name}: GPU vs CPU")
    return read_s


# --------------------------------------------------------------------------- #
# Phase 6: tracking
# --------------------------------------------------------------------------- #


def blob_paths(n, size, layout, reach, seed, max_step=TRACK_MAX_STEP) -> np.ndarray:
    """(n, blobs, 2) xy: each blob on a Lissajous path of seeded periods and
    phases around its centre (``layout``, fractions of ``size``) within
    ``reach`` px per axis, slowed so that no step exceeds ``max_step`` px."""
    rng = np.random.default_rng(seed)
    centres = np.asarray(layout, np.float64) * size
    period = rng.uniform(60, 100, centres.shape)
    phase = rng.uniform(0, 2 * np.pi, centres.shape)
    t = np.arange(n)[:, None, None]
    offsets = np.asarray(reach) * np.sin(2 * np.pi * t / period + phase)
    step = np.linalg.norm(np.diff(offsets, axis=0), axis=-1).max()
    return centres + offsets * min(1.0, max_step / step)


def moving_frames(paths, size, sigma, amplitude, seed, static=False) -> np.ndarray:
    """(n, size, size, 1) uint8: seeded noise (one background for all
    frames if ``static``, else fresh each frame) plus a Gaussian blob of
    ``sigma`` px at each path point."""
    rng = np.random.default_rng(seed)
    background = rng.integers(0, 40, (size, size)).astype(np.float32)
    r = int(3 * sigma) + 1
    frames = np.empty((len(paths), size, size, 1), np.uint8)
    for i, points in enumerate(paths):
        img = background.copy() if static else rng.integers(0, 40, (size, size)).astype(np.float32)
        for x, y in points:
            x0, y0 = int(round(x)) - r, int(round(y)) - r
            yy, xx = np.mgrid[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1]
            blob = amplitude * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * sigma**2))
            img[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1] += blob
        frames[i, ..., 0] = np.clip(img, 0, 255)
    return frames


def untracked_copies(labels, n):
    """The first n labeled frames of ``labels`` as new frames over a new
    video of their images, holding untracked copies of their instances."""
    from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
    from sleap_tpu_torch.io.video import Video

    frames = list(labels)[:n]
    video = Video.from_numpy(np.stack([lf.image for lf in frames]))
    return [LabeledFrame(video, k, [PredictedInstance(i.skeleton, i.points.copy(), i.score)
                                    for i in lf.instances]) for k, lf in enumerate(frames)]


def check_tracked_path(pred, frames, wrappers, launches, fps, card):
    """Phase 6a; returns the tracked ``Labels`` and the figures it prints."""
    from sleap_tpu_torch.tracking import tracker as trk

    check(type(pred.tracker).__name__ == "Tracker" and pred.tracker.uses_image, "a flow tracker")
    maker = pred.tracker.candidate_maker
    check((type(maker).__name__, maker.of_window_size, maker.of_max_levels, maker.img_scale,
           pred.tracker.track_window, pred.tracker.similarity_function.__name__,
           pred.tracker.matching_function.__name__)
          == ("FlowCandidateMaker", 21, 3, 1.0, 5, "instance_similarity", "greedy_matching"),
          "the tracker keeps the CLI defaults")
    check(torch.device(maker.device).type == "cuda", "flow on the card")
    pred.predict(frames[:BATCH], make_labels=False)  # warm-up; the tracker runs only with Labels
    torch.cuda.synchronize()

    flow = trk.lk_flow_pyramids
    devices, last_call, track_s = [], [], []

    def lk(*args, **kwargs):
        out = flow(*args, **kwargs)
        devices.append({t.device.type for t in out})
        last_call[:] = [args, kwargs]
        return out

    track = pred.tracker.track

    def timed_track(*args, **kwargs):
        t0 = time.perf_counter()
        out = track(*args, **kwargs)
        track_s.append(time.perf_counter() - t0)
        return out

    for w in wrappers.values():
        w.launches = 0
    trk.lk_flow_pyramids, pred.tracker.track = lk, timed_track
    try:
        t0 = time.perf_counter()
        labels = pred.predict(frames[BATCH:])
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
    finally:
        trk.lk_flow_pyramids = flow
        del pred.tracker.track
    counts = {k: w.launches for k, w in wrappers.items()}
    n_frames = len(frames) - BATCH
    n_batches = -(-n_frames // BATCH)
    for kernel, count in counts.items():
        check(count == n_batches, f"{kernel}: {count} launches on the tracked path, want one a batch")
        launches[kernel]["top-down tracked"] = count
    insts = [i for lf in labels for i in lf.instances]
    check(len(labels) == n_frames and len(insts) >= n_frames, "tracked frames with instances")
    check(all(i.track is not None for i in insts), "every instance has a track")
    check(len(devices) >= n_frames - 1 and all(d == {"cuda"} for d in devices),
          f"flow ran on the card in every frame ({len(devices)} calls)")
    fps["top-down tracked"] = n_frames / path_s
    host_ms = 1e3 * sum(track_s) / len(track_s)

    # The flow's device time and launches a call, on the last frame's inputs
    # (all the window's pairs, one call a frame).
    args, kwargs = last_call
    events = repeated_events(lambda: flow(*args, **kwargs))
    flow_ms = sum(e.self_device_time_total for e in events) / 1e3
    flow_launches = sum(e.count for e in events)
    flow_wall = time_ms(lambda: flow(*args, **kwargs), iters=10, warmup=1)
    pairs, points = args[2].shape[:2]

    # Every device launch of the tracker a frame (upload, pyramid, flow):
    # a fresh tracker fills its window on 5 frames, then each profiled call
    # tracks the next frame.
    tracker = trk.Tracker.make_tracker_by_name(tracker="flow")
    copies = iter(untracked_copies(labels, 16))

    def track_next():
        lf = next(copies)
        tracker.track(lf.instances, img=lf.image, t=lf.frame_idx)

    for _ in range(5):
        track_next()
    frame_launches = sum(e.count for e in repeated_events(track_next, tries=10))
    tracks = {i.track.name for i in insts}
    log(f"top-down tracked path: {n_frames} frames in {path_s:.3f} s = "
        f"{fps['top-down tracked']:.1f} FPS with tracking (phase 4 without: "
        f"{fps['top-down']:.1f}); kernel launches {counts}; {len(insts)} instances, "
        f"{len(tracks)} tracks; tracker host {host_ms:.2f} ms a frame; lk_flow on "
        f"{pairs} pairs x {points} points: {flow_ms:.3f} ms device, {flow_wall:.3f} ms per call, "
        f"{flow_launches:.0f} launches a call ({len(devices)} calls, one a frame); tracker "
        f"{frame_launches:.0f} device launches a frame ({card})")
    figures = {"fps": fps["top-down tracked"], "fps_untracked": fps["top-down"],
               "tracker_host_ms_per_frame": host_ms, "lk_flow_device_ms": flow_ms,
               "lk_flow_ms": flow_wall, "lk_flow_launches": flow_launches,
               "tracker_launches_per_frame": frame_launches, "pairs": pairs, "points": points}
    return labels, figures


def check_tracking_card_vs_cpu(labels):
    """Phase 6b: the card's instances of the first CARD_CPU_FRAMES tracked
    frames, tracked anew on the card and on the CPU."""
    from sleap_tpu_torch.tracking.tracker import Tracker, run_tracker

    runs = {}
    for device in ("cuda", "cpu"):
        tracker = Tracker.make_tracker_by_name(tracker="flow", save_shifted_instances=True,
                                               device=device)
        frames = untracked_copies(labels, CARD_CPU_FRAMES)
        t0 = time.perf_counter()
        run_tracker(frames, tracker)
        runs[device] = (frames, tracker.candidate_maker.shifted_instances,
                        time.perf_counter() - t0)
    (gf, gs, g_s), (cf, cs, c_s) = runs["cuda"], runs["cpu"]
    names = lambda fs: [[i.track.name for i in lf.instances] for lf in fs]  # noqa: E731
    check(names(gf) == names(cf), "card and CPU trackers: the same track per instance")
    d_score = max(abs(a.tracking_score - b.tracking_score)
                  for lg, lc in zip(gf, cf) for a, b in zip(lg.instances, lc.instances))
    check(d_score <= TRACK_SCORE_TOL, f"tracking scores differ by {d_score:.3g}")
    check(list(gs) == list(cs) and len(gs) > 0, "the same frame pairs shifted")
    d_xy, n_shifted = 0.0, 0
    for key in gs:
        check([s.track.name for s in gs[key]] == [s.track.name for s in cs[key]],
              f"pair {key}: the same shifted instances")
        for a, b in zip(gs[key], cs[key]):
            d_xy = max(d_xy, max_abs(torch.from_numpy(a.points_array),
                                     torch.from_numpy(b.points_array)))  # NaN = status 0
            n_shifted += 1
    check(d_xy <= SHIFT_TOL, f"shifted points differ by {d_xy:.3g} px")
    log(f"tracking card vs CPU on {CARD_CPU_FRAMES} frames: same tracks "
        f"({len(set(sum(names(gf), [])))}), max |d score| {d_score:.3g}, {n_shifted} shifted "
        f"instances with the same status, max |dxy| {d_xy:.3g} px; card {g_s:.2f} s, CPU {c_s:.2f} s")


def check_tracking_trained():
    """Phase 6c: flow, simple and Kalman tracking of the trained top-down
    pair on two blobs whose paths stay TRACKED_GAP px apart."""
    import sleap_tpu_torch
    from sleap_tpu_torch.tracking.tracker import Tracker

    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".convergence_runs")
    paths = [os.path.join(runs, f) for f in TRACKED_TRAINED]
    xy = blob_paths(TRACKED_FRAMES, TRACKED_SIZE, [[0.27, 0.5], [0.73, 0.5]], [40.0, 110.0],
                    seed=0, max_step=3.0)
    check(np.linalg.norm(xy[:, 0] - xy[:, 1], axis=-1).min() > TRACKED_GAP, "blobs stay apart")
    clips = {"flow on sigma-14 blobs over fresh noise":
             moving_frames(xy, TRACKED_SIZE, TRAINED_SIGMA, 200.0, seed=0)}
    frames = moving_frames(xy, TRACKED_SIZE, TRACKED_SIGMA, TRACKED_AMPLITUDE, seed=0, static=True)
    clips.update({route: frames for route in ("flow", "simple", "kalman")})
    for route, frames in clips.items():
        pred = sleap_tpu_torch.load_model(paths, batch_size=4, peak_threshold=0.05, max_instances=2,
                                          tracker="simple" if route == "simple" else "flow")
        check(pred.device.type == "cuda", "on the card")
        if route == "kalman":
            pred.tracker = Tracker.make_tracker_by_name(
                tracker="flow", max_tracks=2, kf_init_frame_count=5, kf_node_indices=[0, 1],
                device=pred.device)
        labels = pred.predict(frames)
        blob_of, clean = {}, 0
        for lf in labels:
            near = {i.track.name if i.track else None: int(np.argmin(np.linalg.norm(
                xy[lf.frame_idx] - np.nanmean(i.numpy(), axis=0), axis=-1))) for i in lf.instances}
            if len(lf.instances) == 2 and len(set(near.values())) == 2:
                clean += 1
                for name, b in near.items():
                    blob_of.setdefault(name, set()).add(b)
        insts = [i for lf in labels for i in lf.instances]
        n_tracked = sum(i.track is not None for i in insts)
        swaps = sum(len(b) - 1 for b in blob_of.values())
        log(f"trained top-down tracked ({route}, {TRACKED_SIZE}^2, {TRACKED_FRAMES} frames): "
            f"tracks {[t.name for t in labels.tracks]}, {n_tracked} of {len(insts)} instances "
            f"tracked, {clean} frames with one instance on each blob, blobs per track "
            f"{ {k: sorted(v) for k, v in blob_of.items()} }")
        if route not in ("flow", "simple", "kalman"):
            continue  # the sigma-14 clip: printed, not checked
        check(len(labels.tracks) == 2, f"{route}: exactly 2 tracks")
        if route == "flow":
            check(n_tracked == len(insts) and len(insts) >= TRACKED_FRAMES,
                  "flow: every instance tracked")
            check(clean >= TRACKED_MIN_CLEAN, f"flow: {clean} frames with one instance per blob")
            check(swaps == 0 and None not in blob_of, "flow: no identity swap")


# --------------------------------------------------------------------------- #
# Phase 8: sleap-track, from a .slp on disk to a .slp on disk
# --------------------------------------------------------------------------- #


def cli_run(args, wrappers):
    """``sleap_tpu_torch.cli.track.main(args)`` with every kernel's count
    zeroed first; returns (seconds, launches)."""
    from sleap_tpu_torch.cli import track

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    track.main(args)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k: w.launches for k, w in wrappers.items()}


def compare_predictions(got, want, xy_tol, val_tol, what):
    """Two predicted ``Labels``: the same frames, instance counts, visible
    points and track names; points and scores within the tolerances.
    Returns (max |dxy|, max |dscore|)."""
    check([lf.frame_idx for lf in got] == [lf.frame_idx for lf in want], f"{what}: the same frames")
    d_xy = d_val = 0.0
    for a, b in zip(got, want):
        check(len(a.instances) == len(b.instances), f"{what}: instances in frame {a.frame_idx}")
        for x, y in zip(a.instances, b.instances):
            px, py = x.numpy(), y.numpy()
            check(np.array_equal(np.isnan(px), np.isnan(py)), f"{what}: the same visible points")
            d_xy = max(d_xy, float(np.abs(np.nan_to_num(px - py)).max()))
            d_val = max(d_val, abs(x.score - y.score),
                        float(np.abs(x.points["score"] - y.points["score"]).max()))
            check((x.track and x.track.name) == (y.track and y.track.name), f"{what}: tracks")
    check(d_xy <= xy_tol and d_val <= val_tol,
          f"{what}: max |dxy| {d_xy:.3g} (tolerance {xy_tol}), max |dscore| {d_val:.3g} ({val_tol})")
    return d_xy, d_val


def check_cli_full_width(td, wrappers, launches, card):
    """Phase 8a: a 1024^2 clip written as .slp, tracked by the CLI on phase
    4's float32 top-down folders, against ``load_model(..., tracker="flow")``
    in this process; returns the figures it prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.core.instance import LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io.slp import read_labels, write_labels
    from sleap_tpu_torch.io.video import Video

    xy = blob_paths(CLI_FRAMES, IMG, [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                    [150.0, 150.0], seed=8)
    frames = moving_frames(xy, IMG, 8.0, 200.0, seed=8)
    with tempfile.TemporaryDirectory() as root:
        folders = write_run_folders(root)
        paths = [folders["centroid"], folders["instance"]]
        for path, tm in zip(paths, (td.centroid_model, td.confmap_model)):
            torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                       os.path.join(path, "best_model.pt"))
        clip, out = os.path.join(root, "clip.slp"), os.path.join(root, "clip.predictions.slp")
        t0 = time.perf_counter()
        write_labels(clip, Labels([LabeledFrame(Video.from_numpy(frames), i)
                                   for i in range(CLI_FRAMES)]))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        source = read_labels(clip)
        read_frames = np.stack([lf.image for lf in source])
        read_s = time.perf_counter() - t0
        check(np.array_equal(read_frames, frames), "8a: the .slp holds the frames")

        pred = sleap_tpu_torch.load_model(paths, batch_size=BATCH, max_instances=MAX_INSTANCES,
                                          tracker="flow")
        pred.predict(frames[:BATCH], make_labels=False)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = pred.predict(frames)
        torch.cuda.synchronize()
        inproc_s = time.perf_counter() - t0
        cli_s, counts = cli_run([clip, "-m", paths[0], "-m", paths[1], "--tracking.tracker", "flow",
                                 "--batch_size", str(BATCH), "--max_instances", str(MAX_INSTANCES),
                                 "--verbosity", "none", "-o", out], wrappers)
        t0 = time.perf_counter()
        got = read_labels(out)
        out_read_s = time.perf_counter() - t0
        out_mb = os.path.getsize(out) / 1e6
    n_batches = -(-CLI_FRAMES // BATCH)
    for kernel, count in counts.items():
        check(count == n_batches, f"8a: {kernel} launched {count} times by the CLI, want one a batch")
        launches[kernel]["CLI top-down tracked (8a)"] = count
    insts = [i for lf in got for i in lf.instances]
    check(len(got) == CLI_FRAMES and len(insts) >= CLI_FRAMES, "8a: frames with instances")
    check(all(i.track is not None for i in insts), "8a: every instance tracked")
    d_xy, d_val = compare_predictions(got, want, CLI_TOL, CLI_TOL, "8a: CLI vs in-process")
    figures = {"frames": CLI_FRAMES, "write_s": write_s, "read_s": read_s,
               "output_read_s": out_read_s, "output_mb": out_mb, "cli_s": cli_s,
               "cli_fps": CLI_FRAMES / cli_s, "in_process_tracked_fps": CLI_FRAMES / inproc_s,
               "max_abs_dxy": d_xy, "max_abs_dscore": d_val, "launches": counts}
    log(f"8a CLI on a .slp of {CLI_FRAMES} frames of {IMG}^2: write {write_s:.3f} s, read with "
        f"frames {read_s:.3f} s; CLI end to end (read, predict, track, write) {cli_s:.3f} s = "
        f"{CLI_FRAMES / cli_s:.1f} FPS; in-process tracked {CLI_FRAMES / inproc_s:.1f} FPS; output "
        f"{out_mb:.2f} MB read in {out_read_s:.3f} s; {len(insts)} instances, launches {counts}; "
        f"vs in-process max |dxy| {d_xy:.3g}, max |dscore| {d_val:.3g} ({card})")
    return figures


def check_cli_fixtures(wrappers, launches, card):
    """Phase 8b: the CLI on the committed fixtures with the trained folders
    (the top-down pair, each of its models alone, bottom-up in float32 and
    bf16) on the card, against the same CLI with ``--cpu`` (bf16: against
    ``load_model`` in this process); returns the figures it prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io import hdf5, png
    from sleap_tpu_torch.io.slp import read_labels

    here = os.path.dirname(os.path.abspath(__file__))
    runs, data = os.path.join(here, ".convergence_runs"), os.path.join(here, *FIXTURE_DIR)
    centroid, instance, bottomup = (os.path.join(runs, f) for f in CLI_TRAINED)
    common = ["--peak_threshold", "0.05", "--batch_size", "4", "--verbosity", "none"]
    cases = [
        ("trained top-down pair", "raw.slp", ["-m", centroid, "-m", instance]),
        ("ground-truth centroids", "pkg.slp", ["-m", instance]),
        ("centroid only", "raw.slp", ["-m", centroid]),
        ("trained bottom-up", "pkg.slp", ["-m", bottomup]),
        ("trained bottom-up bf16", "raw.slp", ["-m", bottomup, "--compute_dtype", "bfloat16"]),
    ]
    launched, figures = set(), {}
    with tempfile.TemporaryDirectory() as root:
        for k, (name, fixture, models) in enumerate(cases):
            src, out = os.path.join(data, fixture), os.path.join(root, f"{k}.slp")
            seconds, counts = cli_run([src, *models, *common, "-o", out], wrappers)
            got = read_labels(out)
            for kernel, count in counts.items():
                if count:
                    launched.add(kernel)
                    launches[kernel][f"CLI {name} (8b)"] = count
            if "bf16" in name:
                pred = sleap_tpu_torch.load_model(bottomup, batch_size=4, peak_threshold=0.05,
                                                  compute_dtype=torch.bfloat16)
                d = compare_predictions(got, pred.predict(src), BU_XY_TOL, VAL_TOL,
                                        f"8b {name}: CLI vs in-process")
            else:
                cpu_out = os.path.join(root, f"{k}.cpu.slp")
                cli_run([src, *models, *common, "--cpu", "-o", cpu_out], wrappers)
                d = compare_predictions(got, read_labels(cpu_out), PATH_XY_TOL, PATH_VAL_TOL,
                                        f"8b {name}: GPU vs CPU")
            n_inst = [len(lf.instances) for lf in got]
            check(len(got) == 8 and sum(n_inst) >= 8, f"8b {name}: 8 frames with instances")
            if name == "ground-truth centroids":
                users = [len(lf.user_instances) for lf in read_labels(src)]
                check(n_inst == users, f"8b {name}: one instance per user instance")
            figures[name] = {"seconds": seconds, "launches": counts, "instances": n_inst,
                             "max_abs_dxy": d[0], "max_abs_dscore": d[1]}
            log(f"8b CLI {name} on {fixture}: {seconds:.3f} s, instances {n_inst}, launches "
                f"{counts}; max |dxy| {d[0]:.3g}, max |dscore| {d[1]:.3g}")
    check(launched == set(wrappers), f"8b: the CLI runs launched {sorted(launched)}")

    # Embedded PNG frames: the package's rows read and decoded.
    video = read_labels(os.path.join(data, "pkg.slp")).video
    video.get_frame(0)
    t0 = time.perf_counter()
    for i in range(video.num_frames):
        video.get_frame(i)
    frame_ms = 1e3 * (time.perf_counter() - t0) / video.num_frames
    with hdf5.File(os.path.join(data, "pkg.slp")) as f:
        rows = [f["video0/video"][i].tobytes() for i in range(f["video0/video"].shape[0])]
    t0 = time.perf_counter()
    for row in rows:
        png.imdecode(row)
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(rows)
    figures["png"] = {"frame_ms": frame_ms, "decode_ms": decode_ms}
    log(f"8b pkg.slp PNG frames (384^2 gray, rows in all five filters): {frame_ms:.3f} ms a "
        f"frame read and decoded, {decode_ms:.3f} ms a frame to decode ({card})")

    # The wavefront route at full size: Average, Paeth and mixed rows.
    sys.path.insert(0, os.path.join(here, "scripts"))
    import png_decode_time

    img = png_decode_time.frame(IMG)
    for name in ("average", "paeth", "mixed"):
        data = png_decode_time.encode(img, png_decode_time.FILTERS.index(name))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = png.decode(data)
            times.append(time.perf_counter() - t0)
        check(np.array_equal(out[..., 0], img), f"8b: the {name} PNG at {IMG}^2 decodes exactly")
        figures["png"][f"{name}_{IMG}_ms"] = 1e3 * float(np.median(times))
    log(f"8b PNG decode at {IMG}^2, median of 3 (ms a frame): " + ", ".join(
        f"{n} {figures['png'][f'{n}_{IMG}_ms']:.2f}" for n in ("average", "paeth", "mixed"))
        + f" ({card})")
    return figures


# --------------------------------------------------------------------------- #
# Phase 7: training
# --------------------------------------------------------------------------- #


def chain_skeleton():
    from sleap_tpu_torch.core.skeleton import Skeleton

    skeleton = Skeleton("chain13")
    names = [f"n{i}" for i in range(N_NODES)]
    for n in names:
        skeleton.add_node(n)
    for a, b in zip(names[:-1], names[1:]):
        skeleton.add_edge(a, b)
    return skeleton


def train_config(head, filters=64, crop=CROP, input_scaling=1.0, lr=1e-4, batch=TRAIN_BATCH):
    """``bench.py``'s training config (``_train_throughput``): the UNet of
    the inference folders, confmaps at stride 4 and sigma 2.5, PAFs at
    stride 8 and sigma 5; ``head`` is "topdown", "centroid" or "bottomup"."""
    from sleap_tpu_torch import config as c

    cfg = c.TrainingJobConfig()
    cfg.model.backbone.unet = c.UNetConfig(max_stride=16, output_stride=4, filters=filters,
                                           filters_rate=2.0, up_interpolate=True, space_to_depth=4)
    names = [f"n{i}" for i in range(N_NODES)]
    if head == "topdown":
        cfg.model.heads.centered_instance = c.CenteredInstanceConfmapsHeadConfig(
            part_names=names, output_stride=4, sigma=2.5)
    elif head == "centroid":
        cfg.model.heads.centroid = c.CentroidsHeadConfig(output_stride=4, sigma=2.5)
    else:
        cfg.model.heads.multi_instance = c.MultiInstanceConfig(
            confmaps=c.MultiInstanceConfmapsHeadConfig(part_names=names, output_stride=4,
                                                       sigma=2.5),
            pafs=c.PartAffinityFieldsHeadConfig(
                edges=[[f"n{i}", f"n{i + 1}"] for i in range(N_NODES - 1)], output_stride=8,
                sigma=5.0))
    cfg.data.preprocessing.pad_to_stride = 16
    cfg.data.preprocessing.input_scaling = input_scaling
    cfg.data.instance_cropping.crop_size = crop
    cfg.optimization.batch_size = batch
    cfg.optimization.initial_learning_rate = lr
    cfg.outputs.save_outputs = False
    return cfg


def labels_of(frames, points):
    """The port's Labels: ``frames`` (n, H, W, 1) uint8 and ``points``
    (n, animals, N_NODES, 2) user instances."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io.video import Video

    skeleton, video = chain_skeleton(), Video.from_numpy(frames)
    return Labels([LabeledFrame(video, i, [Instance(skeleton, p) for p in pts])
                   for i, pts in enumerate(points)])


def bench_trainer(head, mixed_precision=False):
    """A trainer of ``bench.py``'s config on the card (the default device),
    set up on its 4 labeled frames of 3 instances."""
    from sleap_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (4, IMG, IMG, 1), np.uint8)
    labels = labels_of(frames, rng.uniform(100, IMG - 100, (4, 3, N_NODES, 2)))
    cfg = train_config(head)
    cfg.optimization.mixed_precision = mixed_precision
    trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels)
    check(trainer.device.type == "cuda", f"train {head}: the trainer's default device is the card")
    trainer.setup()
    trainer.make_optimizer()
    return trainer


def bench_batch(head, device, seed=0, size=IMG, batch=TRAIN_BATCH, animals=3):
    """``bench.py``'s device batch: random uint8 frames, ``animals``
    instances at uniform points 100 px inside, a random target instance
    (top-down)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {
        "image": torch.randint(0, 255, (batch, size, size, 1), generator=gen, device=device,
                               dtype=torch.uint8),
        "instances": 100 + (size - 200) * torch.rand(batch, animals, N_NODES, 2, generator=gen,
                                                      device=device),
        "track_inds": torch.zeros(batch, animals, dtype=torch.int32, device=device),
    }
    if head == "topdown":
        out["ctr_ind"] = torch.randint(0, animals, (batch,), generator=gen, device=device,
                                       dtype=torch.int32)
    return out


def time_train_steps(name, trainer, batch, card, steps=TRAIN_STEPS):
    """Warm-up steps, then ``steps`` timed steps ending in a synchronise;
    one step's device time and launches from ``torch.profiler``. Images/s
    counts the batch's frames."""
    n_images = len(batch["image"])
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_step(batch, gen) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    events = repeated_events(lambda: trainer.train_step(batch, gen))
    device_step_ms = sum(e.self_device_time_total for e in events) / 1e3
    res = {
        "images_per_s": n_images * 1e3 / step_ms,
        "step_ms": step_ms,
        "device_step_ms": device_step_ms,
        "device_busy": device_step_ms / step_ms,
        "launches_per_step": sum(e.count for e in events),
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]),
        # The step's largest device functions: (name, ms, launches).
        "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in sorted(
            events, key=lambda e: -e.self_device_time_total)[:6]],
    }
    check(all(bool(torch.isfinite(l)) for l in losses), f"{name}: finite losses")
    log(f"{name}: {res['images_per_s']:.1f} images/s, {step_ms:.2f} ms a step over {steps} "
        f"steps (batch {n_images}); device {device_step_ms:.2f} ms a step "
        f"({100 * res['device_busy']:.1f} % busy), {res['launches_per_step']} launches a step; "
        f"peak memory {res['max_memory_gib']:.2f} GiB; loss {res['first_loss']:.6f} -> "
        f"{res['last_loss']:.6f} ({card})")
    log(f"{name}: largest device functions a step (name, ms, launches): {res['top_kernels']}")
    return res


def check_train_throughput(card):
    """7a, 7b and 7e: ``bench.py``'s train cells on the card."""
    results = {}
    for key, head, mixed in (("7a train top-down f32", "topdown", False),
                             ("7b train bottom-up f32", "bottomup", False),
                             ("7e train top-down mixed precision", "topdown", True)):
        trainer = bench_trainer(head, mixed_precision=mixed)
        batch = bench_batch(head, trainer.device)
        results[key] = time_train_steps(key, trainer, batch, card)
        if mixed:
            params = list(trainer.module.parameters())
            check(all(p.dtype == torch.float32 for p in params), "7e: float32 parameters")
            check(all(t.dtype == torch.float32 for st in trainer.optimizer.state.values()
                      for t in st.values() if torch.is_tensor(t) and t.ndim > 0),
                  "7e: float32 optimizer state")
        del trainer, batch
        torch.cuda.empty_cache()
    return results


def blob_animals(n, seed, size=IMG, margin=PAIR_MARGIN, gap=PAIR_GAP, sigma=PAIR_SIGMA,
                 radius=PAIR_RING, animals=PAIR_ANIMALS):
    """(frames, points): ``n`` uint8 frames of ``animals`` blobs (sigma
    ``sigma`` px, over noise, centres ``gap`` px apart and ``margin`` px
    inside), each an animal whose 13 nodes lie on its blob, on a ring of
    ``radius`` px around the centre at fixed angles."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 40, (n, size, size, 1)).astype(np.float32)
    angles = 2 * np.pi * np.arange(N_NODES) / N_NODES
    ring = radius * np.stack([np.cos(angles), np.sin(angles)], -1)
    r = int(3 * sigma)
    g = np.mgrid[-r:r + 1, -r:r + 1]
    blob = 200 * np.exp(-(g[0] ** 2 + g[1] ** 2) / (2 * sigma**2))
    points = np.zeros((n, animals, N_NODES, 2))
    for i in range(n):
        centres = []
        while len(centres) < animals:
            c = rng.integers(margin, size - margin, 2)
            if all(np.hypot(*(c - d)) >= gap for d in centres):
                centres.append(c)
        for a, (x, y) in enumerate(centres):
            frames[i, y - r:y + r + 1, x - r:x + r + 1, 0] += blob
            points[i, a] = ring + (x, y)
    return np.clip(frames, 0, 255).astype(np.uint8), points


def pair_errors(out, points):
    """Per true animal, the mean node distance of the nearest predicted
    instance (inf where a frame found none)."""
    res = merged(out, len(points))
    errs = []
    for i, truth in enumerate(points):
        found = res["instance_peaks"][i][res["centroid_mask"][i]]
        for animal in truth:
            d = [np.nanmean(np.linalg.norm(f - animal, axis=-1)) for f in found]
            d = [v for v in d if np.isfinite(v)]
            errs.append(min(d) if d else np.inf)
    return np.asarray(errs)


def check_train_pair(card, wrappers, launches):
    """7c: the top-down pair trained on blob frames for a fixed number of
    steps; the run folders loaded with no params (``best_model.pt``) and
    the held-out frames predicted on the card and on the CPU."""
    import sleap_tpu_torch
    from sleap_tpu_torch.training.trainer import Trainer

    frames, points = blob_animals(PAIR_TRAIN_FRAMES + PAIR_HELD_OUT, seed=7)
    labels = labels_of(frames[:PAIR_TRAIN_FRAMES], points[:PAIR_TRAIN_FRAMES])
    held_frames, held_points = frames[PAIR_TRAIN_FRAMES:], points[PAIR_TRAIN_FRAMES:]
    res, folders = {}, []
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    for head, scaling in (("centroid", 0.25), ("topdown", 1.0)):
        cfg = train_config(head, input_scaling=scaling, lr=PAIR_LR)
        cfg.optimization.epochs = PAIR_EPOCHS
        cfg.optimization.batches_per_epoch = PAIR_BATCHES
        cfg.optimization.val_batches_per_epoch = 1
        cfg.outputs.save_outputs = True
        cfg.outputs.runs_folder = root
        cfg.outputs.run_name = head
        trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels)
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        losses = [row["loss"] for row in trainer.log_rows]
        steps = PAIR_EPOCHS * PAIR_BATCHES
        res[head] = {"epoch_losses": losses, "train_s": train_s, "steps": steps,
                     "images_per_s": steps * TRAIN_BATCH / train_s}
        log(f"7c trained {head} ({steps} steps of {TRAIN_BATCH}, input scale {scaling}): epoch "
            f"losses {[round(v, 6) for v in losses]}; {train_s:.1f} s, "
            f"{res[head]['images_per_s']:.1f} images/s with validation and checkpoints ({card})")
        check(losses[-1] <= 0.5 * losses[0], f"7c {head}: last epoch loss at most half the first")
        folder = os.path.join(root, head)
        check(os.path.exists(os.path.join(folder, "best_model.pt")), f"7c {head}: best_model.pt")
        folders.append(folder)
        del trainer
    gpu = sleap_tpu_torch.load_model(folders, batch_size=BATCH, max_instances=MAX_INSTANCES)
    cpu = sleap_tpu_torch.load_model(folders, device="cpu", batch_size=4,
                                     max_instances=MAX_INSTANCES)
    check(gpu.device.type == "cuda", "7c: the trained pair loads on the card")
    out, counts, fps = run_path("7c trained top-down pair", gpu, held_frames, wrappers)
    for kernel, n in counts.items():
        launches[kernel]["trained top-down pair (7c)"] = n
    errs = pair_errors(out, held_points[BATCH:])
    res["held_out_node_error_px"] = {"median": float(np.median(errs)),
                                     "max": float(errs.max()), "animals": len(errs)}
    log(f"7c held-out localisation: {len(errs)} animals, mean node error median "
        f"{np.median(errs):.3f} px, max {errs.max():.3f} px (bound {PAIR_BOUND_PX} px); "
        f"{fps:.1f} FPS ({card})")
    check(np.isfinite(errs).all() and errs.max() <= PAIR_BOUND_PX,
          f"7c: every held-out animal found within {PAIR_BOUND_PX} px")
    g = merged(dataclasses.replace(gpu, batch_size=4).predict(held_frames[:4],
                                                             make_labels=False), 4)
    c = merged(cpu.predict(held_frames[:4], make_labels=False), 4)
    check(np.array_equal(g["centroid_mask"], c["centroid_mask"]), "7c: GPU vs CPU centroid masks")
    d = {k: max_abs(torch.from_numpy(g[k]), torch.from_numpy(c[k]))
         for k in ("centroids", "instance_peaks", "centroid_vals", "instance_peak_vals")}
    log(f"7c GPU vs CPU (batch 4): {d}")
    check(d["centroids"] <= PATH_XY_TOL and d["instance_peaks"] <= PATH_XY_TOL,
          "7c: GPU vs CPU points")
    check(d["centroid_vals"] <= PATH_VAL_TOL and d["instance_peak_vals"] <= PATH_VAL_TOL,
          "7c: GPU vs CPU values")
    shutil.rmtree(root, ignore_errors=True)
    return res


def check_step_card_vs_cpu(card):
    """7d: one step's loss and gradients on the card and on the CPU, from
    the same initial weights and batch, for a small top-down and bottom-up
    config (float32, TF32 off)."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.training.trainer import Trainer

    frames, points = blob_animals(4, seed=9, size=STEP_SIZE, margin=40, gap=60)
    labels = labels_of(frames, points)
    res = {}
    for head in ("topdown", "bottomup"):
        text = train_config(head, filters=STEP_FILTERS, crop=STEP_CROP, batch=4).to_json()
        on_card, on_cpu = (Trainer.from_config(TrainingJobConfig.from_json(text),
                                               training_labels=labels, validation_labels=labels,
                                               device=d)
                           for d in ("cuda", "cpu"))
        for t in (on_card, on_cpu):
            t.setup()
        check(all(torch.equal(a.cpu(), b) for a, b in zip(on_card.module.state_dict().values(),
                                                          on_cpu.module.state_dict().values())),
              f"7d {head}: the same initial weights on both devices")
        examples = [on_cpu._train_examples[i] for i in range(4)]
        grads, losses = [], []
        for t in (on_card, on_cpu):
            t.module.zero_grad()
            loss = t.compute_loss(t.to_device(t.make_batch(examples, None)),
                                  torch.Generator(device=t.device).manual_seed(0))
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({n: p.grad.detach().cpu() for n, p in t.module.named_parameters()})
        loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
        grad_rel = max(float((grads[0][n] - g).abs().max() / g.abs().max())
                       for n, g in grads[1].items())
        res[head] = {"loss_rel": loss_rel, "grad_rel": grad_rel, "loss": losses[1]}
        log(f"7d {head} step card vs CPU ({STEP_SIZE}^2, filters {STEP_FILTERS}): loss "
            f"{losses[0]:.8f} vs {losses[1]:.8f} (rel {loss_rel:.2e}); largest gradient "
            f"difference {grad_rel:.2e} of that gradient's largest value ({card})")
        check(loss_rel <= STEP_LOSS_RTOL, f"7d {head}: loss within {STEP_LOSS_RTOL} relative")
        check(grad_rel <= STEP_GRAD_RTOL, f"7d {head}: gradients within {STEP_GRAD_RTOL} relative")
    return res


# --------------------------------------------------------------------------- #
# Phase 9: sleap-train from .slp to scored run folders
# --------------------------------------------------------------------------- #


def write_cli_project(root):
    """9a's project in ``root``: two HDF5 videos (IMG^2 and TRAIN_CLI_SMALL^2
    frames of blob animals, the small video's drawn to its scale) and the
    ``.slp`` of their user instances, written by the port's writers. Returns
    the ``.slp`` path."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io import hdf5
    from sleap_tpu_torch.io.slp import write_labels
    from sleap_tpu_torch.io.video import Video

    skeleton, lfs = chain_skeleton(), []
    for k, size in enumerate((IMG, TRAIN_CLI_SMALL)):
        f = size / IMG
        frames, points = blob_animals(TRAIN_CLI_FRAMES, seed=9 + k, size=size,
                                      margin=int(PAIR_MARGIN * f), gap=PAIR_GAP * f,
                                      sigma=TRAIN_CLI_SIGMA * f, radius=TRAIN_CLI_RING * f)
        path = os.path.join(root, f"video{k}_{size}.h5")
        with hdf5.Writer(path) as h5:
            h5.create_dataset("video", data=frames)
        video = Video.from_filename(path, dataset="video")
        lfs += [LabeledFrame(video, i, [Instance(skeleton, p) for p in pts])
                for i, pts in enumerate(points)]
    project = os.path.join(root, "two_sizes.slp")
    write_labels(project, Labels(lfs))
    return project


def cut_profile(name, root):
    """The port's copy of the shipped profile ``name`` with phase 9's cuts
    and ``root`` as its runs folder, written to ``root``; returns its path
    and the config dict."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "sleap_tpu_torch", "training_profiles", name)) as f:
        cfg = json.load(f)
    cfg["optimization"].update(epochs=TRAIN_CLI_EPOCHS, batches_per_epoch=TRAIN_CLI_BATCHES,
                               val_batches_per_epoch=TRAIN_CLI_VAL_BATCHES,
                               initial_learning_rate=TRAIN_CLI_LR)
    cfg["outputs"]["runs_folder"] = root
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path, cfg


def train_with_cli(profile, project, run_name, wrappers, flags=()):
    """``cli.train.main([profile, project, ...])`` with every kernel's count
    zeroed first, the trainer's setup and each evaluation timed; returns
    (seconds, setup seconds, launches, evaluations), an evaluation being its
    split, seconds, launches and metrics."""
    from sleap_tpu_torch import evals
    from sleap_tpu_torch.cli import train as cli_train
    from sleap_tpu_torch.training.trainer import Trainer

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    original, evaluations = evals.evaluate_model, []
    setup, setup_s = Trainer.setup, []

    def timed_setup(self):
        t0 = time.perf_counter()
        setup(self)
        sync()
        setup_s.append(time.perf_counter() - t0)

    def timed(cfg, labels, model_dir, **kwargs):
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.perf_counter()
        out = original(cfg, labels, model_dir, **kwargs)
        sync()
        evaluations.append({"split": kwargs.get("split_name"), "seconds": time.perf_counter() - t0,
                            "launches": {k: w.launches - before[k] for k, w in wrappers.items()},
                            "metrics": out[1]})
        return out

    for w in wrappers.values():
        w.launches = 0
    evals.evaluate_model, Trainer.setup = timed, timed_setup
    t0 = time.perf_counter()
    try:
        cli_train.main([profile, project, "--run_name", run_name, *flags])
        sync()
    finally:
        evals.evaluate_model, Trainer.setup = original, setup
    return (time.perf_counter() - t0, sum(setup_s), {k: w.launches for k, w in wrappers.items()},
            evaluations)


def same_metrics(got, want, what):
    """Two metrics dicts with the same keys and equal values (NaN equal)."""
    check(sorted(got) == sorted(want), f"{what}: the same metric names")
    for key, value in want.items():
        other = got[key]
        if isinstance(value, (list, tuple)):
            same = list(other) == list(value)
        else:
            a, b = np.asarray(other), np.asarray(value)
            same = a.shape == b.shape and bool(np.all((a == b) | (a != a) & (b != b)))
        check(same, f"{what}: {key} equal")


def metric_line(metrics):
    return ", ".join(f"{k} {float(metrics[k]):.4f}" for k in (
        "oks.mOKS", "oks_voc.mAP", "dist.avg", "dist.p50", "dist.p90", "pck.mPCK"))


def animal_errors(found, truth):
    """Per ground-truth animal (user instances of ``truth``), the mean node
    distance of the nearest instance of the same frame in ``found`` (inf
    where there is none)."""
    by_frame = {(os.path.basename(lf.video.filename), lf.frame_idx): lf for lf in found}
    errs = []
    for lf in truth:
        pred = by_frame.get((os.path.basename(lf.video.filename), lf.frame_idx))
        cands = [i.numpy() for i in pred.instances] if pred is not None else []
        for inst in lf.user_instances:
            d = [np.nanmean(np.linalg.norm(c - inst.numpy(), axis=-1)) for c in cands]
            d = [v for v in d if np.isfinite(v)]
            errs.append(min(d) if d else np.inf)
    return np.asarray(errs)


def check_sleap_train(card, wrappers, launches):
    """Phase 9: 9a trains both profiles through the CLI on the two-size
    project and checks the scored run folders, the evaluations' kernels and
    predictions against the CPU, and ``sleap-track`` of the pair; 9b runs
    ``sleap-inspect`` on a run folder and on the project."""
    import contextlib
    import io

    from sleap_tpu_torch import evals, load_metrics
    from sleap_tpu_torch.info import labels as info
    from sleap_tpu_torch.io.slp import read_labels

    want_kernels = {"centroid": {"local_peaks"}, "instance": {"crop_unit", "global_peaks"}}
    files = ["best_model.pt", "training_config.json", "training_log.csv"] + [
        f"{kind}.{split}.{ext}" for kind, ext in (("labels_gt", "slp"), ("labels_pr", "slp"),
                                                  ("metrics", "npz"))
        for split in ("train", "val")]
    res, folders = {}, {}
    root = tempfile.mkdtemp(prefix="chip_smoke_sleap_train_")
    try:
        t0 = time.perf_counter()
        project = write_cli_project(root)
        res["project_write_s"] = time.perf_counter() - t0
        for name, profile in TRAIN_CLI_PROFILES:
            path, cfg = cut_profile(profile, root)
            total_s, setup_s, counts, evaluations = train_with_cli(path, project, name, wrappers)
            folder = folders[name] = os.path.join(root, name)
            missing = [f for f in files if not os.path.exists(os.path.join(folder, f))]
            check(not missing, f"9a {name}: the run folder lacks {missing}")
            check([e["split"] for e in evaluations] == ["train", "val"],
                  f"9a {name}: both splits evaluated")
            launched = {k for k, n in counts.items() if n}
            check(launched == want_kernels[name],
                  f"9a {name}: the evaluations launched {sorted(launched)}, want "
                  f"{sorted(want_kernels[name])}")
            for kernel, n in counts.items():
                if n:
                    launches[kernel][f"sleap-train {name} evaluation (9a)"] = n
            for ev in evaluations:
                split = ev["split"]
                saved = load_metrics(folder, split=split)
                same_metrics(saved, ev["metrics"], f"9a {name} {split}: saved metrics")
                gt = read_labels(os.path.join(folder, f"labels_gt.{split}.slp"))
                pr = read_labels(os.path.join(folder, f"labels_pr.{split}.slp"))
                same_metrics(evals.evaluate(gt, pr), saved,
                             f"9a {name} {split}: evaluate of the saved labels")
            # The card's validation predictions against the same folder on the CPU.
            gt_val = read_labels(os.path.join(folder, "labels_gt.val.slp"))
            cpu_pr, _ = evals.evaluate_model(None, gt_val, folder, save=False, device="cpu")
            card_pr = read_labels(os.path.join(folder, "labels_pr.val.slp"))
            d = compare_predictions(card_pr, cpu_pr, PATH_XY_TOL, PATH_VAL_TOL,
                                    f"9a {name}: card vs CPU evaluation predictions")
            eval_s = sum(e["seconds"] for e in evaluations)
            train_s = total_s - setup_s - eval_s
            opt = cfg["optimization"]
            with open(os.path.join(folder, "training_log.csv")) as f:
                rows = list(csv.DictReader(f))
            with open(os.path.join(folder, "training_config.json")) as f:
                crop = json.load(f)["data"]["instance_cropping"]["crop_size"]
            # Early stopping may end the run before its last epoch.
            images = len(rows) * TRAIN_CLI_BATCHES * opt["batch_size"]
            res[name] = {
                "cli_s": total_s, "setup_s": setup_s, "train_s": train_s, "evaluation_s": eval_s,
                "images_per_s": images / train_s, "images": images, "crop_size": crop,
                "epoch_losses": [float(r["loss"]) for r in rows],
                "evaluations": [{k: e[k] for k in ("split", "seconds", "launches")} | {
                    "metrics": {k: float(e["metrics"][k]) for k in (
                        "oks.mOKS", "oks_voc.mAP", "dist.avg", "dist.p50", "dist.p90",
                        "pck.mPCK")}} for e in evaluations],
                "card_vs_cpu": {"max_abs_dxy": d[0], "max_abs_dscore": d[1]},
            }
            log(f"9a sleap-train {profile} ({opt['batch_size']} a batch, {len(rows)} of "
                f"{TRAIN_CLI_EPOCHS} epochs of {TRAIN_CLI_BATCHES} batches, learning rate "
                f"{TRAIN_CLI_LR}, crop size {crop}): CLI {total_s:.2f} s = setup (frames read and "
                f"size-matched, "
                f"model built) {setup_s:.2f} s + training {train_s:.2f} s "
                f"({res[name]['images_per_s']:.1f} images/s with validation and checkpoints) + "
                f"evaluation {eval_s:.2f} s; epoch losses "
                f"{[round(float(r['loss']), 6) for r in rows]} ({card})")
            for e in evaluations:
                log(f"9a {name} evaluation ({e['split']}): {e['seconds']:.3f} s, launches "
                    f"{e['launches']}; {metric_line(e['metrics'])} ({card})")
            log(f"9a {name}: card vs CPU evaluation predictions max |dxy| {d[0]:.3g}, "
                f"max |dscore| {d[1]:.3g}")
        val = res["instance"]["evaluations"][1]["metrics"]
        check(val["dist.p50"] <= TRAIN_CLI_P50_PX, f"9a instance: validation dist.p50 "
              f"{val['dist.p50']:.3f} px, bound {TRAIN_CLI_P50_PX}")
        check(val["oks_voc.mAP"] >= TRAIN_CLI_MAP, f"9a instance: validation oks_voc.mAP "
              f"{val['oks_voc.mAP']:.3f}, bound {TRAIN_CLI_MAP}")

        # sleap-track of the trained pair on the validation frames.
        val_path = os.path.join(folders["instance"], "labels_gt.val.slp")
        out = os.path.join(root, "val.predictions.slp")
        track_s, counts = cli_run([val_path, "-m", folders["centroid"], "-m", folders["instance"],
                                   "--verbosity", "none", "-o", out], wrappers)
        for kernel, n in counts.items():
            check(n > 0, f"9a sleap-track: {kernel} launched {n} times")
            launches[kernel]["sleap-track trained pair (9a)"] = n
        truth = read_labels(val_path)
        errs = animal_errors(read_labels(out), truth)
        res["track"] = {"seconds": track_s, "frames": len(truth), "animals": len(errs),
                        "median_px": float(np.median(errs)), "max_px": float(errs.max()),
                        "launches": counts}
        log(f"9a sleap-track of the trained pair on {len(truth)} validation frames: "
            f"{track_s:.3f} s; {len(errs)} animals, mean node error median "
            f"{np.median(errs):.3f} px, max {errs.max():.3f} px (bound {TRAIN_CLI_TRACK_PX} px); "
            f"launches {counts} ({card})")
        check(np.isfinite(errs).all() and errs.max() <= TRAIN_CLI_TRACK_PX,
              f"9a sleap-track: every validation animal found within {TRAIN_CLI_TRACK_PX} px")

        # 9b: sleap-inspect on a run folder and on the project.
        printed = {}
        for key, path in (("folder", folders["instance"]), ("project", project)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                info.main([path])
            printed[key] = buf.getvalue().splitlines()
        with open(os.path.join(folders["instance"], "training_log.csv")) as f:
            rows = list(csv.DictReader(f))
        best = min(rows, key=lambda r: float(r["val_loss"]))
        want = [f"Model: {folders['instance']}", "  backbone: unet", "  head: centered_instance",
                f"  skeleton nodes: {[f'n{i}' for i in range(N_NODES)]}",
                f"  epochs trained: {len(rows)}",
                f"  best val_loss: {best['val_loss']} (epoch {best['epoch']})"]
        check(printed["folder"] == want, f"9b sleap-inspect of the run folder: {printed['folder']}")
        lines = printed["project"]
        check(lines[:3] == [f"Labeled frames: {2 * TRAIN_CLI_FRAMES}", "Tracks: 0",
                            "Video files: 2"], f"9b sleap-inspect of the project: {lines[:3]}")
        check(sum(f"    labeled frames: {TRAIN_CLI_FRAMES} (user: {TRAIN_CLI_FRAMES})" == l
                  for l in lines) == 2, "9b sleap-inspect: each video's frames")
        log(f"9b sleap-inspect: {printed['folder']}; {lines[:6]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


# --------------------------------------------------------------------------- #
# Phase 10: the other backbones at full width, and TF32 in a fresh process
# --------------------------------------------------------------------------- #


def backbone_specs():
    """Phase 10's and 11's backbones at their configs' defaults: name ->
    (backbone config, head output stride)."""
    from sleap_tpu_torch import config as c

    resnet50 = c.PretrainedEncoderConfig(encoder="resnet50", pretrained=False)
    effnet = c.PretrainedEncoderConfig(encoder="efficientnetb0", pretrained=False)
    return {
        "pretrained-encoder ResNet-50": ({"pretrained_encoder": resnet50}, resnet50.output_stride),
        "resnet ResNet50": ({"resnet": c.ResNetConfig(weights="random")},
                            c.ResNetConfig().output_stride),
        "Hourglass": ({"hourglass": c.HourglassConfig()}, c.HourglassConfig().output_stride),
        "HRNet": ({"hrnet": c.HRNetConfig()}, 2),
        "LEAP": ({"leap": c.LEAPConfig()}, c.LEAPConfig().output_stride),
        "pretrained-encoder EfficientNet-b0": ({"pretrained_encoder": effnet},
                                               effnet.output_stride),
    }


# Phase 10's top-down backbones (the others are single-instance there).
TOPDOWN_BACKBONES = ("pretrained-encoder ResNet-50", "resnet ResNet50")


def backbone_config(name, topdown):
    """A config of backbone ``name``: a centered-instance head on crops of
    CROP (``topdown``) or a single-instance head; confmaps of sigma 2.5;
    the chain skeleton of 13 nodes."""
    from sleap_tpu_torch import config as c

    backbone, stride = backbone_specs()[name]
    heads = (c.HeadsConfig(centered_instance=c.CenteredInstanceConfmapsHeadConfig(
        output_stride=stride, sigma=2.5)) if topdown
        else c.HeadsConfig(single_instance=c.SingleInstanceConfmapsHeadConfig(
            output_stride=stride, sigma=2.5)))
    return c.TrainingJobConfig(
        data=c.DataConfig(labels=c.LabelsConfig(skeletons=[chain_skeleton()]),
                          instance_cropping=c.InstanceCroppingConfig(
                              crop_size=CROP if topdown else None)),
        model=c.ModelConfig(backbone=c.BackboneConfig(**backbone), heads=heads),
    )


def backbone_folders(root, centroid):
    """Phase 10's run folders, at each backbone config's defaults: the
    centered-instance models of 10a (pretrained-encoder ResNet-50) and 10b
    (``resnet`` ResNet50), each paired with phase 4's ``centroid`` folder,
    and 10c's single-instance models. 13 nodes; crops of CROP."""
    folders = {}
    for name in backbone_specs():
        topdown = name in TOPDOWN_BACKBONES
        path = os.path.join(root, name.replace(" ", "_"))
        os.makedirs(path)
        backbone_config(name, topdown).save_json(os.path.join(path, "training_config.json"))
        folders[name] = [centroid, path] if topdown else [path]
    return folders


def lsuv_variables(path, sample, gen, device):
    """Seeded weights for a run folder, as the flax variables ``load_model``
    takes: He-normal kernels, heads non-negative (maps cross the threshold),
    batch-norm running means N(0, 0.1^2) and variances U(0.5, 2) drawn from
    ``gen``; then every conv's kernel and bias scaled, in one forward on
    ``sample`` on the card, so that its output has unit standard deviation
    there (layer-sequential unit variance, Mishkin & Matas 2016): with
    statistics that do not normalise, activations would otherwise grow or
    shrink geometrically through 50-160 layers."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d
    from sleap_tpu_torch.models.model import Model, init_params
    from sleap_tpu_torch.models.params import flax_variables_from_state_dict

    cfg = TrainingJobConfig.load_json(path)
    net = Model.from_config(cfg.model, skeleton=cfg.data.labels.skeletons[0]).make_module(1)
    init_params(net, gen)
    convs = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FlaxBatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
        for head in net.heads.values():
            head.weight.abs_()

    def unit_std(module, inputs, output):
        std = float(output.std())
        if std > 0:
            module.weight.div_(std)
            if module.bias is not None:
                module.bias.div_(std)
            return output / std
        return output

    net.to(device).eval()
    hooks = [m.register_forward_hook(unit_std) for m in convs]
    try:
        with torch.no_grad():
            net(torch.from_numpy(sample).to(device))
    finally:
        for h in hooks:
            h.remove()
    stats = flax_variables_from_state_dict(net)
    check(bool(stats["batch_stats"]) == any(isinstance(m, FlaxBatchNorm2d)
                                            for m in net.modules()), f"{path}: batch_stats")
    return stats


def device_ms_per_batch(pred, batch_frames) -> float:
    """Device time of one ``predict`` batch (``torch.profiler``, the sum of
    its device functions' self time, from two sessions that agree)."""
    events = repeated_events(lambda: pred.predict(batch_frames, make_labels=False))
    return sum(e.self_device_time_total for e in events) / 1e3


def card_vs_cpu(name, gpu, cpu, frames, keys, point_keys):
    """The same folder on the card and on the CPU over ``frames``: equal
    masks and NaN patterns, points within PATH_XY_TOL, values within
    PATH_VAL_TOL. Returns (max |dxy|, max |dval|)."""
    g = dataclasses.replace(gpu, batch_size=len(frames)).predict(frames, make_labels=False)
    c = cpu.predict(frames, make_labels=False)
    d_xy = d_val = 0.0
    for k in keys:
        a, b = (np.concatenate([ex[k][:ex["n_valid"]] for ex in out]) for out in (g, c))
        if a.dtype == bool:
            check(np.array_equal(a, b), f"{name}: card vs CPU {k}")
            continue
        d = max_abs(torch.from_numpy(a), torch.from_numpy(b))
        if k in point_keys:
            d_xy = max(d_xy, d)
        else:
            d_val = max(d_val, d)
    check(d_xy <= PATH_XY_TOL and d_val <= PATH_VAL_TOL,
          f"{name}: card vs CPU max |dxy| {d_xy:.3g}, max |dval| {d_val:.3g}")
    return d_xy, d_val


def check_single_outputs(name, pred, frames, out, batch):
    """Single-instance outputs: shapes, finite values, points found, and a
    batch with ``Labels``."""
    n_frames = len(frames) - batch
    peaks = np.concatenate([ex["instance_peaks"][:ex["n_valid"]] for ex in out])
    vals = np.concatenate([ex["instance_peak_vals"][:ex["n_valid"]] for ex in out])
    check(peaks.shape == (n_frames, N_NODES, 2) and vals.shape == (n_frames, N_NODES),
          f"{name}: shapes")
    check(np.isfinite(vals).all() and np.isfinite(peaks).any(), f"{name}: values")
    want = [int(not np.isnan(p).all()) for p in peaks[:batch]]
    check_labels(name, pred, frames[batch:2 * batch], want)
    return int(np.isfinite(peaks[..., 0]).sum())


def check_backbones(root, drive, fps, td_frames, td_wrappers, si_wrappers, card):
    """Phase 10, its folders in ``root``: 10a-c, each backbone's folders
    loaded with ``load_model`` (the card by default) and driven as phase 4
    drives its path, then held against the same folders loaded with
    ``device="cpu"`` on BB_CPU_FRAMES frames; 10d, TF32 in process and in a
    fresh CLI process. Returns (the figures it prints, each backbone's
    folders and weights, 10c's frames) for phase 11d."""
    import sleap_tpu_torch

    figures, resnet_pair, models, si_frames = drive_backbones(
        root, drive, fps, td_frames, td_wrappers, si_wrappers, card)
    pred = sleap_tpu_torch.load_model(resnet_pair, batch_size=2, max_instances=MAX_INSTANCES)
    check_library_keeps_tf32_flags(pred, td_frames[:2])
    figures["10d"] = check_cli_fresh_process(resnet_pair, td_frames, card)
    return figures, models, si_frames


def drive_backbones(root, drive, fps, td_frames, td_wrappers, si_wrappers, card):
    """10a-c; returns (figures, 10b's pair of folders with their weights
    saved as ``best_model.pt``, {name: (folders, weights)}, 10c's
    frames)."""
    import sleap_tpu_torch

    gen = torch.Generator().manual_seed(10)
    si_frames = synthetic_frames((1 + TIMED_BATCHES) * BB_SI_BATCH, seed=10, size=BB_SI_IMG,
                                 blobs=1, sigma=12.0)
    centroid = write_run_folders(root)["centroid"]
    folders = backbone_folders(root, centroid)
    device = torch.device("cuda", 0)
    figures, models = {}, {}
    resnet_pair = None
    for name, paths in folders.items():
        t0 = time.perf_counter()
        topdown = len(paths) == 2
        own = paths[-1]
        sample = (td_frames[:BATCH, :CROP, :CROP] if topdown else si_frames[:BB_SI_BATCH])
        params = {own: lsuv_variables(own, sample, gen, device)}
        if topdown:
            params[centroid] = seeded_params(centroid, torch.Generator().manual_seed(0))
        kwargs = dict(params=params, max_instances=MAX_INSTANCES) if topdown else dict(params=params)
        batch = BATCH if topdown else BB_SI_BATCH
        frames = td_frames if topdown else si_frames
        models[name] = (paths, params)
        gpu = sleap_tpu_torch.load_model(paths if topdown else own, batch_size=batch, **kwargs)
        cpu = sleap_tpu_torch.load_model(paths if topdown else own, device="cpu", batch_size=2,
                                         **kwargs)
        check(gpu.device.type == "cuda", f"{name}: on the card by default")
        label = f"{'top-down' if topdown else 'single-instance'} {name}"
        wrappers = td_wrappers if topdown else si_wrappers
        out = drive(label, gpu, frames, wrappers, batch)
        if topdown:
            check_topdown_outputs(label, gpu, frames, out)
            keys = ("centroids", "centroid_vals", "centroid_mask", "instance_peaks",
                    "instance_peak_vals")
            found = int(merged(out, len(frames) - batch)["centroid_mask"].sum())
        else:
            found = check_single_outputs(label, gpu, frames, out, batch)
            keys = ("instance_peaks", "instance_peak_vals")
        d_xy, d_val = card_vs_cpu(label, gpu, cpu, frames[:BB_CPU_FRAMES], keys,
                                  ("centroids", "instance_peaks"))
        dev_ms = device_ms_per_batch(gpu, frames[:batch])
        module = (gpu.confmap_model if hasattr(gpu, "confmap_model") else gpu).module
        n_params = sum(p.numel() for p in module.parameters())
        fps_ = fps[label]
        figures[name] = {"fps": fps_, "device_ms_per_batch": dev_ms, "batch": batch,
                         "image": IMG if topdown else BB_SI_IMG, "params": n_params,
                         "found": found, "max_abs_dxy": d_xy, "max_abs_dval": d_val,
                         "seconds": time.perf_counter() - t0}
        log(f"10 {label}: {n_params} parameters; {fps_:.1f} FPS, {dev_ms:.2f} device ms a batch "
            f"of {batch}; card vs CPU ({BB_CPU_FRAMES} frames) max |dxy| {d_xy:.3g}, max |dval| "
            f"{d_val:.3g}; {time.perf_counter() - t0:.1f} s ({card})")
        if name == "resnet ResNet50":
            for path, tm in zip(paths, (gpu.centroid_model, gpu.confmap_model)):
                torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                           os.path.join(path, "best_model.pt"))
            resnet_pair = paths
    return figures, resnet_pair, models, si_frames


def check_library_keeps_tf32_flags(pred, frames):
    """10d, in process: a library ``predict`` runs float32 with TF32 off and
    leaves the caller's flags as it found them."""
    for state in ((True, True), (True, False), (False, True)):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = state
        pred.predict(frames, make_labels=False)
        after = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        check(after == state, f"10d: predict changed the caller's TF32 flags {state} -> {after}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False


def check_cli_fresh_process(resnet_pair, frames, card):
    """10d: ``python -m sleap_tpu_torch.cli.track`` in a fresh interpreter
    (no TF32 flag set by this process; the CLI turns TF32 off itself), on
    the card and with ``--cpu``: phase 8b's float32 pair on ``raw.slp`` and
    10b's folders (weights in ``best_model.pt``) on a .slp of
    BB_CPU_FRAMES frames of 1024^2; the two within PATH_XY_TOL and
    PATH_VAL_TOL."""
    from sleap_tpu_torch.core.instance import LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io.slp import read_labels, write_labels
    from sleap_tpu_torch.io.video import Video

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    figures = {}
    with tempfile.TemporaryDirectory() as root:
        clip = os.path.join(root, "clip.slp")
        write_labels(clip, Labels([LabeledFrame(Video.from_numpy(frames[:BB_CPU_FRAMES]), i)
                                   for i in range(BB_CPU_FRAMES)]))
        cases = [
            ("trained float32 pair (8b)", os.path.join(here, *FIXTURE_DIR, "raw.slp"),
             ["-m", os.path.join(runs, CLI_TRAINED[0]), "-m", os.path.join(runs, CLI_TRAINED[1]),
              "--peak_threshold", "0.05", "--batch_size", "4"]),
            ("10b resnet ResNet50 pair", clip,
             ["-m", resnet_pair[0], "-m", resnet_pair[1], "--max_instances", str(MAX_INSTANCES),
              "--batch_size", str(BB_CPU_FRAMES)]),
        ]
        for k, (name, src, models) in enumerate(cases):
            outs = []
            for flag in ((), ("--cpu",)):
                out = os.path.join(root, f"{k}{''.join(flag)}.slp")
                t0 = time.perf_counter()
                run = subprocess.run(
                    [sys.executable, "-m", "sleap_tpu_torch.cli.track", src, *models,
                     "--verbosity", "none", *flag, "-o", out],
                    cwd=here, capture_output=True, text=True, timeout=300)
                check(run.returncode == 0, f"10d {name} {flag}: exit {run.returncode}: "
                      f"{run.stderr[-2000:]}")
                outs.append((read_labels(out), time.perf_counter() - t0))
            (got, card_s), (want, cpu_s) = outs
            n = sum(len(lf.instances) for lf in got)
            check(n >= len(got) > 0, f"10d {name}: instances in every frame")
            d = compare_predictions(got, want, PATH_XY_TOL, PATH_VAL_TOL,
                                    f"10d {name}: fresh-process CLI, card vs --cpu")
            figures[name] = {"card_s": card_s, "cpu_s": cpu_s, "instances": n,
                             "max_abs_dxy": d[0], "max_abs_dscore": d[1]}
            log(f"10d fresh-process CLI {name}: card {card_s:.1f} s, --cpu {cpu_s:.1f} s, "
                f"{n} instances; max |dxy| {d[0]:.3g}, max |dscore| {d[1]:.3g} ({card})")
    return figures


def decoder_probe():
    """What the card's machine offers to decode H.264, printed only
    (ROADMAP queue 1, item 3a): installs nothing, imports nothing heavy,
    never fails the run."""
    import ctypes
    import ctypes.util
    import importlib.util

    try:
        ctypes.CDLL("libnvcuvid.so.1")
        nvcuvid_loads = True
    except OSError as e:
        nvcuvid_loads = f"no: {e}"
    probe = {
        "ffmpeg": shutil.which("ffmpeg"),
        "find_library(nvcuvid)": ctypes.util.find_library("nvcuvid"),
        "CDLL(libnvcuvid.so.1)": nvcuvid_loads,
        "find_spec": {name: importlib.util.find_spec(name) is not None
                      for name in ("torchvision", "torchcodec", "av", "imageio_ffmpeg")},
    }
    log(f"decoder probe: {json.dumps(probe)}")
    return probe


# --------------------------------------------------------------------------- #
# Phase 11: training the other backbones, and their bf16 inference
# --------------------------------------------------------------------------- #


def step_grads(trainer, init, examples, dtype, inputs=None):
    """One train-mode forward and backward of ``trainer``'s module from the
    weights and statistics ``init`` on ``examples``: float32 runs the
    trainer's own ``compute_loss`` (ground truth made on the trainer's
    device); float64 a float64 copy of the module on ``inputs`` (images and
    ground truth, the same tensors for every device) with the trainer's loss
    terms summed in float64 (the trainer's own loss is float32). Returns
    (loss, gradients, running statistics) on the CPU."""
    if dtype == torch.float32:
        module = trainer.module
        module.load_state_dict(init)
        module.train()
        module.zero_grad()
        loss = trainer.compute_loss(trainer.to_device(trainer.make_batch(examples, None)),
                                    torch.Generator(device=trainer.device).manual_seed(0))
    else:
        imgs, gt = inputs
        module = trainer.model.make_module(trainer._input_channels, compute_dtype=dtype)
        module.load_state_dict(init)
        module.to(trainer.device).train()
        preds = module(imgs.to(trainer.device))
        loss = sum(weight * ((preds[key] - gt[name].to(trainer.device, dtype)) ** 2).mean()
                   for name, weight, _ in trainer._loss_terms()
                   for key in preds if key == name or key.startswith(f"{name}_stack"))
    loss.backward()
    stats = {k: v.detach().double().cpu() for k, v in module.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    grads = {n: p.grad.detach().double().cpu() for n, p in module.named_parameters()}
    return float(loss.detach()), grads, stats


def step_differences(card, cpu):
    """(loss, gradients, statistics) of two steps: the loss's relative
    difference; the largest gradient difference over that gradient's
    largest magnitude, floored at BB_STEP_GRAD_RTOL of the step's largest
    gradient (a bias in front of a train-mode batch norm has gradient 0 in
    exact arithmetic); the largest running-statistic difference over that
    statistic's largest magnitude, a mean's measured in units of its
    layer's standard deviation (a mean can be 0 in exact arithmetic)."""
    (l_a, g_a, s_a), (l_b, g_b, s_b) = card, cpu
    largest = max(float(g.abs().max()) for g in g_b.values())
    grad = max(float((g_a[n] - g).abs().max()) / max(float(g.abs().max()),
                                                     BB_STEP_GRAD_RTOL * largest)
               for n, g in g_b.items())
    stats = 0.0
    for k, s in s_b.items():
        scale = float(s.abs().max())
        if k.endswith("running_mean"):
            scale = max(scale, float(s_b[k[:-len("mean")] + "var"].sqrt().max()))
        stats = max(stats, float((s_a[k] - s).abs().max()) / scale)
    return abs(l_a - l_b) / abs(l_b), grad, stats


def check_other_backbones(drive, fps, td_frames, td_wrappers, launches, card):
    """Phases 10 and 11 on phase 10's folders; returns their figures."""
    from sleap_tpu_torch.ops import cuda_peaks

    si_wrappers = {"global_peaks": cuda_peaks.global_peaks_cuda}
    root = tempfile.mkdtemp(prefix="chip_smoke_backbones_")
    try:
        t10 = time.perf_counter()
        backbones, models, si_frames = check_backbones(root, drive, fps, td_frames, td_wrappers,
                                                       si_wrappers, card)
        log(f"phase 10 took {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        training = {"11a steps": check_backbone_steps(card),
                    "11b throughput": check_backbone_train_throughput(card),
                    "11c sleap-train Hourglass": check_backbone_cli_train(card, si_wrappers,
                                                                          launches),
                    "11d bf16": check_backbones_bf16(drive, fps, td_frames, si_frames, models,
                                                     card)}
        log(f"phase 11 took {time.perf_counter() - t11:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return backbones, training


def check_backbone_steps(card):
    """11a: one train step of each backbone at its default width on
    BB_STEP_BATCH blob frames of BB_STEP_SIZE^2, on the card and on the
    CPU from the same lecun-seeded weights, TF32 off. Float32, through the
    trainer: the loss within BB_STEP_LOSS_RTOL; the gradients' and
    statistics' differences are printed, not held (a deep batch-norm net at
    its initial weights amplifies float32 rounding and the two devices'
    one-ulp differences in the ground truth to 1e-2 of a gradient: PERF.md
    section 6, PR 12). Float64, on the same images and ground truth: the
    loss within BB_STEP_LOSS_RTOL, the gradients within BB_STEP_GRAD_RTOL
    and the running statistics within BB_STEP_STATS_RTOL, each statistic
    moved from the init."""
    from sleap_tpu_torch.config import TrainingJobConfig
    from sleap_tpu_torch.training.trainer import Trainer

    frames, points = blob_animals(BB_STEP_BATCH, seed=11, size=BB_STEP_SIZE, margin=32, gap=0,
                                  animals=1)
    labels = labels_of(frames, points)
    res = {}
    for name in BB_STEP_BACKBONES:
        t0 = time.perf_counter()
        cfg = backbone_config(name, topdown=False)
        cfg.optimization.batch_size = BB_STEP_BATCH
        cfg.outputs.save_outputs = False
        text = cfg.to_json()
        on_card, on_cpu = (Trainer.from_config(TrainingJobConfig.from_json(text),
                                               training_labels=labels, validation_labels=labels,
                                               device=d) for d in ("cuda", "cpu"))
        for t in (on_card, on_cpu):
            t.setup()
        init = {k: v.clone() for k, v in on_cpu.module.state_dict().items()}
        check(all(torch.equal(v.cpu(), init[k]) for k, v in on_card.module.state_dict().items()),
              f"11a {name}: the same initial weights on both devices")
        examples = [on_cpu._train_examples[i] for i in range(BB_STEP_BATCH)]
        inputs = on_cpu.build_gt_fn()(on_cpu.to_device(on_cpu.make_batch(examples, None)),
                                      torch.Generator().manual_seed(0))
        row = {}
        for dtype in (torch.float32, torch.float64):
            steps = [step_grads(t, init, examples, dtype, inputs) for t in (on_card, on_cpu)]
            loss_rel, grad_rel, stats_rel = step_differences(*steps)
            moved = min((float((s - init[k].double()).abs().max()) for k, s in steps[1][2].items()),
                        default=None)
            row[str(dtype).split(".")[-1]] = {"loss": steps[1][0], "loss_rel": loss_rel,
                                               "grad_rel": grad_rel, "stats_rel": stats_rel,
                                               "least_stat_move": moved}
        row["seconds"] = time.perf_counter() - t0
        res[name] = row
        log(f"11a {name} step card vs CPU ({BB_STEP_SIZE}^2, batch {BB_STEP_BATCH}): {row} ({card})")
        f32, f64 = row["float32"], row["float64"]
        check(f32["loss_rel"] <= BB_STEP_LOSS_RTOL, f"11a {name}: float32 loss")
        check(f64["loss_rel"] <= BB_STEP_LOSS_RTOL and f64["grad_rel"] <= BB_STEP_GRAD_RTOL
              and f64["stats_rel"] <= BB_STEP_STATS_RTOL, f"11a {name}: float64 step")
        check(f64["least_stat_move"] is None or f64["least_stat_move"] > 0,
              f"11a {name}: every running statistic moved")
        del on_card, on_cpu
        torch.cuda.empty_cache()
    return res


def backbone_trainer(name, topdown, mixed_precision):
    """A trainer of backbone ``name`` on the card, set up on 4 random frames
    (1024^2 of 3 instances, top-down on crops of CROP; else BB_SI_IMG^2 of
    one); Adam at 1e-4, augmentation off."""
    from sleap_tpu_torch.training.trainer import Trainer

    size, animals = (IMG, 3) if topdown else (BB_SI_IMG, 1)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (4, size, size, 1), np.uint8)
    labels = labels_of(frames, rng.uniform(100, size - 100, (4, animals, N_NODES, 2)))
    cfg = backbone_config(name, topdown)
    cfg.optimization.batch_size = TRAIN_BATCH if topdown else BB_SI_BATCH
    cfg.optimization.mixed_precision = mixed_precision
    cfg.outputs.save_outputs = False
    trainer = Trainer.from_config(cfg, training_labels=labels, validation_labels=labels)
    trainer.setup()
    trainer.make_optimizer()
    return trainer


def check_backbone_train_throughput(card):
    """11b: TRAIN_STEPS synchronised train steps after TRAIN_WARMUP of each
    backbone at its default width, float32 and mixed precision: single-
    instance BB_SI_IMG^2, batch BB_SI_BATCH, and the top-down
    centered-instance pretrained-encoder ResNet-50 on crops of CROP from
    1024^2 frames, batch TRAIN_BATCH (``bench.py``'s train_topdown shape)."""
    from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d

    results = {}
    for name in BB_TRAIN_BACKBONES:
        topdown = name == "pretrained-encoder ResNet-50"
        for mixed in (False, True):
            trainer = backbone_trainer(name, topdown, mixed)
            batch = bench_batch("topdown" if topdown else "single", trainer.device,
                                size=IMG if topdown else BB_SI_IMG,
                                batch=TRAIN_BATCH if topdown else BB_SI_BATCH,
                                animals=3 if topdown else 1)
            key = (f"11b train {'top-down' if topdown else 'single-instance'} {name} "
                   f"{'mixed precision' if mixed else 'f32'}")
            results[key] = time_train_steps(key, trainer, batch, card)
            bns = [m for m in trainer.module.modules() if isinstance(m, FlaxBatchNorm2d)]
            check(all(t.dtype == torch.float32 for m in bns for t in (*m.parameters(), *m.buffers())),
                  f"{key}: float32 batch norm")
            check(all(bool(torch.isfinite(m.running_var).all()) for m in bns),
                  f"{key}: finite running statistics")
            del trainer, batch
            torch.cuda.empty_cache()
    return results


def check_backbone_cli_train(card, wrappers, launches):
    """11c: a single-instance Hourglass (its config's defaults, batch norm)
    trained through ``cli.train.main`` from a ``.slp`` of BB_CLI_FRAMES blob
    frames of BB_CLI_IMG^2 (one animal a frame, an HDF5 video written
    here); its ``best_model.pt`` carries statistics that moved; the folder
    predicts BB_CLI_HELD_OUT held-out frames on the card (kernel 1 once a
    batch), every animal within BB_CLI_BOUND_PX of mean node error, and
    agrees with the same folder on ``device="cpu"``."""
    import sleap_tpu_torch
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io import hdf5
    from sleap_tpu_torch.io.slp import write_labels
    from sleap_tpu_torch.io.video import Video

    root = tempfile.mkdtemp(prefix="chip_smoke_backbone_cli_")
    try:
        frames, points = blob_animals(BB_CLI_FRAMES + BB_CLI_HELD_OUT, seed=13, size=BB_CLI_IMG,
                                      margin=64, gap=0, sigma=TRAIN_CLI_SIGMA,
                                      radius=TRAIN_CLI_RING, animals=1)
        video_path = os.path.join(root, "video.h5")
        with hdf5.Writer(video_path) as h5:
            h5.create_dataset("video", data=frames[:BB_CLI_FRAMES])
        video, skeleton = Video.from_filename(video_path, dataset="video"), chain_skeleton()
        project = os.path.join(root, "hourglass.slp")
        write_labels(project, Labels([LabeledFrame(video, i, [Instance(skeleton, pts[0])])
                                      for i, pts in enumerate(points[:BB_CLI_FRAMES])]))
        cfg = backbone_config("Hourglass", topdown=False)
        cfg.model.backbone.hourglass.stacks = BB_CLI_STACKS
        cfg.model.heads.single_instance.sigma = BB_CLI_SIGMA
        cfg.data.labels.skeletons = []
        cfg.optimization.batch_size = BB_CLI_BATCH
        cfg.optimization.epochs = BB_CLI_EPOCHS
        cfg.optimization.batches_per_epoch = BB_CLI_BATCHES
        cfg.optimization.val_batches_per_epoch = 2
        cfg.optimization.initial_learning_rate = BB_CLI_LR
        # A fixed schedule, as 7c's: no early stop, no learning-rate cut.
        cfg.optimization.early_stopping.stop_training_on_plateau = False
        cfg.optimization.learning_rate_schedule.reduce_on_plateau = False
        cfg.outputs.runs_folder = root
        profile = os.path.join(root, "hourglass.json")
        cfg.save_json(profile)
        seconds, setup_s, cli_launches, evaluations = train_with_cli(profile, project, "hourglass",
                                                                     wrappers)
        for kernel, n in cli_launches.items():
            launches[kernel]["sleap-train Hourglass evaluation (11c)"] = n
        folder = os.path.join(root, "hourglass")
        best = torch.load(os.path.join(folder, "best_model.pt"), weights_only=True)
        stats = {k: v for k, v in best.items() if k.endswith(("running_mean", "running_var"))}
        check(len(stats) > 0 and all(
            not torch.equal(v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v))
            for k, v in stats.items()), "11c: every running statistic moved from its init")
        with open(os.path.join(folder, "training_log.csv")) as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f)]
        gpu = sleap_tpu_torch.load_model(folder, batch_size=BB_CLI_BATCH)
        cpu = sleap_tpu_torch.load_model(folder, device="cpu", batch_size=BB_CLI_BATCH)
        check(gpu.device.type == "cuda", "11c: the trained folder loads on the card")
        held = frames[BB_CLI_FRAMES:]
        out, counts, fps = run_path("11c trained Hourglass single-instance", gpu, held, wrappers,
                                    BB_CLI_BATCH)
        for kernel, n in counts.items():
            launches[kernel]["trained Hourglass single-instance (11c)"] = n
        peaks = np.concatenate([ex["instance_peaks"][:ex["n_valid"]] for ex in out])
        truth = points[BB_CLI_FRAMES + BB_CLI_BATCH:, 0]
        errs = np.nanmean(np.linalg.norm(peaks - truth, axis=-1), axis=-1)
        d_xy, d_val = card_vs_cpu("11c trained Hourglass", gpu, cpu, held[:BB_CLI_BATCH],
                                  ("instance_peaks", "instance_peak_vals"), ("instance_peaks",))
        res = {"cli_s": seconds, "setup_s": setup_s, "epoch_losses": losses,
               "evaluation_launches": cli_launches,
               "evaluations": [{k: e[k] for k in ("split", "seconds", "launches")}
                               for e in evaluations],
               "held_out_node_error_px": {"median": float(np.median(errs)),
                                          "max": float(np.max(errs)), "animals": len(errs)},
               "fps": fps, "max_abs_dxy": d_xy, "max_abs_dval": d_val}
        log(f"11c sleap-train Hourglass ({BB_CLI_EPOCHS} epochs of {BB_CLI_BATCHES} batches of "
            f"{BB_CLI_BATCH}, {BB_CLI_IMG}^2): {seconds:.1f} s (setup {setup_s:.1f}); epoch losses "
            f"{[round(v, 6) for v in losses]}; held-out mean node error median "
            f"{np.median(errs):.3f} px, max {np.max(errs):.3f} px over {len(errs)} animals "
            f"(bound {BB_CLI_BOUND_PX} px); {fps:.1f} FPS; card vs CPU max |dxy| {d_xy:.3g}, "
            f"max |dval| {d_val:.3g} ({card})")
        check(np.isfinite(errs).all() and errs.max() <= BB_CLI_BOUND_PX,
              f"11c: every held-out animal found within {BB_CLI_BOUND_PX} px")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res


def check_backbones_bf16(drive, fps, td_frames, si_frames, models, card):
    """11d: phase 10's folders and weights loaded with
    ``compute_dtype=torch.bfloat16`` and driven as phase 10 drives them
    (kernels 4, 3 and 1 top-down, kernel 1 single-instance, once a batch);
    the card's bf16 maps of one batch through kernel 1 and, on the CPU,
    through its plain version; FPS and one batch's device ms beside phase
    10's float32 figures."""
    import sleap_tpu_torch
    from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    figures = {}
    for name, (paths, params) in models.items():
        topdown = len(paths) == 2
        batch = BATCH if topdown else BB_SI_BATCH
        frames = td_frames if topdown else si_frames
        kwargs = dict(max_instances=MAX_INSTANCES) if topdown else {}
        pred = sleap_tpu_torch.load_model(paths if topdown else paths[0], params=params,
                                          batch_size=batch, compute_dtype=torch.bfloat16, **kwargs)
        label = f"{'top-down' if topdown else 'single-instance'} {name} bf16"
        wrappers = {"global_peaks": cuda_peaks.global_peaks_cuda}
        if topdown:
            wrappers.update(local_peaks_hwcs=cuda_peaks.local_peaks_hwcs_cuda,
                            crop_unit=cuda_crops.crop_unit_cuda)
        out = drive(label, pred, frames, wrappers, batch)
        head = "CenteredInstanceConfmapsHead" if topdown else "SingleInstanceConfmapsHead"
        if topdown:
            check_topdown_outputs(label, pred, frames, out)
        else:
            check_single_outputs(label, pred, frames, out, batch)
        module = pred.confmap_model.module
        bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm2d)]
        check(all(t.dtype == torch.float32 for m in bns for t in (*m.parameters(), *m.buffers())),
              f"{label}: float32 batch norm")
        maps = head_maps(module, head,
                         lambda: pred.predict(frames[batch:2 * batch], make_labels=False))
        check_card_maps(label, maps, slab=False)
        dev_ms = device_ms_per_batch(pred, frames[:batch])
        f32 = fps[f"{'top-down' if topdown else 'single-instance'} {name}"]
        figures[name] = {"fps": fps[label], "float32_fps": f32, "device_ms_per_batch": dev_ms,
                         "batch": batch}
        log(f"11d {label}: {fps[label]:.1f} FPS (float32 {f32:.1f}), {dev_ms:.2f} device ms a "
            f"batch of {batch} ({card})")
        del pred
    return figures


# --------------------------------------------------------------------------- #
# Phase 5: times and bounds
# --------------------------------------------------------------------------- #


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def crop_taps(images, top_left, box_inds, crop) -> int:
    """Bytes of the source pixels the boxes read: the union of their
    in-image (crop + 1)^2 tap windows."""
    S, H, W, C = images.shape
    touched = torch.zeros((S, H, W), dtype=torch.bool, device=images.device)
    for (x, y), s in zip(torch.floor(top_left).long().tolist(), box_inds.tolist()):
        touched[s, max(y, 0):max(min(y + crop + 1, H), 0), max(x, 0):max(min(x + crop + 1, W), 0)] = True
    return int(touched.sum()) * C * images.element_size()


def grid_sample_crops(images_f32, top_left, box_inds, crop):
    """The crops as one ``F.grid_sample`` call (bilinear, zeros padding,
    align_corners=True) on a prepared grid: the library yardstick. The
    frames are gathered per box (an (n, C, H, W) copy) here, outside the
    timed call; the crop kernel reads the frames in place."""
    S, H, W, C = images_f32.shape
    offs = torch.arange(crop, device=images_f32.device, dtype=torch.float32)
    xs = top_left[:, 0, None] + offs  # (n, crop)
    ys = top_left[:, 1, None] + offs
    gx = (2 * xs / (W - 1) - 1)[:, None, :].expand(-1, crop, -1)
    gy = (2 * ys / (H - 1) - 1)[:, :, None].expand(-1, -1, crop)
    grid = torch.stack([gx, gy], dim=-1)  # (n, crop, crop, 2)
    src = images_f32.permute(0, 3, 1, 2)[box_inds]  # (n, C, H, W) gather of frames

    def call():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    return call


def timed_pair(kernel_fn, plain_fn, funcs):
    """(per call ms, plain per call ms, device ms, plain device ms): per call
    in turns (kernel, plain, plain, kernel), each side averaged."""
    k1, p1 = time_ms(kernel_fn), time_ms(plain_fn)
    p2, k2 = time_ms(plain_fn), time_ms(kernel_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2, device_ms(kernel_fn, funcs), device_ms(plain_fn)


def kernel_rows(errs, launches, card):
    """Phase 5's rows. ``launches`` maps a kernel to its launches on each
    path; each row keeps that dict as ``launches_by_path``."""
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    calls = {
        "global_peaks": (lambda m, *_: cuda_peaks.global_peaks_cuda(m, 0.2, 2),
                         lambda m, *_: cuda_peaks.global_peaks_plain(m, 0.2, 2)),
        "local_peaks": (lambda m: cuda_peaks.local_peaks_cuda(m, MAX_INSTANCES, 0.2, 2),
                        lambda m: cuda_peaks.local_peaks_plain(m, MAX_INSTANCES, 0.2, 2)),
        "crop_unit": (lambda *a: cuda_crops.crop_unit_cuda(*a, (CROP, CROP)),
                      lambda *a: cuda_crops.crop_unit_plain(*a, (CROP, CROP))),
        "local_peaks_hwcs": (
            lambda m: cuda_peaks.local_peaks_hwcs_cuda(m, BU_K, 0.2, HWCS_HALF),
            lambda m: cuda_peaks.local_peaks_hwcs_plain(m, BU_K, 0.2, HWCS_HALF)),
    }
    # (source, TPU kernel body, device functions, outputs per map or box)
    meta = {
        "local_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:101",
                        ("local_peaks_kernel",)),
        "crop_unit": ("sleap_tpu_torch/csrc/crops.cu", "sleap_tpu/ops/pallas_crops.py:56",
                      ("crop_unit_kernel",)),
        "global_peaks": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:68",
                         ("global_slab_kernel", "global_band_kernel")),
        "local_peaks_hwcs": ("sleap_tpu_torch/csrc/peaks.cu", "sleap_tpu/ops/pallas_peaks.py:487",
                             ("hwcs_band_kernel",)),
    }
    kernels = []
    for name, (source, tpu, funcs) in meta.items():
        err, args = errs[name]
        kernel_fn, plain_fn = calls[name]
        outs = kernel_fn(*args)
        ms, plain_ms, dev_ms, plain_dev_ms = timed_pair(
            lambda: kernel_fn(*args), lambda: plain_fn(*args), funcs)
        # Bound: each input read once, each output written once; a few
        # float32 operations per value read (compares, window sums, blends).
        if name == "crop_unit":
            images, top_left, box_inds = args
            moved = crop_taps(images, top_left, box_inds, CROP) + nbytes(top_left, box_inds, outs)
            ops = 8 * outs.numel()  # 4 taps: 4 multiplies, 4 adds per value
        elif name == "global_peaks":
            moved = nbytes(args[0], *outs)
            ops = 2 * args[0].numel()  # a compare and a NaN test
        else:
            moved = nbytes(args[0], *outs)
            ops = 9 * args[0].numel()  # 8 neighbour compares and a threshold
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        library_ms = None
        extra, crop_f32 = "", {}
        if name == "global_peaks":
            bf16 = args[1]
            # bf16 maps reach the kernel as they lie: no cast or copy first.
            from sleap_tpu_torch.ops.peak_finding import find_global_peaks

            launched = [e.key for e in device_events(
                lambda: find_global_peaks(bf16, 0.2, "integral"), iters=5)]
            log(f"global_peaks on bf16 maps through find_global_peaks launches {launched}")
            check(len(launched) == 1 and "global_slab_kernel" in launched[0],
                  f"bf16 maps reach kernel 1 alone, with no copy: {launched}")
            bf_ms, bf_plain_ms, bf_dev, bf_plain_dev = timed_pair(
                lambda: kernel_fn(bf16), lambda: plain_fn(bf16), funcs)
            bf_moved = nbytes(bf16, *kernel_fn(bf16))
            bf_bound = max(bf_moved / HBM_BYTES_PER_S, 2 * bf16.numel() / F32_OPS_PER_S) * 1e3
            crop_f32 = {"bfloat16_ms": bf_ms, "bfloat16_plain_ms": bf_plain_ms,
                        "bfloat16_device_ms": bf_dev, "bfloat16_plain_device_ms": bf_plain_dev,
                        "bfloat16_bound_ms": bf_bound}
            extra = (f"; on the bf16 channels-last maps: per call {bf_ms:.4f} ms (plain "
                     f"{bf_plain_ms:.4f}); device {bf_dev:.4f} ms (plain {bf_plain_dev:.4f}); "
                     f"bound {bf_bound:.4f} ms ({bf_moved / 1e6:.2f} MB), "
                     f"{100 * bf_bound / bf_dev:.1f} % of it")
        if name == "crop_unit":
            images, top_left, box_inds = args
            f32 = images.float()
            lib = grid_sample_crops(f32, top_left, box_inds, CROP)
            lib_out = lib().permute(0, 2, 3, 1)
            e_lib = max_abs(lib_out, cuda_crops.crop_unit_plain(f32, top_left, box_inds, (CROP, CROP)))
            f32_fn = lambda: cuda_crops.crop_unit_cuda(f32, top_left, box_inds, (CROP, CROP))
            library_ms, f32_ms = time_ms(lib), time_ms(f32_fn)
            lib_dev, f32_dev = device_ms(lib), device_ms(f32_fn, funcs)
            crop_f32 = {"float32_ms": f32_ms, "float32_device_ms": f32_dev,
                        "library_device_ms": lib_dev}
            extra = (f"; on float32 frames: kernel {f32_ms:.4f} ms per call, {f32_dev:.4f} ms "
                     f"device; F.grid_sample {library_ms:.4f} ms per call, {lib_dev:.4f} ms device "
                     f"(max |d| vs plain {e_lib:.3g}, float32 rounding of its normalized grid)")
        log(f"{name}: per call {ms:.4f} ms (plain {plain_ms:.4f}); device {dev_ms:.4f} ms "
            f"(plain {plain_dev_ms:.4f}); bound {bound_ms:.4f} ms ({moved / 1e6:.2f} MB), "
            f"{100 * bound_ms / dev_ms:.1f} % of it{extra} ({card})")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            **crop_f32,
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU.")
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    decoder_probe()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # Phase 2: build, run folders, loading.
    from sleap_tpu_torch.ops import _build, cuda_crops, cuda_peaks

    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.load_library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    frames = synthetic_frames((1 + TIMED_BATCHES) * BATCH, seed=0)
    si_frames = synthetic_frames((1 + TIMED_BATCHES) * SI_BATCH, seed=1, size=SI_IMG, blobs=1)
    with tempfile.TemporaryDirectory() as root:
        folders = write_run_folders(root)
        td, td_cpu, bu, td_bf16, si, td_tracked = load_predictors(folders)
        td_mc, td_mc_cpu, bu_mc = load_multiclass(folders)
    log(f"loaded {type(td).__name__}, {type(si).__name__}, {type(bu[0]).__name__}, "
        f"{type(td_mc).__name__} and {type(bu_mc).__name__} from run folders on {td.device}, "
        f"{si.device}, {bu[0].device}, {td_mc.device} and {bu_mc.device}")

    # Phase 3: each kernel vs its plain version.
    gen = torch.Generator(device=device).manual_seed(0)
    errs = check_kernels(device, gen)
    path_maps, heads = path_head_maps(bu[0], frames[:BATCH])
    errs["local_peaks_hwcs"] = check_hwcs(device, gen, path_maps)

    launches = {name: {} for name in errs}  # kernel -> path -> launches
    fps = {}

    def drive(name, pred, path_frames, wrappers, batch=BATCH):
        out, counts, fps[name] = run_path(name, pred, path_frames, wrappers, batch)
        for kernel, n in counts.items():
            launches[kernel][name] = n
        return out

    # Phase 4: the top-down path.
    td_wrappers = {
        "local_peaks": cuda_peaks.local_peaks_cuda,
        "crop_unit": cuda_crops.crop_unit_cuda,
        "global_peaks": cuda_peaks.global_peaks_cuda,
    }
    check_topdown(td, td_cpu, frames, drive("top-down", td, frames, td_wrappers))

    # Phase 4b: the bottom-up path.
    out = drive("bottom-up", bu[0], frames, {"local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda})
    check_bottomup(bu, frames, out, heads)

    # Phase 4c: the top-down path in bf16.
    bf16_wrappers = {
        "local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda,
        "crop_unit": cuda_crops.crop_unit_cuda,
        "global_peaks": cuda_peaks.global_peaks_cuda,
    }
    check_topdown_bf16(td_bf16, frames, drive("top-down bf16", td_bf16, frames, bf16_wrappers))

    # Phase 4d: single-instance in bf16.
    out = drive("single-instance bf16", si, si_frames,
               {"global_peaks": cuda_peaks.global_peaks_cuda}, SI_BATCH)
    check_single(si, si_frames, out)

    # Phase 5: kernel and plain version times at the main-path shapes, with
    # the card in the state phases 4-4d leave it in; the launch counts of the
    # paths after it are added to the rows at the end.
    kernels = kernel_rows(errs, launches, card)

    # Phase 4e: top-down multiclass, float32, on blobs of four sizes that
    # its class layer is set to tell apart.
    frames_mc = mc_frames((1 + TIMED_BATCHES) * BATCH, seed=3)
    cuts, margin = fit_class_head([td_mc, td_mc_cpu], frames_mc)
    log(f"top-down multiclass class cuts {[round(c, 5) for c in cuts]}, crops at least "
        f"{margin:.3g} of the spread from a cut")
    out = drive("top-down multiclass", td_mc, frames_mc, td_wrappers)
    check_topdown_mc(td_mc, td_mc_cpu, frames_mc, out)

    # Phase 4f: bottom-up multiclass, bf16.
    out = drive("bottom-up multiclass bf16", bu_mc, frames,
                {"local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda})
    check_bottomup_mc(bu_mc, frames, out)

    # Phase 4g: the trained folders, read from their checkpoints.
    all_wrappers = {**td_wrappers, "local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda}
    read_s = check_trained_folders(all_wrappers, launches)

    # Phase 6: tracking.
    track_paths = blob_paths((1 + TIMED_BATCHES) * BATCH, IMG,
                             [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                             [150.0, 150.0], seed=4)
    track_frames = moving_frames(track_paths, IMG, 8.0, 200.0, seed=4)
    tracked, tracking = check_tracked_path(td_tracked, track_frames, td_wrappers, launches, fps,
                                           card)
    check_tracking_card_vs_cpu(tracked)
    check_tracking_trained()

    # Phase 7: training.
    t7 = time.perf_counter()
    training = {"throughput": check_train_throughput(card),
                "step_card_vs_cpu": check_step_card_vs_cpu(card),
                "top-down pair": check_train_pair(card, td_wrappers, launches)}
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s")

    # Phase 8: sleap-track from .slp to .slp.
    t8 = time.perf_counter()
    cli = {"full_width": check_cli_full_width(td, td_wrappers, launches, card),
           "fixtures": check_cli_fixtures(all_wrappers, launches, card)}
    log(f"phase 8 took {time.perf_counter() - t8:.1f} s")

    # Phase 9: sleap-train from .slp to scored run folders, and sleap-inspect.
    t9 = time.perf_counter()
    train_cli = check_sleap_train(card, td_wrappers, launches)
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s")

    # Phases 10 and 11: the other backbones at full width, TF32 in a fresh
    # process; training them, and their bf16 inference.
    backbones, backbone_training = check_other_backbones(drive, fps, frames, td_wrappers,
                                                         launches, card)
    for row in kernels:
        row["launches"] = sum(row["launches_by_path"].values())

    leaked = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "orbax", "sleap_tpu", "networkx", "attr", "attrs", "h5py", "cv2",
        "zstandard", "tensorstore")]
    check(not leaked, f"JAX-side modules imported: {leaked[:5]}")

    for name, value in fps.items():
        log(f"{name} path: {value:.1f} FPS ({card})")
    for name, value in read_s.items():
        log(f"checkpoint read {name}: {value:.3f} s ({card})")
    log(f"tracking: {json.dumps(tracking)} ({card})")
    log(f"cli: {json.dumps(cli)} ({card})")
    log(f"sleap-train: {json.dumps(train_cli)} ({card})")
    log(f"backbones: {json.dumps(backbones)} ({card})")
    print(json.dumps({"training": training, "card": card}), flush=True)
    print(json.dumps({"backbone_training": backbone_training, "card": card}), flush=True)
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
