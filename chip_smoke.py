#!/usr/bin/env python3
"""Drive sleap_tpu_torch's top-down, single-instance, bottom-up and multiclass
inference, flow-shift tracking, training, the ``sleap-track``,
``sleap-train``, ``sleap-inspect``, ``sleap-convert``, ``sleap-export`` and
``sleap-diagnostic`` CLIs, exported programs, the data model's API, the
host modules (NWB/NIX, image-feature suggestions, prefs, util, message),
the pipeline blocks and builders, ZMQ training and MoveNet, JPEG writing
and ``sleap-render``, still images (progressive JPEG, BMP, TIFF), users'
own HDF5 files (latest format, SWMR, LZF) and users' AVI videos
(Motion-JPEG through J5, raw frames) once on one CUDA card,
and data-parallel across replicas and ranks, through the
run-folder loader, the trainer and the CLIs a user calls, the repo's
trained run folders from their own checkpoints, the other backbones
(ResNet, pretrained-encoder UNets, HRNet, Hourglass, LEAP) in inference,
float32 and bf16, and in training, and H.264 ``.mp4`` reading (NVDEC).

    python3 chip_smoke.py

Phases; any failure exits non-zero and no result line is printed. Each
phase prints its seconds on a line of its own ("phase N took S s"), and the
script its total before the ``kernels`` line:

1. The card: CUDA must be available; print its name and power limit, then
   what the machine offers to decode H.264 (print only, never fails): the
   kernel (``/proc/version``), the NVIDIA driver's version, the container's
   ``NVIDIA_DRIVER_CAPABILITIES``, ``ffmpeg`` on the path, the NVDEC library
   ``libnvcuvid`` (found, and whether it loads), and whether ``torchvision``, ``torchcodec``, ``av``
   and ``imageio_ffmpeg`` are installed (``find_spec``; nothing imported);
   and ``cuvidGetDecoderCaps`` (``sleap_tpu_torch.io.nvdec``) for H.264,
   HEVC, MPEG-4 Part 2 and AV1 at 8-bit 4:2:0, or the error of each call:
   where it reports H.264 at 1024^2, phase 12 decodes. Phase 12 holds the
   card route to a refusal only on the one refusal known: a container whose
   ``NVIDIA_DRIVER_CAPABILITIES`` lacks "video" (and "all"), where every
   caps call fails with CUDA_ERROR_OUT_OF_MEMORY; any other error fails
   phase 12.
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
   6b: the card's instances of 16 of those frames tracked by a card tracker
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
   sigma-8 blobs moving at most 4 px a frame over noise, one in-memory video)
   written by the port's ``write_labels`` as a ``.slp`` (raw ``video0_raw``),
   tracked by the
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
   EfficientNet-b0 UNet; kernel 1 once a batch. Each: BB_TIMED_BATCHES timed batches (FPS,
   device ms a batch from ``torch.profiler``), one batch with ``Labels``,
   and the card against the same folders loaded with ``device="cpu"`` on
   BB_CPU_FRAMES frames within PATH_XY_TOL and PATH_VAL_TOL. 10d: a library
   ``predict`` leaves the caller's TF32 flags as it found them; and
   ``python -m sleap_tpu_torch.cli.track`` in a fresh process (no TF32
   flag set by this one) on the card against ``--cpu``, on 8b's float32
   pair and on 10b's folders, within PATH_XY_TOL and PATH_VAL_TOL (the four
   processes at once).
11. Training the other backbones, and their bf16 inference, after phase 10,
   on its configs. 11a: one train step of LEAP, Hourglass (3 stacks), HRNet
   (C 18), ``resnet`` ResNet50 and the pretrained-encoder EfficientNet-b0
   and ResNet-50 UNets at full width on BB_STEP_BATCH frames of
   BB_STEP_SIZE^2, on the card and on the CPU from the same lecun-seeded
   weights, TF32 off: in float32 through the trainer (the loss held; the
   gradients and statistics printed), and in float64 on the same images and
   ground truth (loss, gradients and statistics held; every statistic
   moved). 11b: BB_TRAIN_STEPS synchronised train steps after TRAIN_WARMUP,
   float32 and mixed precision, single-instance BB_SI_IMG^2 batch
   BB_SI_BATCH on Hourglass, HRNet, LEAP, EfficientNet-b0 and ResNet50, and
   top-down pretrained-encoder ResNet-50 on crops of CROP of 1024^2 frames,
   batch TRAIN_BATCH: images/s, ms a step, peak memory, and in float32 one
   step's device ms and launches and the busy share (the mixed-precision
   steps' profiler sessions are left out: host bound); batch norm float32
   throughout. 11c: a
   batch-norm Hourglass through ``cli.train.main`` from a ``.slp`` written
   here; ``best_model.pt``'s statistics moved; the folder on the card
   (kernel 1 once a batch) finds every held-out animal within
   BB_CLI_BOUND_PX and agrees with ``device="cpu"`` within PATH_XY_TOL and
   PATH_VAL_TOL. 11d: phase 10's folders and weights with
   ``compute_dtype=torch.bfloat16`` (kernels 4, 3, 1 top-down, kernel 1
   single-instance, once a batch; batch norm float32), BB_TIMED_BATCHES timed batches and
   one profiled, the card's bf16 maps through kernel 1 against the plain
   version on the CPU (values exact, xy within XY_TOL).
12. H.264 ``.mp4`` on the card, after phase 11 (~10 s where NVDEC is
   refused). 12a: ``scripts/write_h264_fixture.py`` writes, at run time,
   100 x 72 colour and gray streams (12 frames, an IDR every 4; I_PCM and
   P_Skip macroblocks, so the decoded planes are the written ones) and a
   colour one in 4 chunks with ``co64``, 2-byte NAL lengths and a ``ctts``;
   the port's demuxer (``io/mp4.py``) must read the written sample tables,
   and ``io/yuv.py`` must convert the planes alike on the card and the CPU
   (BGR, RGB, blue alone). Where NVDEC decodes: its NV12 planes must equal
   the written ones, ``MediaVideo`` frames on the card ``yuv.py``'s on the
   CPU, and reads in the order 0, 7, 3, 3, 11, 1 the sequential reads, all
   bitwise. Where it is refused: NVDEC's parser (the binding's callbacks
   and structs) must read each stream's codec, chroma format, depth, coded
   and display size as the SPS gives them, and ``NvdecReader`` and
   ``MediaVideo`` on the card must raise ``cuvidCreateDecoder``'s
   CUDA_ERROR_OUT_OF_MEMORY and no other error, with no cv2 imported.
   12b: phase 8a's 32 frames of 1024^2 written as a gray H.264 ``.mp4`` (an
   IDR every 8); ``python -c`` running ``sleap_tpu_torch.cli.track.main``
   (``sleap-track clip.mp4 -m centroid -m instance``) in a fresh process on
   the card. Where NVDEC decodes: the output must equal ``load_model`` in
   this process on the frames the card decodes (themselves ``yuv.py``'s gray
   frames of the written planes) within CLI_TOL, with kernels 2, 3 and 1
   launched once a batch; prints the CLI's FPS beside phase 8a's and the
   decode rates (frames/s in order and at random; ms a frame in NVDEC, the
   NV12 copy, the conversion and the host copy) of this I_PCM stream, not
   an x264 one. Where NVDEC is refused: the CLI must exit non-zero on
   ``cuvidCreateDecoder``'s CUDA_ERROR_OUT_OF_MEMORY. The line
   ``{"media": {"nvdec": "decoded" or "refused", ...}}`` before the
   ``kernels`` line says which.
13. Frames in and out of users' files, after phase 12 (~30 s), with no cv2,
   h5py or yaml. 13a: phase 8a's frames, with a user instance on each blob,
   saved as a PNG training package (``Labels.save(with_images=True)``) and
   through ``save_frame_data_hdf5``, then read back through
   ``HDF5Video(device="cuda")`` (the compiled unfilter, P1): bitwise the
   written frames; P1 bitwise the numpy wavefront on
   ``scripts/png_decode_time.py``'s 1024^2 frames (each row filter, and
   mixed) and on the package's rows; prints the write seconds, encode ms a
   frame, the file sizes beside the raw ``.slp``'s, the read ms a frame and
   P1's and the wavefront's ms. 13b: the committed JPEG fixtures
   (``scripts/make_torch_jpeg_fixtures.py``): J1 and J2 give each still's
   recorded cv2 sha256 (the cut progressive ones through J6 as well), the
   host entropy decoder gives the plain version's
   coefficients on the small baseline stills (19a holds the progressive
   ones), and
   J1 and J2 give the plain PyTorch stages' output on the 1024^2 stills'
   coefficients; prints the ms a frame of the entropy decode, the copy in,
   J1, J2 and the copy out at 1024^2 gray and colour. 13c: ``sleap-track
   tests/torch_data/jpeg_pkg.slp`` with phase 4's top-down float32 folders
   in a fresh process: within CLI_TOL of ``load_model`` in this process on
   the frames J1 and J2 decode (themselves cv2's, by the recorded hashes),
   kernels 2, 3 and 1 once a batch and J1 and J2 at least once a frame;
   prints its FPS beside phase 8a's. 13d: 8 of phase 8a's frames through
   ``to_imgstore`` and ``Video.from_dict`` of its ``to_dict()``: bitwise, by
   original frame number and by position.
14. The data model on the card's Python, after phase 13 (~20 s), with no
   pandas either: phase 8a's tracked ``.slp`` (written by the CLI on the
   card) through ``Labels.load_file``: ``numpy()`` equals 8a's predicted
   arrays (frames x tracks x nodes x 2), ``remove_predictions`` on a
   ``copy()`` empties the copy and leaves the labels, ``track_swap`` over
   the first half swaps the two columns there (and back), ``describe``
   counts the frames and instances, and ``merge`` of the file into the
   labels without their last frame brings that frame back and no duplicate.
   ``python -m sleap_tpu_torch.io.convert <8a .slp> --format analysis``,
   then ``analysis.csv``, each in a fresh process: the ``.h5``'s tracks,
   read through the port's importer and its HDF5 reader, equal
   ``labels.numpy()`` exactly (occupied tracks), and the CSV holds every
   instance's points exactly. A DeepLabCut project (``config.yaml``,
   ``labeled-data/clip/imgNNNN.png`` of DLC_FRAMES of 8a's frames,
   ``CollectedData_me.csv`` of the blob centres, four individuals) read by
   ``formats.read``: its points are the centres and its PNG frames decode
   bitwise on the card; saved as ``.slp`` and tracked by ``sleap-track``
   with phase 4's float32 pair (kernels 2, 3 and 1 once a batch), its
   predictions equal 8a's on the same frames within CLI_TOL (instances
   matched by their points). Prints each step's seconds and the CLI's FPS.
5. (Run after 4d, before 4e; the launches of 4e-4g, 6, 7c, 8, 9, 10, 11, 14 and 15 join its
   rows at the end.) Time each kernel and its plain version: per call with CUDA events (50
   back-to-back calls, in turns), device time with ``torch.profiler`` (the
   kernel's own device functions over 20 calls), the bound (bytes moved at
   3.35 TB/s, or operations at the card's peak, whichever is larger) and,
   for crops, ``F.grid_sample`` on the float32 form of the same boxes.
   Kernel 1 on both the float32 and the bf16 top-down maps; a bf16
   ``find_global_peaks`` call must launch kernel 1 alone (no cast or copy).

15. ``sleap-export`` on the card, after phase 14. 15a: phase 4's float32
   top-down ``predict``-er exported (``Predictor.export_model``, batch 16,
   1024^2), loaded back with ``load_exported_model`` and run on phase 4's
   frames; 15b: the same for phase 4b's bf16 bottom-up predictor; 15c: the
   trained ``.convergence_runs`` single-instance folder (its own
   checkpoint, 4g's frames in RGB) through ``predict`` and as a program.
   Each program's arrays equal ``predict``'s on the same batches within
   EXPORT_XY_TOL px and EXPORT_VAL_TOL (largest differences printed), its
   kernels (1, 2, 3; 4; 1) launch once a batch, and its FPS is printed
   beside ``predict``'s. 15d: phase 8a's tracked ``.slp`` re-tracked by the
   tracker's ``main`` (flow) on the card and with ``--cpu``: the same
   instances and tracks, tracking scores within TRACK_SCORE_TOL; then
   ``info.trackcleaner`` to MAX_INSTANCES a frame, ``info.summary``'s series
   and ``info.metrics``' distances (0 between the two files).
16. The host modules, after phase 15 (aim: under 30 s). A child process
   for 16d and 16e starts first and runs beside 16a-16c (what may import an
   optional package runs there: PyYAML, scikit-learn, which imports attr
   and pandas, and pyzmq, while this process's JAX-side check counts yaml,
   attr and pandas). 16e: preferences saved in a temporary HOME and read
   back (or saving refused naming PyYAML where it is absent), ``util``'s
   HDF5 helpers through the port's writer and reader, and a
   ``PairedSender``/``PairedReceiver`` handshake and message on a local port
   (or the ImportError naming pyzmq). 16a:
   ``python -m sleap_tpu_torch.diagnostic`` in a fresh process names the
   card (``torch.cuda.get_device_name(0)``) and imports nothing of the JAX
   side or of OPTIONAL_PACKAGES; ``system.get_all_gpus()`` finds the card,
   ``is_accelerator_system()``, ``best_logical_device_name()`` is cuda:0,
   and ``system.summary()`` is printed. 16b: each trained head type
   (4g's folders and frames) built by ``from_trained_models`` on the card
   equals ``load_model``'s predictor exactly, kernels 1, 2 and 3 launching
   (the launches join the kernels line); ``VisualPredictor`` on phase 4's
   float32 centroid model (its folder written again, phase 4's weights;
   1024^2, batch 16, full width) and on the trained bottom-up folder: its
   maps equal the module's head outputs on the card exactly and the CPU's
   within PATH_VAL_TOL on VISUAL_CPU_FRAMES frames. 16c: 8a's tracked
   labels through ``labels_to_pose_arrays`` and
   ``tracks_numpy_to_labeled_frames`` give every point back exactly,
   ``assemble_nix_arrays`` holds every instance, and ``export_nwb``,
   ``export_nix``, ``load_nwb`` and ``sleap-convert --format nwb`` raise the
   ImportError naming pynwb or nixio (or write and read back where those
   are installed). 16d: the "raw" and "hog" features of 8a's 32 frames
   (decoded on the card), then ``image_feature_based_method`` (or its
   ImportError naming scikit-learn); which of the two happened is printed.
17. The pipeline blocks, the training pipelines, ZMQ training with its
   visualizations, MoveNet and the host helpers, after phase 16. 17a: phase
   4's float32 pair as blocks (``sleap_tpu_torch.data.inference``) over
   phase 4's frames in batches of 16: the frames scaled to the centroid
   model's input, the centroid ``ModelPredictor``, ``LocalPeakFinder``
   (kernel 2), unit crops at the centroids (kernel 3), the instance
   ``ModelPredictor``, ``GlobalPeakFinder`` (kernel 1) and, per instance,
   ``PredictedCenterInstanceNormalizer``; each kernel launches once a
   timed batch (the launches join the kernels line), the card equals the
   CPU within PATH_XY_TOL / PATH_VAL_TOL on 4 frames, and
   ``MockGlobalPeakFinder`` is exact on phase 7's ground truth. 17b: the
   six builders' ``make_training_pipeline`` (``data/pipelines.py``) on 24
   frames of phase 7's recipe with tracks, batch 16, two batches each:
   equal to the trainer's ``make_batch`` and ``build_gt_fn`` exactly, the
   first within PIPE_CPU_TOL of the CPU's. 17c: ``cli.train.main --zmq``
   of phase 9's centroid profile (4 epochs of 5 batches) with a monitor
   thread holding a SUB and a PUB: ``set_lr`` after the first epoch and
   ``stop`` after the second; the events in order, the log's learning
   rates, the early stop, the folder loading, and ``viz/epoch_NNN.png``
   where matplotlib imports (none where it does not). 17d:
   ``MoveNetPredictor`` ("lightning", "thunder") with a seeded stand-in
   model computing on the card, on 8 gray 1024^2 and 8 RGB 640 x 480
   frames, equal to the CPU's exactly; ``load_model("movenet-thunder")``'s
   offline error; whether tensorflow is installed (never imported). 17e:
   ``match_points`` on card tensors equal to the CPU's, a Shuffler ->
   Batcher -> Prefetcher -> Unbatcher chain over 8a's ``.slp``, and a
   skeleton preview PNG where matplotlib imports.
18. JPEG encoding, after phase 17 (aim: 15-40 s). 18a: the committed
   stills but the progressive one, decoded on the card (phase 13 holds that
   decode to cv2's), and crops (W x H) of the 1024^2 ones to 1x1, 3x50,
   17x33 and 1023x1021, encoded on the card (``jpeg.imencode``: J3
   ``jpeg_ycc_kernel``, J4 ``jpeg_fdct_kernel``, the host entropy coder) to
   the sha256 that ``scripts/make_torch_jpeg_fixtures.py`` recorded from
   cv2 (``tests/torch_data/jpeg/encoded.json``); the host coder equals the
   plain one on the frames of up to ENCODE_PLAIN_BLOCKS blocks; J3 and J4
   equal ``ycc_plain`` and ``fdct_plain`` exactly at 1024^2 gray and
   colour; prints the ms of a 1024^2 frame by stage, each kernel's device
   and per-call time, the plain stages' and the bound. 18b: phase 8a's 32
   frames saved on the card as a JPEG ``.pkg.slp`` and a JPEG ImgStore
   (J3 and J4 once a frame each; their launches join the kernels line):
   the first ENCODE_CPU_ROWS rows and files are the CPU route's bytes,
   every frame reads back through J1 and J2 as ``imdecode`` of its own row;
   prints write seconds and MB. 18c: ``python -m sleap_tpu_torch.io.visuals``
   on 8a's tracked ``.slp`` in two fresh processes started together, whose
   imports of cv2 and imageio fail (as on a machine with neither): at the
   defaults and with ``--scale 0.5 --crop 256,256 --background black``;
   the writer chosen (the Motion-JPEG one) is printed, each AVI holds 32
   ``00dc`` chunks, each the card's ``imencode`` of the frame
   ``save_labeled_video`` draws on the CPU route (the first
   RENDER_CPU_CHUNKS the CPU route's encode too), J3 and J4 once a frame
   (the launches join the kernels line); prints the render FPS. Then
   ``render_frame`` on ``tests/torch_data/jpeg_pkg.slp``'s 16 frames
   (decoded by J1 and J2) at scale 1 and 0.5 gives the JAX package's
   recorded sha256 (``rendered.json``).
19. Still images, after phase 18 (aim: 15-30 s). 19a: the committed
   progressive JPEGs (``tests/torch_data/jpeg/*progressive*``: cv2's and
   PIL's scan scripts, gray, 4:2:0, 4:2:2, 4:4:4, restarts, odd sizes,
   1024^2) through the card's route (the host progressive entropy decoder,
   J1, J2; J6 for the cut ones) to ``decoded.json``'s cv2 sha256; J1 and
   J2 once a decoded frame (counts zeroed
   just before, read just after; they join the kernels line); the host
   progressive coefficients equal the plain decoder's on the stills of up
   to JPEG_PLAIN_BLOCKS blocks; a 1024^2 progressive frame's ms (host
   entropy decode, J1 + J2 on the device, whole frame) beside the baseline
   1024^2 frame's. 19b: every committed BMP and TIFF still
   (``tests/torch_data/stills``, ``scripts/make_torch_still_fixtures.py``)
   decoded on the card's route (TIFF's LZW and PackBits in host C) to
   ``decoded.json``'s cv2 sha256 and dtype, or refused naming its feature;
   the host C LZW and PackBits equal the plain ones both ways on the strips
   of the 1024^2 TIFF; decode ms a 1024^2 frame, card route and CPU route.
   19c: ``encoded.json``'s write cases encoded on the card's route to
   cv2's sha256; phase 8a's 32 gray 1024^2 frames saved as a TIFF
   ``.pkg.slp`` (``Labels.save(image_format="tif")``) and as BMP and TIFF
   ImgStores (``to_imgstore``), read back on the card bitwise; prints write
   seconds and MB. 19d: ``sleap-track`` (in this process) on the TIFF
   package and on a PNG package of the same frames with phase 4's float32
   pair on the card: the same predictions exactly (the pixels are the
   same), kernels 2, 3 and 1 once a batch; prints the FPS.

20. Users' own HDF5 files, after phase 19 (aim: under 20 s). 20a: every
   object of the committed fixtures (``tests/torch_data/hdf5``,
   ``scripts/make_torch_hdf5_fixtures.py``: ``libver="latest"`` files with
   dense links and attributes, the five chunk indexes, lzf, fletcher32,
   scale-offset, links, committed types and references, an earliest-format
   one, and ``latest_raw.slp``, whose frames a SWMR writer appended) read
   with ``hdf5.File(..., device="cuda")`` (LZF in host C,
   ``sleap_hdf5_lzf_decode``) to what h5py read (``manifest.json``), each
   refused feature (a region reference, the nbit filter) raised by name.
   20b: every LZF chunk decoded by the host C decoder and the plain one to
   the same bytes; ms a 384^2 frame and MB/s on each route. 20c:
   ``sleap-track`` (in this process) with phase 8b's trained top-down pair
   on ``latest_raw.slp`` and on ``raw.slp``, cuDNN's algorithms set
   deterministic for both (at its defaults two runs of the pair on one file
   differ by up to 3.05e-5 px): the same predictions exactly,
   kernels 2, 3 and 1 once a batch (counted into the kernels line as "CLI
   latest_raw.slp (20c)"); prints each one's FPS and ms a frame read.

21. Users' AVI videos, after phase 20. 21a: every committed AVI
   (``tests/torch_data/avi``, ``scripts/make_torch_avi_fixtures.py``: cv2's
   and OpenCV's Motion-JPEG writers, PIL's gray, 4:2:2 and 4:4:4 JPEGs,
   DHT-less AVI1 frames, OpenDML, no ``idx1``, ``LIST 'rec '`` with audio,
   zero-length chunks, raw ``BI_RGB`` and ``Y800`` frames, the IDCT probe
   clip) through ``MediaVideo``'s card route, colour and gray, in order and
   at random, to cv2's (FFmpeg backend) recorded frames (``manifest.json``)
   with cv2's frame count and fps; the odd-height 4:2:0 one refused by name;
   J5 (``jpeg_idct_ffmpeg_kernel``, FFmpeg's IDCT) equal to its plain
   version on every Motion-JPEG frame up to AVI_PLAIN_BLOCKS blocks;
   DHT-less copies of the baseline JPEG stills decoded on the card to cv2's
   frames; ms a 1024^2 frame by stage (host entropy decoding, copy in, J5,
   conversion, copy out), gray and 4:2:0. 21b: ``sleap-track gray_1024.avi``
   (8 gray 1024^2 Motion-JPEG frames) with phase 8b's trained top-down pair
   in a fresh process against ``load_model`` in this one on the frames the
   card decodes (held to cv2's hashes), within CLI_TOL; kernels 2, 3 and 1
   once a batch of 4, J5 once a decoded frame (counted into the kernels
   line as "CLI clip.avi (21b)"); prints its FPS beside 12b's and 13c's.

22. Every still cv2 reads, after phase 21 (aim: under 15 s). The stills
   of this slice (``scripts/make_torch_still_fixtures.py`` and
   ``scripts/make_torch_jpeg_fixtures.py``: TIFF orientations, signed and
   wide samples, min-is-white, palettes, bilevel and CCITT pages, YCbCr,
   CMYK, gray and alpha, JPEG-in-TIFF; 4:4:0, 4:1:1, RGB, CMYK and YCCK
   JPEGs and progressive ones cut short) decode on the card's route to the
   recorded cv2 sha256 in 13b (JPEG) and 19b (TIFF). 22a: on each JPEG
   still whose parsed header reaches what this slice added to the kernels
   (a colour space other than gray or YCbCr, an upsampling other than
   4:4:4, 4:2:2 or 4:2:0, four components, block smoothing), J6
   (``jpeg_smooth_kernel``, libjpeg-turbo's block smoothing), J1 and J2
   (``jpeg_color_kernel``, its new colour modes and upsamplings) bitwise
   equal to ``smooth_plain``, ``idct_plain`` and ``color_plain``; the host
   CCITT decoder equal to the plain one on every TIFF of compression 2-4;
   ms a 1024^2 frame of the four frames of animals (4:4:0 JPEG, cut
   progressive JPEG, JPEG-in-TIFF, CCITT Group 4), the host stage split
   out, and J6's device ms, per-call ms, plain ms and bound. 22b: top-down
   ``predict`` with phase 4g's trained pair over a ``SingleImageVideo`` of
   those four (on the card) against the same frames as a ``NumpyVideo``:
   the same predictions exactly (cuDNN deterministic), kernels 2, 3 and 1
   once (one batch), J1 and J2 once a JPEG stream (each JPEG, each strip
   of the JPEG-in-TIFF: 18), J6 once a smoothed one (counted into the
   kernels line as "SingleImageVideo 1024^2 stills (22b)"). No rate is
   taken from one batch.

23. Data-parallel inference and training (``sleap_tpu_torch.parallel``),
   after phase 22, on a mesh naming the card twice (two replicas, or two
   ranks over gloo) and, where the machine has two cards, on ``cuda:0`` and
   ``cuda:1`` too (NCCL); each mesh and backend is printed first. 23a:
   phase 4's float32 top-down pair through ``make_sharded_predictor`` at 16
   frames a replica (a global batch of 32) on 96 of phase 4's frames after
   a warm-up batch, against the unsharded predictor at 32: points within
   1e-3 px (the JAX package's ``tests/test_parallel.py`` bound) with the
   same NaNs, kernels 2, 3 and 1 launched once a replica a batch (counted
   into the kernels line as "sharded top-down (23a, ...)"); both FPS.
   23b: phase 4b's bf16 bottom-up the same way at 512^2, 4 frames a
   replica (kernel 4). 23c: two-rank training against one process on the
   card, on phase 7's centroid UNet at full width (global batch 16, 3
   steps), through ``Trainer.train()`` with ``devices`` naming the mesh
   (the caller rank 0, a spawned rank 1), and on a pretrained-encoder
   ResNet-18 with batch norm throughout and hard keypoint mining (random
   weights, 512^2, global batch 8, 2 steps) on the two ranks phase 24
   starts before 23c, which open their group once and each call
   ``Trainer.from_config(..., n_devices=2).train()`` (as ``torchrun``
   ranks do: one rank start paid, not three), one train and one
   validation step an epoch: per-step losses
   within 1e-5 relative (the ResNet in float32: its first step's; it runs
   in float64 too, as phase 11a's float64 step does, all steps), weights
   and running statistics within rtol 2e-3, atol 2e-4, one run folder
   (rank 0's); ``train()`` seconds and epoch seconds beside one process's.

24. Spatially sharded training (``sleap_tpu_torch.parallel.spatial``),
   after phase 23: 23c's three runs on a ``(1, 2)`` mesh, each rank a
   horizontal band of every frame and map (the card named twice over gloo;
   and ``cuda:0``, ``cuda:1`` over NCCL where there are two cards), as
   ``torchrun`` runs ranks: two spawned processes, started before 23c,
   train 23c's ResNet runs in their group, then each calls
   ``Trainer.from_config(..., n_devices=2, spatial_sharding=2).train()``
   for every run, so their start is paid once; held to 23c's one-process runs (losses: float64 every step
   1e-5, float32 the first step 1e-5 and every step 1e-4; weights and
   statistics rtol 2e-3, atol 2e-4; one run folder, rank 0's), each rank
   saving less for its backward
   than one process; ``train()`` seconds, each rank's peak memory and the
   bytes its first step saves for the backward beside one process's.

25. Users' QuickTime and Matroska videos, after phase 24 (aim: under
   20 s). 25a: every committed fixture of ``tests/torch_data/containers``
   (``scripts/make_torch_container_fixtures.py``: cv2's Motion-JPEG in
   ``.mov`` and ``.mkv``, an ``mjpa`` entry, edit lists that trim the
   start, begin with an empty edit, cut out a frame, come as version 1 or
   start between sync samples, and under ``ctts`` offsets; Matroska
   without Cues, with BlockGroups, an unknown-size cluster, header
   stripping, the three lacings,
   ``V_MS/VFW/FOURCC``, a short and a missing ``Duration``; an AVI named
   ``.mkv`` and Matroska named ``.mov``) through ``MediaVideo``'s card
   route, picked by content, colour and gray, in order and at random, to
   cv2's recorded frames with cv2's count and fps; J5 equal to its plain
   version on every Motion-JPEG frame up to AVI_PLAIN_BLOCKS blocks; the
   H.264 fixtures (the I_PCM stream in Matroska, and in an ``.mp4`` whose
   edit list trims 2 frames) meet phase 12's NVDEC refusal exactly where
   the machine refuses it, else give cv2's frames. 25b: ``sleap-track`` in
   this process on ``gray_1024.mov`` and ``gray_1024.mkv`` (21b's 8 JPEG
   payloads, byte for byte) with phase 8b's trained pair, cuDNN
   deterministic: predictions equal to 21b's on ``gray_1024.avi``, kernels
   2, 3 and 1 once a batch, J5 once a decoded frame (counted into the
   kernels line as "CLI gray_1024.mov (25b)" and "... .mkv (25b)"); FPS
   beside 21b's and ms a 1024^2 frame by stage (demux, entropy decoding,
   copy in, J5, conversion, copy out) for each container.
26. MPEG-4 Part 2 on the card (``io/mpeg4.py``: host C entropy decoding,
   M1 intra, M2 P-VOP and M3 B-VOP blocks, each with FFmpeg's simple IDCT
   or Xvid's). 26a: every ``tests/torch_data/mpeg4`` fixture (cv2's
   streams in AVI, ISO-BMFF and Matroska; the writer's I/P streams, B-VOPs
   of every kind, GOVs, Xvid's and DivX's user data, packed bitstreams,
   intra VOPs of chosen coefficients) through ``MediaVideo``'s card route,
   in order and at random, to cv2's recorded frames, count and fps, the
   six kernels' counts zeroed before and each launched; the host C decoder
   equal to the plain one and M1, M2 and M3 to their plain versions (max
   |err| 0) on every VOP of MPEG4_PLAIN (B-VOPs included) and at 1024^2
   (the 26b clip's first I- and P-VOP, the Xvid clip's first I-, P- and
   B-VOP, M3 with both IDCTs), with each kernel's ms; ms a 1024^2 frame by
   stage and frames/s over sequential reads of both clips. 26b:
   ``sleap-track`` on ``fmp4_gray_1024.avi`` with phase 8b's trained pair,
   predictions equal to ``load_model``'s on the decoded frames, M1 and M2
   launched; 26c: the same on ``xvid_gray_1024.avi`` (I, P and B-VOPs,
   Xvid's IDCT), the Xvid forms of M1, M2 and M3 launched.

Then a JSON line of phase 7's numbers, one of phase 11's, one of phase 12's,
one of phase 13's, one of phase 14's, one of phase 15's, one of phase 16's,
one of phase 17's, one of phase 18's, one of phase 19's, one of phase
20's, one of phase 21's, one of phase 22's, one of phase 23's, one of
phase 24's, one of phase 25's and one of phase 26's; the line
before the last is a
JSON object with each kernel's launches (J1 and J2 from phase 13c's, 19a's
and 22b's runs, J3 and J4 from 18b's and 18c's, J5 from 21b's and 25b's,
J6 from 22b's, M1, M2 and M3 from 26a's, 26b's and 26c's)
(all paths' and per path, 23a/23b's replicas too), error and times; the last
line is ``{"ok": true,
"device": {...}}``.
"""

import csv
import dataclasses
import importlib
import itertools
import json
import math
import os
import re
import shutil
import struct
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
# flow points that differ by ~1e-5 px) and flow-shifted points. 6a times the
# tracked path over TRACK_TIMED_BATCHES batches after a warm-up one (fewer
# than the paths' TIMED_BATCHES: the tracker's ~84 ms a frame on the host
# makes each batch ~1.3 s).
TRACK_MAX_STEP, CARD_CPU_FRAMES, TRACK_TIMED_BATCHES = 4.0, 16, 4
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
# Phase 12: H.264 .mp4 read on the card. 12a: the fixture writer's small
# streams (MEDIA_SMALL, IDR every MEDIA_IDR frames) and the read order that
# seeks; 12b: CLI_FRAMES of phase 8a's frames as a gray .mp4 (an IDR every
# MEDIA_CLI_IDR frames) through ``sleap-track`` in a fresh process against
# ``load_model`` in this one, within CLI_TOL.
MEDIA_SMALL, MEDIA_FRAMES, MEDIA_IDR, MEDIA_CLI_IDR = (100, 72), 12, 4, 8
MEDIA_SEEK_ORDER = (0, 7, 3, 3, 11, 1)

# Phase 13: the JPEG fixtures (``scripts/make_torch_jpeg_fixtures.py``) and
# package; stills of at most JPEG_PLAIN_BLOCKS blocks also go through the
# plain (Python) entropy decoder; 13d stores these of phase 8a's frames.
JPEG_DIR = ("tests", "torch_data", "jpeg")
JPEG_PKG = ("tests", "torch_data", "jpeg_pkg.slp")
JPEG_PLAIN_BLOCKS = 5000
IMGSTORE_FRAMES = (0, 3, 5, 9, 14, 20, 26, 31)
# Phase 20: the HDF5 fixtures (``scripts/make_torch_hdf5_fixtures.py``).
HDF5_DIR = ("tests", "torch_data", "hdf5")
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
# 11b's timed steps and phase 10's timed batches (were 20 and 8, as phase
# 7's and phase 4's): the script must fit its recipe's time limit, and these
# host-bound loops swing most with the machine.
BB_TRAIN_STEPS, BB_TIMED_BATCHES = 5, 3
BB_CLI_IMG, BB_CLI_FRAMES, BB_CLI_HELD_OUT, BB_CLI_BATCH = 256, 32, 12, 4
BB_CLI_STACKS, BB_CLI_SIGMA = 1, 5.0
BB_CLI_EPOCHS, BB_CLI_BATCHES, BB_CLI_LR = 20, 40, 1e-3
BB_CLI_BOUND_PX = 5.0

# Phase 15: an exported program against ``predict`` on the same frames, on
# the card: the same kernels on the same maps, so refined points within the
# kernels' tolerance and values within VAL_TOL's order.
EXPORT_XY_TOL, EXPORT_VAL_TOL = 1e-4, 1e-5

# The JAX side and what only it needs: the port imports none of these.
JAX_SIDE = ("jax", "jaxlib", "flax", "orbax", "sleap_tpu", "networkx", "attr", "attrs", "h5py", "cv2",
            "zstandard", "tensorstore", "yaml", "imgstore", "pandas", "tensorflow")

# The card's peaks (H100 SXM data sheet): memory rate, and float32 outside
# the tensor cores for the kernels' few operations per byte.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def timed_phase(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, printing the phase's seconds on a line of
    their own."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"phase {name} took {time.perf_counter() - t0:.1f} s")
    return out


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


def events_ms(fn, iters=20) -> float:
    """ms a call of ``fn`` by CUDA events over ``iters`` calls, after one."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
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


def check_cli_full_width(td, wrappers, launches, card, keep=None):
    """Phase 8a: a 1024^2 clip written as .slp (one in-memory video of 32
    frames), tracked by the CLI on phase 4's float32 top-down folders,
    against ``load_model(..., tracker="flow")`` in this process; returns the
    figures it prints. With ``keep`` (a dict holding a directory under
    "dir"), the clip and the CLI's output move there, and ``keep`` gains
    their paths ("clip", "slp") and the predicted labels read back
    ("labels") for phase 14."""
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
        video = Video.from_numpy(frames)
        write_labels(clip, Labels([LabeledFrame(video, i) for i in range(CLI_FRAMES)]))
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
        if keep is not None:
            keep["clip"] = shutil.move(clip, os.path.join(keep["dir"], "clip.slp"))
            keep["slp"] = shutil.move(out, os.path.join(keep["dir"], "clip.predictions.slp"))
            keep["labels"] = got
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
        png.imdecode(row, device="cpu")
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
            out = png.decode(data, device="cpu")
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


def labels_of(frames, points, tracked=False):
    """The port's Labels: ``frames`` (n, H, W, 1) uint8 and ``points``
    (n, animals, N_NODES, 2) user instances; with ``tracked``, animal a is
    on track "animal{a}" in every frame."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame, Track
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io.video import Video

    skeleton, video = chain_skeleton(), Video.from_numpy(frames)
    tracks = [Track(0, f"animal{a}") if tracked else None for a in range(points.shape[1])]
    return Labels([LabeledFrame(video, i, [Instance(skeleton, p, track=t) for p, t in zip(pts, tracks)])
                   for i, pts in enumerate(points)])


def phase7_recipe(n, seed=0):
    """Phase 7's frames and animals: ``n`` uniform noise frames of IMG^2 and
    3 animals a frame at uniform points 100 px inside."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, IMG, IMG, 1), np.uint8)
    return frames, rng.uniform(100, IMG - 100, (n, 3, N_NODES, 2))


def bench_trainer(head, mixed_precision=False):
    """A trainer of ``bench.py``'s config on the card (the default device),
    set up on its 4 labeled frames of 3 instances."""
    from sleap_tpu_torch.training.trainer import Trainer

    labels = labels_of(*phase7_recipe(4))
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


def time_train_steps(name, trainer, batch, card, steps=TRAIN_STEPS, profile=True):
    """Warm-up steps, then ``steps`` timed steps ending in a synchronise;
    with ``profile``, one step's device time and launches from
    ``torch.profiler`` (else None: not measured). Images/s counts the
    batch's frames."""
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
    res = {
        "images_per_s": n_images * 1e3 / step_ms,
        "step_ms": step_ms,
        "device_step_ms": None,
        "device_busy": None,
        "launches_per_step": None,
        "max_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]),
        "top_kernels": None,
    }
    check(all(bool(torch.isfinite(l)) for l in losses), f"{name}: finite losses")
    device = "device not measured"
    if profile:
        events = repeated_events(lambda: trainer.train_step(batch, gen))
        device_step_ms = sum(e.self_device_time_total for e in events) / 1e3
        res.update(device_step_ms=device_step_ms, device_busy=device_step_ms / step_ms,
                   launches_per_step=sum(e.count for e in events),
                   # The step's largest device functions: (name, ms, launches).
                   top_kernels=[(e.key[:80], e.self_device_time_total / 1e3, e.count)
                                for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]])
        device = (f"device {device_step_ms:.2f} ms a step ({100 * res['device_busy']:.1f} % busy), "
                  f"{res['launches_per_step']} launches a step")
    log(f"{name}: {res['images_per_s']:.1f} images/s, {step_ms:.2f} ms a step over {steps} "
        f"steps (batch {n_images}); {device}; peak memory {res['max_memory_gib']:.2f} GiB; loss "
        f"{res['first_loss']:.6f} -> {res['last_loss']:.6f} ({card})")
    if profile:
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
            h5.create_dataset("video", data=frames, compression=None)
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
    si_frames = synthetic_frames((1 + BB_TIMED_BATCHES) * BB_SI_BATCH, seed=10, size=BB_SI_IMG,
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
    BB_CPU_FRAMES frames of 1024^2, the four processes at once; the two
    within PATH_XY_TOL and PATH_VAL_TOL."""
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
        # All four processes at once (each mostly imports torch and loads).
        procs = {}
        t0 = time.perf_counter()
        for k, (name, src, models) in enumerate(cases):
            for flag in ((), ("--cpu",)):
                out = os.path.join(root, f"{k}{''.join(flag)}.slp")
                procs[k, flag] = (out, subprocess.Popen(
                    [sys.executable, "-m", "sleap_tpu_torch.cli.track", src, *models,
                     "--verbosity", "none", *flag, "-o", out],
                    cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for (k, flag), (out, proc) in procs.items():
            _, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"10d {cases[k][0]} {flag}: exit {proc.returncode}: "
                  f"{stderr[-2000:]}")
        figures["processes_s"] = time.perf_counter() - t0
        for k, (name, src, models) in enumerate(cases):
            got, want = (read_labels(procs[k, flag][0]) for flag in ((), ("--cpu",)))
            n = sum(len(lf.instances) for lf in got)
            check(n >= len(got) > 0, f"10d {name}: instances in every frame")
            d = compare_predictions(got, want, PATH_XY_TOL, PATH_VAL_TOL,
                                    f"10d {name}: fresh-process CLI, card vs --cpu")
            figures[name] = {"instances": n, "max_abs_dxy": d[0], "max_abs_dscore": d[1]}
            log(f"10d fresh-process CLI {name}, card vs --cpu: {n} instances; max |dxy| "
                f"{d[0]:.3g}, max |dscore| {d[1]:.3g} ({card})")
        log(f"10d four fresh processes at once: {figures['processes_s']:.1f} s ({card})")
    return figures


def decoder_probe():
    """What the card's machine offers to decode H.264, printed only
    (ROADMAP queue 1, item 3g): installs nothing, imports nothing heavy,
    never fails the run."""
    import ctypes
    import ctypes.util
    import importlib.util

    try:
        ctypes.CDLL("libnvcuvid.so.1")
        nvcuvid_loads = True
    except OSError as e:
        nvcuvid_loads = f"no: {e}"
    try:
        with open("/proc/version") as f:
            kernel = f.read().strip()
    except OSError:
        kernel = None
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    probe = {
        "kernel": kernel,
        "driver": driver,
        "NVIDIA_DRIVER_CAPABILITIES": os.environ.get("NVIDIA_DRIVER_CAPABILITIES"),
        "ffmpeg": shutil.which("ffmpeg"),
        "find_library(nvcuvid)": ctypes.util.find_library("nvcuvid"),
        "CDLL(libnvcuvid.so.1)": nvcuvid_loads,
        "find_spec": {name: importlib.util.find_spec(name) is not None
                      for name in ("torchvision", "torchcodec", "av", "imageio_ffmpeg")},
    }
    log(f"decoder probe: {json.dumps(probe)}")
    return probe


def decoder_caps():
    """Phase 1: ``cuvidGetDecoderCaps`` for H.264, HEVC, MPEG-4 Part 2 and
    AV1 at 8-bit 4:2:0, printed, or the error each call raised (a CUDA
    error's call and CUresult kept apart). Never fails: phase 12 reads the
    result (:func:`nvdec_mode`)."""
    from sleap_tpu_torch.io import nvdec

    caps = {}
    for codec in ("H264", "HEVC", "MPEG4", "AV1"):
        try:
            caps[codec] = nvdec.decoder_caps(codec)
        except nvdec.CudaError as e:
            caps[codec] = {"call": e.call, "result": e.result, "error": str(e).split(". ")[0]}
        except Exception as e:  # noqa: BLE001 - printed here, failed in phase 12
            caps[codec] = {"error": f"{type(e).__name__}: {e}"}
    free, total = torch.cuda.mem_get_info()
    log(f"NVDEC caps (8-bit 4:2:0): {json.dumps(caps)} (device memory free "
        f"{free / 1e9:.1f} of {total / 1e9:.1f} GB)")
    return caps


def nvdec_mode(caps, capabilities):
    """How phase 12 holds the card route, from phase 1's caps and the
    container's ``NVIDIA_DRIVER_CAPABILITIES``: "decoded" where NVDEC
    reports H.264 at IMG^2, "refused" only on the one refusal known (the
    variable set without "video" or "all", and every caps call failing
    with CUDA_ERROR_OUT_OF_MEMORY); anything else fails the phase, so a
    fault of the binding never passes for a refusal."""
    from sleap_tpu_torch.io import nvdec

    h264 = caps["H264"]
    if "supported" in h264:
        check(bool(h264["supported"]) and min(h264["max_width"], h264["max_height"]) >= IMG,
              f"12: NVDEC reports H.264 8-bit 4:2:0 unsupported at {IMG}^2: {h264}")
        return "decoded"
    granted = capabilities is None or bool({"video", "all"} & set(capabilities.split(",")))
    refused = all(c.get("call") == "cuvidGetDecoderCaps"
                  and c.get("result") == nvdec.CUDA_ERROR_OUT_OF_MEMORY for c in caps.values())
    check(refused and not granted,
          f"12: cuvidGetDecoderCaps fails ({json.dumps(caps)}) with NVIDIA_DRIVER_CAPABILITIES="
          f"{capabilities!r}; only CUDA_ERROR_OUT_OF_MEMORY from every call where the container "
          f"is not granted 'video' is taken for a refusal")
    return "refused"


# --------------------------------------------------------------------------- #
# Phase 12: H.264 .mp4 on the card (demuxer, NVDEC, OpenCV's colour rule)
# --------------------------------------------------------------------------- #


def h264_writer():
    """``scripts/write_h264_fixture.py``, the fixture writer (test support)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import write_h264_fixture

    return write_h264_fixture


def nv12_planes(nv12, height):
    """An NV12 tensor on the card -> numpy Y, U, V."""
    from sleap_tpu_torch.io import yuv

    return [p.cpu().numpy() for p in yuv.split_nv12(nv12, height)]


def check_demuxer(demux, table, planes, what):
    """The demuxer's tables equal the writer's; ``yuv.py`` on the card
    equals it on the CPU, bitwise, over the written planes."""
    from sleap_tpu_torch.io import yuv

    read = (demux.sizes, demux.offsets, demux.sync, demux.cts)
    written = (table["sizes"], table["offsets"], table["sync"], table["ctts"])
    check(all(np.array_equal(a, b) for a, b in zip(read, written)),
          f"{what}: the demuxer reads the written sample table")
    for channels in ("bgr", "rgb", "b"):
        cpu = yuv.yuv420_to_bgr(*(torch.from_numpy(p) for p in planes), channels=channels)
        card = yuv.yuv420_to_bgr(*(torch.from_numpy(p).cuda() for p in planes), channels=channels)
        check(torch.equal(card.cpu(), cpu), f"{what}: yuv.py {channels} on the card and the CPU")


def is_refusal(e, nvdec):
    """The one refusal known: ``cuvidCreateDecoder`` failing with
    CUDA_ERROR_OUT_OF_MEMORY."""
    return (isinstance(e, nvdec.CudaError) and e.call == "cuvidCreateDecoder"
            and e.result == nvdec.CUDA_ERROR_OUT_OF_MEMORY)


def check_refused(path, demux, what):
    """NVDEC refused on this machine: the parser still reads the stream's
    sequence (codec, chroma format, depth, coded and display size: the
    binding's structs on the card), and the card route raises
    ``cuvidCreateDecoder``'s CUDA_ERROR_OUT_OF_MEMORY and no other error,
    with no fallback to cv2."""
    from sleap_tpu_torch.io import nvdec
    from sleap_tpu_torch.io.video import MediaVideo

    reader = nvdec.NvdecReader(demux)
    try:
        try:
            reader.frame(0)
            raise RuntimeError(f"{what}: NVDEC decoded a frame on a machine that refuses it")
        except nvdec.CudaError as e:
            check(is_refusal(e, nvdec), f"{what}: the reader meets the refusal: {e}")
        fmt = demux.format
        want = {"codec": nvdec.CODECS["H264"], "chroma_format": 1, "bit_depth": 8,
                "coded": (fmt["coded_width"], fmt["coded_height"]),
                "display": (0, 0, fmt["width"], fmt["height"])}
        got = {k: reader.sequence[k] for k in want} if reader.sequence else None
        check(got == want, f"{what}: NVDEC's parser reads the sequence {got}, the SPS says {want}")
    finally:
        reader.close()
    video = MediaVideo(path)
    try:
        video.get_frame(0)
        raise RuntimeError(f"{what}: MediaVideo on the card returned a frame without NVDEC")
    except nvdec.CudaError as e:
        check(is_refusal(e, nvdec), f"{what}: MediaVideo on the card meets the refusal: {e}")
    check("cv2" not in sys.modules, f"{what}: the card route imported cv2")


def check_media_fixtures(card, mode):
    """12a: the writer's 100 x 72 colour and gray streams (IDR every
    MEDIA_IDR) and a colour one in several chunks with ``co64``, 2-byte NAL
    lengths and a ``ctts``: the demuxer reads the written tables and
    ``yuv.py`` converts alike on the card and the CPU. Where NVDEC decodes,
    its NV12 planes equal the written ones, ``MediaVideo`` frames on the
    card equal ``yuv.py`` on the CPU over the written planes, and reads in
    MEDIA_SEEK_ORDER equal sequential reads, all bitwise; where it is
    refused, :func:`check_refused`. Returns the figures it prints."""
    from sleap_tpu_torch.io import mp4, nvdec, yuv
    from sleap_tpu_torch.io.video import MediaVideo

    w = h264_writer()
    width, height = MEDIA_SMALL
    cases = {
        "colour": ({"seed": 0}, {}),
        "gray": ({"seed": 1, "gray": True}, {}),
        "colour co64, 4 chunks, 2-byte lengths, ctts": (
            {"seed": 2}, {"co64": True, "chunks": [3, 3, 2, 4], "nal_length_size": 2,
                          "ctts": [1] * MEDIA_FRAMES}),
    }
    figures = {}
    with tempfile.TemporaryDirectory() as root:
        for name, (planes_kw, container) in cases.items():
            path = os.path.join(root, f"{len(figures)}.mp4")
            y, u, v = w.moving_planes(MEDIA_FRAMES, width, height, **planes_kw)
            table = w.write_h264_mp4(path, y, u, v, idr_every=MEDIA_IDR, **container)
            demux = mp4.Mp4Video.open(path)
            check_demuxer(demux, table, (y, u, v), f"12a {name}")
            figures[name] = {"frames": MEDIA_FRAMES, "sync": int(sum(table["sync"])),
                             "bytes": int(sum(table["sizes"]))}
            if mode == "refused":
                check_refused(path, demux, f"12a {name}")
                continue
            reader = nvdec.NvdecReader(demux)
            try:
                for i in range(MEDIA_FRAMES):
                    got = nv12_planes(reader.frame(i), height)
                    check(all(np.array_equal(a, b[i]) for a, b in zip(got, (y, u, v))),
                          f"12a {name}: NVDEC's planes of frame {i} are the written ones")
            finally:
                reader.close()
            video = MediaVideo(path)
            gray = planes_kw.get("gray", False)
            check(video.is_grayscale == gray and video.frames == MEDIA_FRAMES
                  and (video.height, video.width) == (height, width) and video.fps == 30.0,
                  f"12a {name}: gray {video.is_grayscale}, {video.frames} frames of "
                  f"{video.width}x{video.height} at {video.fps} fps")
            seq = [video.get_frame(i) for i in range(MEDIA_FRAMES)]
            want = yuv.yuv420_to_bgr(*(torch.from_numpy(p) for p in (y, u, v)),
                                     channels="b" if gray else "rgb").numpy()
            check(np.array_equal(np.stack(seq), want),
                  f"12a {name}: the card's frames are yuv.py's on the CPU")
            video.reset()
            for i in MEDIA_SEEK_ORDER:
                check(np.array_equal(video.get_frame(i), seq[i]),
                      f"12a {name}: frame {i} read out of order equals the sequential read")
            video.reset()
    done = ("NVDEC's planes, the card's frames and reads in the order "
            f"{list(MEDIA_SEEK_ORDER)} bitwise" if mode == "decoded" else
            "NVDEC refused on this machine: its parser reads each sequence, the card route "
            "raises cuvidCreateDecoder's CUDA_ERROR_OUT_OF_MEMORY, no cv2; frames not measured")
    log(f"12a the writer's {width}x{height} streams ({', '.join(cases)}): demuxer tables and "
        f"yuv.py card vs CPU bitwise; {done} ({card})")
    return figures


def decode_rates(path, n, card):
    """Frames/s of ``MediaVideo`` on the card reading ``path`` in order and
    in a seeded random order, and the ms a frame spent in NVDEC's parse
    and decode, the copy of the mapped NV12 surface, the conversion and the
    host copy (sequential read)."""
    from sleap_tpu_torch.io import yuv
    from sleap_tpu_torch.io.video import MediaVideo

    rates = {}
    for order_name, order in (("sequential", list(range(n))),
                              ("random", np.random.default_rng(0).permutation(n).tolist())):
        video = MediaVideo(path, grayscale=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video._reader  # the demuxer's tables and the parser; the decoder comes with frame 0
        rates[f"{order_name}_open_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i in order:
            video.get_frame(i)
        rates[f"{order_name}_fps"] = n / (time.perf_counter() - t0)
        if order_name == "sequential":
            timing = video._reader.timing
            copy_ms = 1e3 * timing["copy_s"] / timing["frames"]
            parse_ms = 1e3 * timing["parse_s"] / timing["frames"]
            nv12 = video._reader.frame(n - 1)
            t0 = time.perf_counter()
            frame = yuv.nv12_to_frame(nv12, video._reader.height, "b")
            torch.cuda.synchronize()
            convert_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            frame.cpu().numpy()
            host_ms = 1e3 * (time.perf_counter() - t0)
            rates.update(decode_ms=parse_ms - copy_ms, nv12_copy_ms=copy_ms,
                         convert_ms=convert_ms, host_copy_ms=host_ms)
        video.reset()
    log(f"12b decode of {n} frames of an I_PCM/P_Skip H.264 stream (not an x264 one): "
        f"{rates['sequential_fps']:.1f} frames/s in order, {rates['random_fps']:.1f} in random "
        f"order (opening {rates['sequential_open_ms']:.1f} ms); a frame: NVDEC parse and "
        f"decode {rates['decode_ms']:.3f} ms, NV12 copy "
        f"{rates['nv12_copy_ms']:.3f} ms, conversion {rates['convert_ms']:.3f} ms, host copy "
        f"{rates['host_copy_ms']:.3f} ms ({card})")
    return rates


_CLI_MAIN = """
import json, sys, time, torch
from sleap_tpu_torch.cli import track
from sleap_tpu_torch.ops import cuda_crops, cuda_peaks
wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
            "global_peaks": cuda_peaks.global_peaks_cuda}
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
track.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"cli_s": time.perf_counter() - t0,
                  "launches": {k: w.launches for k, w in wrappers.items()}}))
"""


def check_media_cli(td, launches, card, fps_8a, mode):
    """12b: CLI_FRAMES of phase 8a's 1024^2 frames written as a gray H.264
    .mp4 and read back by the demuxer. ``sleap-track clip.mp4 -m centroid
    -m instance`` (the CLI's ``main``) in a fresh process on the card: where
    NVDEC decodes, its output equals ``load_model`` in this process on the
    frames the card decodes (themselves ``yuv.py``'s over the written
    planes) within CLI_TOL, with kernels 2, 3 and 1 launched once a batch,
    and the CLI's FPS and the decode rates are printed beside phase 8a's
    FPS; where NVDEC is refused, the CLI exits non-zero on
    ``cuvidCreateDecoder``'s CUDA_ERROR_OUT_OF_MEMORY.
    Returns the figures it prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io import mp4, yuv
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video

    w = h264_writer()
    xy = blob_paths(CLI_FRAMES, IMG, [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                    [150.0, 150.0], seed=8)
    frames = moving_frames(xy, IMG, 8.0, 200.0, seed=8)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        folders = write_run_folders(root)
        paths = [folders["centroid"], folders["instance"]]
        for path, tm in zip(paths, (td.centroid_model, td.confmap_model)):
            torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                       os.path.join(path, "best_model.pt"))
        clip, out = os.path.join(root, "clip.mp4"), os.path.join(root, "clip.predictions.slp")
        planes = w.gray_planes(frames)
        t0 = time.perf_counter()
        table = w.write_h264_mp4(clip, *planes, idr_every=MEDIA_CLI_IDR)
        write_s = time.perf_counter() - t0
        check_demuxer(mp4.Mp4Video.open(clip), table, [p[:2] for p in planes], "12b")
        figures = {"frames": CLI_FRAMES, "mp4_mb": sum(table["sizes"]) / 1e6, "write_s": write_s,
                   "cli_fps_8a_hdf5": fps_8a}

        if mode == "decoded":
            video = Video.from_filename(clip)
            decoded = video[:]
            want_frames = yuv.yuv420_to_bgr(*(torch.from_numpy(p) for p in planes), channels="b")
            check(video.shape == (CLI_FRAMES, IMG, IMG, 1)
                  and np.array_equal(decoded, want_frames.numpy()),
                  f"12b: the card decodes the clip ({video.shape}) to yuv.py's gray frames")
            video.backend.reset()
            figures.update(decode_rates(clip, CLI_FRAMES, card))
            pred = sleap_tpu_torch.load_model(paths, batch_size=BATCH, max_instances=MAX_INSTANCES)
            pred.predict(decoded[:BATCH], make_labels=False)  # warm-up
            want = pred.predict(decoded)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", _CLI_MAIN, clip, "-m", paths[0], "-m", paths[1],
             "--batch_size", str(BATCH), "--max_instances", str(MAX_INSTANCES),
             "--verbosity", "none", "-o", out],
            cwd=here, capture_output=True, text=True, timeout=300)
        figures["process_s"] = time.perf_counter() - t0
        if mode == "refused":
            refusal = re.search(r"cuvidCreateDecoder for .+ \(\d+x\d+ H\.264\) failed: "
                                r"CUresult 2 \(CUDA_ERROR_OUT_OF_MEMORY\)", run.stderr)
            check(run.returncode != 0 and refusal is not None and not os.path.exists(out),
                  f"12b: sleap-track clip.mp4 without NVDEC exits {run.returncode} on the "
                  f"refusal: {run.stderr[-600:]}")
            log(f"12b sleap-track clip.mp4 ({CLI_FRAMES} frames of {IMG}^2 gray, "
                f"{figures['mp4_mb']:.1f} MB): demuxer tables and yuv.py card vs CPU bitwise; "
                f"NVDEC refused on this machine, the CLI exits {run.returncode} naming it: "
                f"{run.stderr.strip().splitlines()[-1][:300]}; CLI FPS and decode rates not "
                f"measured ({card})")
            return figures
        check(run.returncode == 0, f"12b: sleap-track clip.mp4 exit {run.returncode}: "
              f"{run.stderr[-2000:]}")
        result = json.loads(run.stdout.strip().splitlines()[-1])
        got = read_labels(out)
    n_batches = -(-CLI_FRAMES // BATCH)
    for kernel, count in result["launches"].items():
        check(count == n_batches,
              f"12b: {kernel} launched {count} times by the CLI, want one a batch")
        launches[kernel]["CLI clip.mp4 (12b)"] = count
    insts = [i for lf in got for i in lf.instances]
    check(len(got) == CLI_FRAMES and len(insts) >= CLI_FRAMES, "12b: frames with instances")
    d_xy, d_val = compare_predictions(got, want, CLI_TOL, CLI_TOL, "12b: CLI on .mp4 vs in-process")
    cli_fps = CLI_FRAMES / result["cli_s"]
    figures.update(cli_s=result["cli_s"], cli_fps=cli_fps, max_abs_dxy=d_xy, max_abs_dscore=d_val,
                   launches=result["launches"])
    log(f"12b sleap-track clip.mp4 ({CLI_FRAMES} frames of {IMG}^2 gray, "
        f"{figures['mp4_mb']:.1f} MB, written in {write_s:.3f} s) in a fresh process: "
        f"main {result['cli_s']:.3f} s = {cli_fps:.1f} FPS (8a, .slp of HDF5 frames, tracked: "
        f"{fps_8a:.1f} FPS), process {figures['process_s']:.1f} s; {len(insts)} instances, "
        f"launches {result['launches']}; vs in-process max |dxy| {d_xy:.3g}, max |dscore| "
        f"{d_val:.3g} ({card})")
    return figures


# --------------------------------------------------------------------------- #
# Phase 13: frames in and out of users' files (PNG and JPEG packages, ImgStore)
# --------------------------------------------------------------------------- #


def cli_frames():
    """Phase 8a's frames and their blob centres: (frames, xy)."""
    xy = blob_paths(CLI_FRAMES, IMG, [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                    [150.0, 150.0], seed=8)
    return moving_frames(xy, IMG, 8.0, 200.0, seed=8), xy


def median_ms(fn, repeats=3) -> float:
    """Median host ms of ``fn()`` over ``repeats`` calls, after one."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def check_png_packages(card):
    """13a: phase 8a's frames as a PNG training package and an HDF5 frame
    file, read back through the card's route; P1 against the numpy
    wavefront. Returns the figures it prints."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.io import hdf5, png
    from sleap_tpu_torch.io.slp import read_labels, write_labels
    from sleap_tpu_torch.io.video import Video

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "scripts"))
    import png_decode_time

    frames, xy = cli_frames()
    skeleton = Skeleton("blob")
    skeleton.add_node("A")
    skeleton.add_node("B")
    video = Video.from_numpy(frames)
    labels = Labels([LabeledFrame(video, i, [Instance(skeleton, np.array([[x - 6, y], [x + 6, y]]))
                                             for x, y in points]) for i, points in enumerate(xy)])
    n = len(frames)
    figures = {"frames": n, "raw_mb": frames.nbytes / 1e6}
    with tempfile.TemporaryDirectory() as root:
        raw, pkg, fd = (os.path.join(root, f) for f in ("raw.slp", "pkg.slp", "frames.h5"))
        t0 = time.perf_counter()
        write_labels(raw, labels)
        figures["raw_slp_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels.save(pkg, with_images=True)
        figures["pkg_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        labels.save_frame_data_hdf5(fd)
        figures["frame_data_write_s"] = time.perf_counter() - t0
        figures["encode_ms"] = median_ms(lambda: [png.imencode(".png", f) for f in frames], 1) / n
        for name, path in (("raw_slp", raw), ("pkg", pkg), ("frame_data", fd)):
            figures[f"{name}_mb"] = os.path.getsize(path) / 1e6
        for name, read in (("pkg", lambda: read_labels(pkg).video),
                           ("frame_data", lambda: Video.from_hdf5("video0/video", fd))):
            got = read()
            check(torch.device(got.backend.device).type == "cuda",
                  f"13a: the {name} video decodes on the card")
            got.get_frame(0)
            t0 = time.perf_counter()
            back = np.stack([got.get_frame(i) for i in range(n)])
            figures[f"{name}_read_ms"] = 1e3 * (time.perf_counter() - t0) / n
            check(np.array_equal(back, frames), f"13a: the {name} file holds the frames, bitwise")
        with hdf5.File(pkg) as f:
            rows = [f["video0/video"][i].tobytes() for i in range(n)]
        for row in rows:
            p = png.read(row)
            check(np.array_equal(png.unfilter_host(p.rows, p.bpp), png.unfilter_plain(p.rows, p.bpp)),
                  "13a: P1 equals the wavefront on the package's rows")
    img = png_decode_time.frame(IMG)
    figures["p1"] = {}
    for k, name in enumerate(png_decode_time.FILTERS):
        data = png_decode_time.encode(img, k)
        p = png.read(data)
        host = png.unfilter_host(p.rows, p.bpp)
        check(np.array_equal(host, png.unfilter_plain(p.rows, p.bpp)) and np.array_equal(host, img),
              f"13a: P1 equals the wavefront on the {name} rows at {IMG}^2")
        figures["p1"][name] = {
            "p1_unfilter_ms": median_ms(lambda: png.unfilter_host(p.rows, p.bpp)),
            "wavefront_unfilter_ms": median_ms(lambda: png.unfilter_plain(p.rows, p.bpp)),
            "decode_cuda_ms": median_ms(lambda: png.decode(data, "cuda")),
            "decode_cpu_ms": median_ms(lambda: png.decode(data, "cpu")),
        }
    log(f"13a PNG package of {n} frames of {IMG}^2 (gray, {figures['raw_mb']:.1f} MB raw): "
        f"Labels.save(with_images) {figures['pkg_write_s']:.3f} s, save_frame_data_hdf5 "
        f"{figures['frame_data_write_s']:.3f} s, PNG encode {figures['encode_ms']:.2f} ms a frame; "
        f"files {figures['pkg_mb']:.2f} MB (.pkg.slp), {figures['frame_data_mb']:.2f} MB (frame "
        f"data), {figures['raw_slp_mb']:.2f} MB (8a's raw .slp, written in "
        f"{figures['raw_slp_write_s']:.3f} s); read on the card {figures['pkg_read_ms']:.2f} / "
        f"{figures['frame_data_read_ms']:.2f} ms a frame, bitwise ({card})")
    log(f"13a P1 vs the numpy wavefront at {IMG}^2, median of 3 (unfilter ms; whole decode ms "
        "card route / CPU route): " + ", ".join(
            f"{k} {v['p1_unfilter_ms']:.2f} vs {v['wavefront_unfilter_ms']:.2f} "
            f"({v['decode_cuda_ms']:.2f} / {v['decode_cpu_ms']:.2f})"
            for k, v in figures["p1"].items()) + f" ({card})")
    return figures


def jpeg_record(name="decoded.json"):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, *JPEG_DIR, name)) as fh:
        return json.load(fh)


def sha256(data) -> str:
    """The sha256 of ``bytes``, or of an array's bytes."""
    import hashlib

    return hashlib.sha256(data if isinstance(data, bytes) else np.ascontiguousarray(data).tobytes()).hexdigest()


def check_jpeg(card):
    """13b: the JPEG stills through the card's route against cv2's recorded
    decode; the host entropy decoder against the plain one; J1 and J2
    against the plain PyTorch stages at 1024^2, timed. Returns (figures,
    {kernel: (max |err|, row numbers at 1024^2 gray)})."""
    from sleap_tpu_torch.io import jpeg

    here = os.path.dirname(os.path.abspath(__file__))
    record, dev = jpeg_record(), torch.device("cuda", 0)
    stills = {}
    for name, want in record["stills"].items():
        with open(os.path.join(here, *JPEG_DIR, name + ".jpg"), "rb") as fh:
            stills[name] = fh.read()
        if "refused" in want:
            try:
                jpeg.imdecode(stills[name], "cuda")
            except jpeg.UnsupportedJpeg as e:
                check(want["refused"] in str(e), f"13b: {name} refused naming it: {e}")
                continue
            check(False, f"13b: {name} must be refused")
        img = jpeg.imdecode(stills[name], "cuda")
        check(list(img.shape) == want["shape"] and sha256(img) == want["sha256"],
              f"13b: {name} decodes on the card to cv2's frame")
        header = jpeg.parse(stills[name])
        if header.blocks <= JPEG_PLAIN_BLOCKS and not header.progressive:  # 19a: progressive
            check(np.array_equal(jpeg.coefficients_host(stills[name], header).numpy(),
                                 jpeg.coefficients_plain(stills[name], header)),
                  f"13b: the host entropy decoder gives the plain coefficients on {name}")
    figures, errs = {}, {"jpeg_idct": 0.0, "jpeg_color": 0.0}
    rows = {}
    for name in ("gray_1024", "c420_1024"):
        data = stills[name]
        header = jpeg.parse(data)
        staging = jpeg._staging(header.blocks)
        coefs = jpeg.coefficients_host(data, header, staging)
        c = coefs.to(dev)
        q = torch.from_numpy(header.quant.astype(np.int32)).to(dev)
        comp = jpeg.block_components(header).to(dev)
        samples = jpeg.idct_cuda(c, q, header)
        plain_samples = jpeg.idct_plain(c, q, comp)
        out = jpeg.color_cuda(samples, header)
        plain_out = jpeg.color_plain(jpeg.planes_of(samples, header), header)
        errs["jpeg_idct"] = max(errs["jpeg_idct"], max_abs(samples, plain_samples))
        errs["jpeg_color"] = max(errs["jpeg_color"], max_abs(out, plain_out))
        check(torch.equal(samples, plain_samples) and torch.equal(out, plain_out),
              f"13b: J1 and J2 equal the plain stages on {name}")
        split = {
            "entropy_ms": median_ms(lambda: jpeg.coefficients_host(data, header, staging), 5),
            "copy_in_ms": events_ms(lambda: staging.to(dev, non_blocking=True)),
            "j1_ms": events_ms(lambda: jpeg.idct_cuda(c, q, header)),
            "j2_ms": events_ms(lambda: jpeg.color_cuda(samples, header)),
            "copy_out_ms": median_ms(lambda: out.cpu(), 5),
            "frame_ms": median_ms(lambda: jpeg.imdecode(data, "cuda"), 5),
            "cpu_route_frame_ms": median_ms(lambda: jpeg.imdecode(data, "cpu"), 1),
        }
        j1_dev = device_ms(lambda: jpeg.idct_cuda(c, q, header), ["jpeg_idct_kernel"])
        j2_dev = device_ms(lambda: jpeg.color_cuda(samples, header), ["jpeg_color_kernel"])
        j1_plain = time_ms(lambda: jpeg.idct_plain(c, q, comp), iters=10, warmup=2)
        planes = jpeg.planes_of(samples, header)
        j2_plain = time_ms(lambda: jpeg.color_plain(planes, header), iters=10, warmup=2)
        # Bounds: each input read once, each output written once; J1 a few
        # hundred integer operations a block, J2 a few tens a pixel, both at
        # the float32 rate outside the tensor cores.
        j1_bytes = nbytes(c, q, samples)
        j2_bytes = nbytes(samples, out)
        j1_ops, j2_ops = 600 * header.blocks, 40 * out.numel()
        rows[name] = {
            "jpeg_idct": {"ms": split["j1_ms"], "plain_ms": j1_plain, "device_ms": j1_dev,
                          "bytes_ms": j1_bytes / HBM_BYTES_PER_S * 1e3,
                          "ops_ms": j1_ops / F32_OPS_PER_S * 1e3},
            "jpeg_color": {"ms": split["j2_ms"], "plain_ms": j2_plain, "device_ms": j2_dev,
                           "bytes_ms": j2_bytes / HBM_BYTES_PER_S * 1e3,
                           "ops_ms": j2_ops / F32_OPS_PER_S * 1e3},
        }
        figures[name] = {**split, "bytes": len(data), "blocks": header.blocks,
                         "j1_device_ms": j1_dev, "j2_device_ms": j2_dev,
                         "j1_plain_ms": j1_plain, "j2_plain_ms": j2_plain}
        log(f"13b JPEG {name} ({len(data)} bytes, {header.blocks} blocks), ms a frame: entropy "
            f"(host C) {split['entropy_ms']:.3f}, copy in {split['copy_in_ms']:.3f}, J1 "
            f"{split['j1_ms']:.4f} (device {j1_dev:.4f}, plain {j1_plain:.3f}), J2 "
            f"{split['j2_ms']:.4f} (device {j2_dev:.4f}, plain {j2_plain:.3f}), copy out "
            f"{split['copy_out_ms']:.3f}; whole card route {split['frame_ms']:.3f}, CPU route "
            f"{split['cpu_route_frame_ms']:.1f}; bounds J1 {rows[name]['jpeg_idct']['bytes_ms']:.4f}"
            f", J2 {rows[name]['jpeg_color']['bytes_ms']:.4f} ms ({card})")
    for kernel in errs:
        rows["gray_1024"][kernel]["colour"] = rows["c420_1024"][kernel]
    return figures, {k: (errs[k], rows["gray_1024"][k]) for k in errs}


_CLI_MAIN_JPEG = """
import json, sys, time, torch
from sleap_tpu_torch.cli import track
from sleap_tpu_torch.io import jpeg
from sleap_tpu_torch.ops import cuda_crops, cuda_peaks
wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
            "global_peaks": cuda_peaks.global_peaks_cuda, "jpeg_idct": jpeg.idct_cuda,
            "jpeg_color": jpeg.color_cuda}
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
track.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"cli_s": time.perf_counter() - t0,
                  "launches": {k: w.launches for k, w in wrappers.items()}}))
"""


def check_jpeg_cli(td, launches, card, fps_8a):
    """13c: ``sleap-track jpeg_pkg.slp`` in a fresh process on the card
    against ``load_model`` in this one on the frames J1 and J2 decode.
    Returns the figures it prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io.slp import read_labels

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(here, *JPEG_PKG)
    record = jpeg_record()["package"]
    video = read_labels(pkg).video
    decoded = video[:]
    check(len(decoded) == len(record) and all(
        sha256(f[..., 0]) == r["sha256"] for f, r in zip(decoded, record)),
        "13c: J1 and J2 decode the package's rows to cv2's frames")
    n = len(decoded)
    with tempfile.TemporaryDirectory() as root:
        folders = write_run_folders(root)
        paths = [folders["centroid"], folders["instance"]]
        for path, tm in zip(paths, (td.centroid_model, td.confmap_model)):
            torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                       os.path.join(path, "best_model.pt"))
        pred = sleap_tpu_torch.load_model(paths, batch_size=BATCH, max_instances=MAX_INSTANCES)
        pred.predict(decoded[:BATCH], make_labels=False)  # warm-up
        want = pred.predict(decoded)
        out = os.path.join(root, "jpeg.predictions.slp")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", _CLI_MAIN_JPEG, pkg, "-m", paths[0], "-m", paths[1],
             "--batch_size", str(BATCH), "--max_instances", str(MAX_INSTANCES),
             "--verbosity", "none", "-o", out],
            cwd=here, capture_output=True, text=True, timeout=300)
        process_s = time.perf_counter() - t0
        check(run.returncode == 0, f"13c: sleap-track jpeg_pkg.slp exit {run.returncode}: "
              f"{run.stderr[-2000:]}")
        result = json.loads(run.stdout.strip().splitlines()[-1])
        got = read_labels(out)
    n_batches = -(-n // BATCH)
    counts = result["launches"]
    for kernel in ("local_peaks", "crop_unit", "global_peaks"):
        check(counts[kernel] == n_batches,
              f"13c: {kernel} launched {counts[kernel]} times by the CLI, want one a batch")
        launches[kernel]["CLI jpeg_pkg.slp (13c)"] = counts[kernel]
    for kernel in ("jpeg_idct", "jpeg_color"):
        check(counts[kernel] >= n, f"13c: {kernel} launched {counts[kernel]} times for {n} frames")
    insts = [i for lf in got for i in lf.instances]
    check(len(got) == n and len(insts) >= n, "13c: frames with instances")
    d_xy, d_val = compare_predictions(got, want, CLI_TOL, CLI_TOL, "13c: CLI on JPEG rows vs in-process")
    cli_fps = n / result["cli_s"]
    figures = {"frames": n, "cli_s": result["cli_s"], "cli_fps": cli_fps, "cli_fps_8a": fps_8a,
               "process_s": process_s, "launches": counts, "max_abs_dxy": d_xy,
               "max_abs_dscore": d_val}
    log(f"13c sleap-track jpeg_pkg.slp ({n} JPEG frames of {IMG}^2 gray) in a fresh process: main "
        f"{result['cli_s']:.3f} s = {cli_fps:.1f} FPS (8a, .slp of raw frames, tracked: "
        f"{fps_8a:.1f} FPS), process {process_s:.1f} s; {len(insts)} instances, launches {counts}; "
        f"vs in-process max |dxy| {d_xy:.3g}, max |dscore| {d_val:.3g} ({card})")
    return figures


def check_imgstore(card):
    """13d: 8 of phase 8a's frames through ``to_imgstore`` and back through
    ``Video.from_dict`` of its ``to_dict()``, by original frame number and by
    position. Returns the figures it prints."""
    from sleap_tpu_torch.io.video import Video

    frames, _ = cli_frames()
    nums = list(IMGSTORE_FRAMES)
    figures = {}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "store")
        t0 = time.perf_counter()
        stored = Video.from_numpy(frames).to_imgstore(path, frame_numbers=nums)
        figures["write_s"] = time.perf_counter() - t0
        for by_original in (True, False):
            d = stored.to_dict()
            d["backend"]["index_by_original"] = by_original
            video = Video.from_dict(json.loads(json.dumps(d)))
            idxs = nums if by_original else range(len(nums))
            t0 = time.perf_counter()
            got = np.stack([video.get_frame(i) for i in idxs])
            figures[f"read_ms_{'original' if by_original else 'position'}"] = \
                1e3 * (time.perf_counter() - t0) / len(nums)
            check(type(video.backend).__name__ == "ImgStoreVideo" and video.num_frames == len(nums)
                  and np.array_equal(got, frames[nums]),
                  f"13d: the ImgStore gives back the frames (index_by_original={by_original})")
    log(f"13d ImgStore of {len(nums)} frames of {IMG}^2: written in {figures['write_s']:.3f} s, "
        f"read back bitwise by frame number and by position "
        f"({figures['read_ms_original']:.2f} / {figures['read_ms_position']:.2f} ms a frame) ({card})")
    return figures


# --------------------------------------------------------------------------- #
# Phase 18: JPEG encoding (J3, J4), JPEG writes, and sleap-render
# --------------------------------------------------------------------------- #


ENCODE_PLAIN_BLOCKS = 5000  # 18a: the host coder vs the plain one on frames up to this many blocks
ENCODE_CPU_ROWS = 4  # 18b: rows held to the CPU route's bytes (18a's cpu_route_frame_ms a 1024^2 frame)
RENDER_CPU_CHUNKS = 2  # 18c: AVI chunks of each run held to the CPU route's encode
RENDER_RUNS = {"defaults": [], "scaled": ["--scale", "0.5", "--crop", "256,256", "--background", "black"]}


def once_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def check_jpeg_encode(card):
    """18a: the committed stills, decoded on the card (phase 13 holds that
    decode to cv2's), and crops of the 1024^2 ones, encoded on the card to
    the bytes cv2 writes (``encoded.json``'s sha256); the host entropy coder
    against the plain one; J3 and J4 exactly equal to their plain stages at
    1024^2 gray and colour, timed by stage. Returns (figures, {kernel: (max
    |err|, row numbers at 1024^2 gray)})."""
    from sleap_tpu_torch.io import jpeg

    here = os.path.dirname(os.path.abspath(__file__))
    record, dev = jpeg_record("encoded.json")["frames"], torch.device("cuda", 0)
    decoded = {}
    for name in record:
        if "_crop_" not in name:
            with open(os.path.join(here, *JPEG_DIR, name + ".jpg"), "rb") as fh:
                decoded[name] = jpeg.imdecode(fh.read(), "cuda")
    frames, checked_host = {}, 0
    for name, want in record.items():
        if "_crop_" in name:
            base, size = name.split("_crop_")
            w, h = (int(v) for v in size.split("x"))
            img = np.ascontiguousarray(decoded[base][1:1 + h, 1:1 + w])
        else:
            img = decoded[name]
        check(list(img.shape) == want["shape"], f"18a: {name} is {img.shape}, want {want['shape']}")
        data = jpeg.imencode(img, "cuda")
        check(len(data) == want["bytes"] and sha256(data) == want["sha256"],
              f"18a: {name} encodes on the card to cv2's bytes")
        frames[name] = jpeg._as_frame(img)
        frame = jpeg.frame_layout(img.shape[0], img.shape[1], 1 if frames[name].ndim == 2 else 3)
        if frame.blocks <= ENCODE_PLAIN_BLOCKS:
            src = torch.from_numpy(frames[name]).to(dev)
            coefs = jpeg.fdct_cuda(jpeg.ycc_cuda(src, frame), jpeg.card_divisors(dev), frame).cpu()
            check(jpeg.encode_scan_host(coefs, frame) == jpeg.encode_scan_plain(coefs.numpy(), frame),
                  f"18a: the host entropy coder gives the plain coder's bytes on {name}")
            checked_host += 1
    figures = {"frames": len(record), "host_coder_frames": checked_host}
    errs, rows = {"jpeg_ycc": 0.0, "jpeg_fdct": 0.0}, {}
    for name in ("gray_1024", "c420_1024"):
        img = frames[name]
        frame = jpeg.frame_layout(img.shape[0], img.shape[1], 1 if img.ndim == 2 else 3)
        src = torch.from_numpy(img).to(dev)
        divs = jpeg.card_divisors(dev)
        table = jpeg.block_tables(frame).to(dev)
        samples = jpeg.ycc_cuda(src, frame)
        coefs = jpeg.fdct_cuda(samples, divs, frame)
        plain_samples = jpeg.ycc_plain(src, frame)
        plain_coefs = jpeg.fdct_plain(samples, divs, table)
        errs["jpeg_ycc"] = max(errs["jpeg_ycc"], max_abs(samples, plain_samples))
        errs["jpeg_fdct"] = max(errs["jpeg_fdct"], max_abs(coefs, plain_coefs))
        check(torch.equal(samples, plain_samples) and torch.equal(coefs, plain_coefs),
              f"18a: J3 and J4 equal the plain stages on {name}")
        host_coefs = coefs.cpu()
        split = {
            "copy_in_ms": time_ms(lambda: torch.from_numpy(img).to(dev), iters=20, warmup=1),
            "j3_ms": time_ms(lambda: jpeg.ycc_cuda(src, frame), iters=20, warmup=1),
            "j4_ms": time_ms(lambda: jpeg.fdct_cuda(samples, divs, frame), iters=20, warmup=1),
            "copy_out_ms": median_ms(lambda: coefs.cpu(), 5),
            "entropy_ms": median_ms(lambda: jpeg.encode_scan_host(host_coefs, frame), 5),
            "frame_ms": median_ms(lambda: jpeg.imencode(img, "cuda"), 5),
            "cpu_route_frame_ms": once_ms(lambda: jpeg.imencode(img, "cpu")),
        }
        j3_dev = device_ms(lambda: jpeg.ycc_cuda(src, frame), ["jpeg_ycc_kernel"])
        j4_dev = device_ms(lambda: jpeg.fdct_cuda(samples, divs, frame), ["jpeg_fdct_kernel"])
        j3_plain = time_ms(lambda: jpeg.ycc_plain(src, frame), iters=10, warmup=2)
        j4_plain = time_ms(lambda: jpeg.fdct_plain(samples, divs, table), iters=10, warmup=2)
        # Bounds: each input read once, each output written once; J3 about
        # 25 integer operations a pixel, J4 about 900 a block (two 1-D passes
        # of eight rows and the quantisation), at the float32 rate outside
        # the tensor cores.
        j3_bytes, j4_bytes = nbytes(src, samples), nbytes(samples, divs, coefs)
        j3_ops, j4_ops = 25 * img.size, 900 * frame.blocks
        rows[name] = {
            "jpeg_ycc": {"ms": split["j3_ms"], "plain_ms": j3_plain, "device_ms": j3_dev,
                         "bytes_ms": j3_bytes / HBM_BYTES_PER_S * 1e3,
                         "ops_ms": j3_ops / F32_OPS_PER_S * 1e3},
            "jpeg_fdct": {"ms": split["j4_ms"], "plain_ms": j4_plain, "device_ms": j4_dev,
                          "bytes_ms": j4_bytes / HBM_BYTES_PER_S * 1e3,
                          "ops_ms": j4_ops / F32_OPS_PER_S * 1e3},
        }
        figures[name] = {**split, "bytes": len(jpeg.imencode(img, "cuda")), "blocks": frame.blocks,
                         "j3_device_ms": j3_dev, "j4_device_ms": j4_dev,
                         "j3_plain_ms": j3_plain, "j4_plain_ms": j4_plain}
        log(f"18a JPEG encode {name} ({frame.blocks} blocks), ms a frame: copy in "
            f"{split['copy_in_ms']:.4f}, J3 {split['j3_ms']:.4f} (device {j3_dev:.4f}, plain "
            f"{j3_plain:.3f}), J4 {split['j4_ms']:.4f} (device {j4_dev:.4f}, plain {j4_plain:.3f}), "
            f"copy out {split['copy_out_ms']:.3f}, entropy (host C) {split['entropy_ms']:.3f}; whole "
            f"card route {split['frame_ms']:.3f}, CPU route {split['cpu_route_frame_ms']:.1f}; bounds "
            f"J3 {rows[name]['jpeg_ycc']['bytes_ms']:.4f}, J4 {rows[name]['jpeg_fdct']['bytes_ms']:.4f} "
            f"ms ({card})")
    log(f"18a {len(record)} frames (stills and crops) encoded on the card to cv2's bytes; the host "
        f"coder equals the plain one on {checked_host} of them ({card})")
    for kernel in errs:
        rows["gray_1024"][kernel]["colour"] = rows["c420_1024"][kernel]
    return figures, {k: (errs[k], rows["gray_1024"][k]) for k in errs}


def check_jpeg_writes(card, launches, kept):
    """18b: phase 8a's frames written on the card as a JPEG ``.pkg.slp`` and
    a JPEG ImgStore, read back through J1 and J2: the first rows and files
    are the CPU route's bytes, every frame reads back as ``imdecode`` of its
    own row. The package stays in ``kept`` for 18c (``jpeg_pkg``, and its
    rows' sizes ``jpeg_rows``). Returns the figures it prints."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.io import hdf5, jpeg
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video

    frames, xy = cli_frames()
    skeleton = Skeleton("blob")
    skeleton.add_node("A")
    skeleton.add_node("B")
    video = Video.from_numpy(frames)
    labels = Labels([LabeledFrame(video, i, [Instance(skeleton, np.array([[x - 6, y], [x + 6, y]]))
                                             for x, y in points]) for i, points in enumerate(xy)])
    n = len(frames)
    cpu_rows = [jpeg.imencode(f, "cpu") for f in frames[:ENCODE_CPU_ROWS]]
    encoders = {"jpeg_ycc": jpeg.ycc_cuda, "jpeg_fdct": jpeg.fdct_cuda}
    figures = {"frames": n}
    with tempfile.TemporaryDirectory() as root:
        pkg, store = os.path.join(kept["dir"], "jpeg.pkg.slp"), os.path.join(root, "store")
        for w in encoders.values():
            w.launches = 0
        t0 = time.perf_counter()
        labels.save(pkg, with_images=True, image_format="jpg")
        figures["pkg_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stored = video.to_imgstore(store, format="jpg")
        figures["imgstore_write_s"] = time.perf_counter() - t0
        counts = {k: w.launches for k, w in encoders.items()}
        for kernel, count in counts.items():
            check(count == 2 * n, f"18b: {kernel} launched {count} times for {2 * n} frames written")
            launches[kernel]["JPEG package and ImgStore writes (18b)"] = count
        with hdf5.File(pkg) as f:
            rows = [f["video0/video"][i].tobytes().rstrip(b"\0") for i in range(n)]  # JPEGs end in EOI
        files = []
        for i in range(n):
            with open(os.path.join(store, "000000", "%06d.jpg" % i), "rb") as fh:
                files.append(fh.read())
        figures["pkg_mb"] = os.path.getsize(pkg) / 1e6
        figures["imgstore_mb"] = sum(len(b) for b in files) / 1e6
        check(rows[:ENCODE_CPU_ROWS] == cpu_rows and files[:ENCODE_CPU_ROWS] == cpu_rows,
              "18b: the first rows and files are the CPU route's bytes")
        check(rows == files, "18b: the package's rows and the store's files are the same JPEGs")
        kept["jpeg_pkg"], kept["jpeg_rows"] = pkg, [len(r) for r in rows]
        got = read_labels(pkg).video
        check(torch.device(got.backend.device).type == "cuda", "18b: the package decodes on the card")
        t0 = time.perf_counter()
        back = [got.get_frame(i) for i in range(n)]
        figures["pkg_read_ms"] = 1e3 * (time.perf_counter() - t0) / n
        back_store = [stored.get_frame(i) for i in range(n)]
        for i in range(n):
            want = jpeg.imdecode(rows[i], "cuda")
            check(np.array_equal(back[i][..., 0], want) and np.array_equal(back_store[i][..., 0], want),
                  f"18b: frame {i} reads back as imdecode of its row")
        check(np.array_equal(jpeg.imdecode(rows[0], "cpu"), back[0][..., 0]),
              "18b: the card's read equals the CPU route's decode")
        worst = max(int(np.abs(b.astype(int) - f.astype(int)).max()) for b, f in zip(back, frames))
        figures["max_abs_vs_raw"] = worst
    log(f"18b {n} frames of {IMG}^2 gray written on the card as JPEG: .pkg.slp "
        f"{figures['pkg_write_s']:.3f} s ({figures['pkg_mb']:.2f} MB), ImgStore "
        f"{figures['imgstore_write_s']:.3f} s ({figures['imgstore_mb']:.2f} MB); read back on the card "
        f"{figures['pkg_read_ms']:.2f} ms a frame; first {ENCODE_CPU_ROWS} rows the CPU route's bytes; "
        f"largest difference from the raw frames {worst} levels (quality 95) ({card})")
    return figures


_RENDER_MAIN = """
import json, logging, sys, time, torch
for name in ("cv2", "imageio"):  # as on a machine with neither: the Motion-JPEG writer
    sys.modules[name] = None
logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(name)s: %(message)s")
from sleap_tpu_torch.io import jpeg, video, videowriter, visuals
wrappers = {"jpeg_ycc": jpeg.ycc_cuda, "jpeg_fdct": jpeg.fdct_cuda,
            "jpeg_idct": jpeg.idct_cuda, "jpeg_color": jpeg.color_cuda}
busy = {"decode": 0.0, "draw": 0.0, "encode": 0.0}  # each stage's own thread, so they overlap
first = {}  # each stage's first call, set-up included (in busy too)

def timed(stage, fn):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            busy[stage] += time.perf_counter() - t0
            first.setdefault(stage, time.perf_counter() - t0)
    return call

video.Video.get_frame = timed("decode", video.Video.get_frame)
visuals.render_frame = timed("draw", visuals.render_frame)
videowriter.VideoWriterMJPEG.add_frame = timed("encode", videowriter.VideoWriterMJPEG.add_frame)
for w in wrappers.values():
    w.launches = 0
t0 = time.perf_counter()
visuals.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"render_s": time.perf_counter() - t0, "busy_s": busy, "first_call_s": first,
                  "launches": {k: w.launches for k, w in wrappers.items()}}))
"""


class FrameCapture:
    """A writer that keeps the frames ``save_labeled_video`` hands it."""

    def __init__(self, sink):
        self.sink = sink

    def add_frame(self, img, bgr=False):
        self.sink.append(np.array(img))

    def close(self):
        pass


def drawn_frames(labels, flags):
    """The frames ``save_labeled_video`` draws for ``sleap-render`` with
    ``flags`` on the CPU route, from a writer patched in for the call."""
    from sleap_tpu_torch.io import visuals

    opts = dict(zip(flags[0::2], flags[1::2]))
    crop = tuple(int(v) for v in opts["--crop"].split(",")) if "--crop" in opts else None
    sink = []
    builder = visuals.VideoWriter.__dict__["safe_builder"]
    visuals.VideoWriter.safe_builder = staticmethod(lambda *a, **k: FrameCapture(sink))
    try:
        visuals.save_labeled_video("unused.avi", labels, video=labels.videos[0],
                                   scale=float(opts.get("--scale", 1.0)), crop_size_xy=crop,
                                   background=opts.get("--background", "original"), device="cpu")
    finally:
        visuals.VideoWriter.safe_builder = builder
    return sink


def writer_probe() -> dict:
    """Which of the JAX package's video backends this machine has."""
    import importlib.util

    return {name: importlib.util.find_spec(name) is not None
            for name in ("imageio", "imageio_ffmpeg", "av", "cv2")}


def check_render(kept, card, launches):
    """18c: ``python -m sleap_tpu_torch.io.visuals`` on phase 8a's tracked
    ``.slp`` in fresh processes, one at a time, whose imports of cv2 and
    imageio fail (as on a machine with neither, where ``safe_builder``
    takes the Motion-JPEG writer; a machine with cv2 writes with OpenCV),
    at the defaults and scaled, cropped and on black: the writer chosen, 32
    chunks each, every chunk the card's ``imencode`` of the frame
    ``render_frame`` draws on the CPU route (the first ones the CPU route's
    encode too), the render's FPS and each stage's busy seconds; and
    ``render_frame`` on ``jpeg_pkg.slp``'s frames decoded on the card to
    the JAX package's recorded hashes. Returns the figures it prints."""
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io import avi, jpeg, visuals

    here = os.path.dirname(os.path.abspath(__file__))
    labels = Labels.load_file(kept["slp"], device="cpu")
    figures = {"backends_installed": writer_probe()}
    log(f"18c the JAX package's video backends installed here: {figures['backends_installed']}; the "
        "render processes block cv2 and imageio")
    with tempfile.TemporaryDirectory() as root:
        for name, flags in RENDER_RUNS.items():
            out = os.path.join(root, name + ".avi")
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-c", _RENDER_MAIN, kept["slp"], "-o", out, *flags], cwd=here,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                stdout, stderr = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            process_s = time.perf_counter() - t0
            check(proc.returncode == 0, f"18c: sleap-render ({name}) exit {proc.returncode}: "
                  f"{stderr[-2000:]}")
            chosen = re.search(r"sleap-render writes \S+ with (\w+)", stderr)
            backend = chosen.group(1) if chosen else None
            log(f"18c sleap-render ({name}) chose {backend} ({card})")
            check(backend == "VideoWriterMJPEG", f"18c: sleap-render ({name}) wrote with {backend}, "
                  "want the Motion-JPEG writer (cv2 and imageio are blocked)")
            result = json.loads(stdout.strip().splitlines()[-1])
            chunks = avi.read_frames(out)
            check(len(chunks) == CLI_FRAMES, f"18c: {name}: {len(chunks)} chunks, want {CLI_FRAMES}")
            drawn = drawn_frames(labels, RENDER_RUNS[name])
            check(len(drawn) == CLI_FRAMES and all(
                chunk == jpeg.imencode(img, "cuda") for chunk, img in zip(chunks, drawn)),
                f"18c: {name}: every chunk is imencode of the frame render_frame draws")
            check(all(chunk == jpeg.imencode(img, "cpu")
                      for chunk, img in zip(chunks[:RENDER_CPU_CHUNKS], drawn)),
                  f"18c: {name}: the first chunks are the CPU route's encode")
            counts = result["launches"]
            for kernel in ("jpeg_ycc", "jpeg_fdct"):
                check(counts[kernel] == CLI_FRAMES,
                      f"18c: {name}: {kernel} launched {counts[kernel]} times for {CLI_FRAMES} frames")
                launches[kernel][f"sleap-render {name} (18c)"] = counts[kernel]
            figures[name] = {"flags": RENDER_RUNS[name], "backend": backend, "render_s": result["render_s"],
                             "fps": CLI_FRAMES / result["render_s"], "process_s": process_s,
                             "busy_s": result["busy_s"], "first_call_s": result["first_call_s"],
                             "mb": os.path.getsize(out) / 1e6,
                             "shape": list(drawn[0].shape), "launches": counts}
            busy = ", ".join(f"{k} {v:.3f} (first call {result['first_call_s'].get(k, 0.0):.3f})"
                             for k, v in result["busy_s"].items())
            log(f"18c sleap-render ({name}: {' '.join(RENDER_RUNS[name]) or 'defaults'}) in a fresh "
                f"process, alone: {CLI_FRAMES} frames of {drawn[0].shape} in {result['render_s']:.3f} s = "
                f"{figures[name]['fps']:.1f} FPS (process {process_s:.1f} s); threads busy (s): {busy}; AVI "
                f"{figures[name]['mb']:.2f} MB, launches {counts} ({card})")
    record = jpeg_record("rendered.json")["scales"]
    pkg = Labels.load_file(os.path.join(here, *JPEG_PKG))
    check(torch.device(pkg.video.backend.device).type == "cuda", "18c: jpeg_pkg.slp decodes on the card")
    for scale in (1.0, 0.5):
        for i, want in enumerate(record[str(scale)]):
            drawn = visuals.render_frame(pkg, visuals.resize_image(pkg.video.get_frame(i), scale), i,
                                         scale=scale)
            check(sha256(drawn) == want["sha256"],
                  f"18c: render_frame of jpeg_pkg.slp frame {i} at scale {scale} equals the JAX package's")
    figures["jpeg_pkg_rendered"] = sum(len(v) for v in record.values())
    log(f"18c render_frame on jpeg_pkg.slp (decoded by J1 and J2): {figures['jpeg_pkg_rendered']} frames "
        f"equal the JAX package's recorded hashes ({card})")
    return figures


def check_render_pipelined(kept, card, launches):
    """18c: 18b's JPEG package rendered in this process through the
    Motion-JPEG writer on the card, pipelined and serial. The pipelined
    render's reader thread decodes (host entropy decoder, J1, J2) while
    the caller encodes (J3, J4, host entropy coder); the crop is sized so
    that the encoder's host buffer rounds to the decoder's size, where one
    pool shared by the threads would mix their bytes. Every chunk of the
    pipelined AVI must be the serial one's. Returns the figures it prints."""
    from collections import Counter

    from sleap_tpu_torch.io import avi, jpeg, videowriter, visuals
    from sleap_tpu_torch.io.slp import read_labels

    labels = read_labels(kept["jpeg_pkg"])
    check(torch.device(labels.video.backend.device).type == "cuda", "18c: the JPEG package decodes on the card")
    pool = Counter(1 << max(16, (n + 15).bit_length()) for n in kept["jpeg_rows"]).most_common(1)[0][0]
    side = 16 * math.isqrt((pool - 64) // (512 * 6))  # 6 blocks a 16x16 MCU of a 4:2:0 frame
    check(pool // 2 < 512 * 6 * (side // 16) ** 2 + 64 <= pool,
          f"18c: a {side}^2 frame's encoder buffer rounds to the decoder's {pool} bytes")
    wrappers = {"jpeg_idct": jpeg.idct_cuda, "jpeg_color": jpeg.color_cuda,
                "jpeg_ycc": jpeg.ycc_cuda, "jpeg_fdct": jpeg.fdct_cuda}
    builder = visuals.VideoWriter.__dict__["safe_builder"]
    visuals.VideoWriter.safe_builder = staticmethod(
        lambda filename, height, width, fps=30.0, device="cuda":
        videowriter.VideoWriterMJPEG(filename, height, width, fps, device=device))
    chunks, figures = {}, {"crop": side, "pool_bytes": pool}
    try:
        with tempfile.TemporaryDirectory() as root:
            for mode in ("pipelined", "serial"):
                out = os.path.join(root, mode + ".avi")
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.perf_counter()
                visuals.save_labeled_video(out, labels, crop_size_xy=(side, side),
                                           pipelined=mode == "pipelined", device="cuda")
                seconds = time.perf_counter() - t0
                chunks[mode] = avi.read_frames(out)
                figures[mode] = {"render_s": seconds, "fps": len(chunks[mode]) / seconds,
                                 "launches": {k: w.launches for k, w in wrappers.items()}}
    finally:
        visuals.VideoWriter.safe_builder = builder
    n = len(kept["jpeg_rows"])
    check(len(chunks["pipelined"]) == len(chunks["serial"]) == n,
          f"18c: the JPEG package renders to {len(chunks['pipelined'])} and {len(chunks['serial'])} "
          f"chunks, want {n}")
    same = sum(a == b for a, b in zip(chunks["pipelined"], chunks["serial"]))
    check(same == n, f"18c: {same} of {n} chunks of the pipelined render are the serial render's")
    counts = figures["pipelined"]["launches"]
    for kernel, count in counts.items():
        # Each frame decoded and encoded once; the video's height and width
        # decode its first frame once more each, as the JAX package's do.
        want = n if kernel in ("jpeg_ycc", "jpeg_fdct") else n + 2
        check(count == want, f"18c: {kernel} launched {count} times for {n} frames rendered, want {want}")
        launches[kernel]["sleap-render JPEG package, pipelined (18c)"] = count
    log(f"18c sleap-render of 18b's JPEG package ({n} frames, {side}^2 crops, host buffers of "
        f"{pool} bytes for both coders) in this process: pipelined {figures['pipelined']['fps']:.1f} FPS, "
        f"serial {figures['serial']['fps']:.1f} FPS, every chunk the same; launches {counts} ({card})")
    return figures


def check_jpeg_encoding(card, launches, kept):
    """Phase 18: 18a, 18b and 18c. Returns (figures, J3/J4 rows)."""
    launches["jpeg_ycc"], launches["jpeg_fdct"] = {}, {}
    encode, rows = check_jpeg_encode(card)
    figures = {"encode": encode, "writes": check_jpeg_writes(card, launches, kept),
               "render": check_render(kept, card, launches),
               "render_jpeg_package": check_render_pipelined(kept, card, launches)}
    return figures, rows


def jpeg_kernel_rows(jpeg_rows, launches):
    """The ``kernels`` line's rows of J1 and J2 (decoding) and J3 and J4
    (encoding): numbers at 1024^2 gray (the 13c and 18b paths' frames), the
    colour still's beside them."""
    meta = {"jpeg_idct": "jpeg_idct_kernel", "jpeg_color": "jpeg_color_kernel",
            "jpeg_ycc": "jpeg_ycc_kernel", "jpeg_fdct": "jpeg_fdct_kernel"}
    replaces = {"jpeg_idct": "sleap_tpu/io/video.py:327", "jpeg_color": "sleap_tpu/io/video.py:327",
                "jpeg_ycc": "sleap_tpu/io/slp.py:529", "jpeg_fdct": "sleap_tpu/io/slp.py:529"}
    notes = {"sleap_tpu/io/video.py:327": "cv2.imdecode on the host in HDF5Video.get_frame; no TPU kernel",
             "sleap_tpu/io/slp.py:529": "cv2.imencode on the host (.pkg.slp rows, Video.to_hdf5, "
                                        "DirectoryImgStore); no TPU kernel"}
    out = []
    for name, func in meta.items():
        err, r = jpeg_rows[name]
        bound = max(r["bytes_ms"], r["ops_ms"])
        out.append({
            "name": name, "route": "cuda", "source": "sleap_tpu_torch/csrc/jpeg.cu",
            "replaces": replaces[name], "replaces_note": notes[replaces[name]],
            "device_function": func, "launches": sum(launches[name].values()),
            "launches_by_path": launches[name], "max_abs_err": err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": None, "device_ms": r["device_ms"],
            "colour_420": {k: v for k, v in r["colour"].items()},
        })
    return out


# --------------------------------------------------------------------------- #
# Phase 19: still images (progressive JPEG through J1 and J2, BMP, TIFF)
# --------------------------------------------------------------------------- #


STILLS_DIR = ("tests", "torch_data", "stills")


def still_record(name):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, *STILLS_DIR, name)) as fh:
        return json.load(fh)


def read_still(name, folder=STILLS_DIR) -> bytes:
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, *folder, name), "rb") as fh:
        return fh.read()


def check_progressive(card, launches):
    """19a: the committed progressive JPEGs through the card's route (host
    progressive entropy decoder, J1, J2) to cv2's recorded frames, the
    cut ones smoothed by J6; J1 and J2 once a decoded frame; the host
    coefficients against the plain decoder's on the small stills; a 1024^2
    progressive frame's ms beside a baseline one's. Returns the figures it
    prints."""
    from sleap_tpu_torch.io import jpeg

    record = jpeg_record()["stills"]
    names = sorted(n for n in record if "progressive" in n)
    files = {n: read_still(n + ".jpg", JPEG_DIR) for n in names}
    wrappers = {"jpeg_idct": jpeg.idct_cuda, "jpeg_color": jpeg.color_cuda}
    for w in wrappers.values():
        w.launches = 0
    decoded = 0
    for name in names:
        want = record[name]
        if "refused" in want:
            try:
                jpeg.imdecode(files[name], "cuda")
            except jpeg.UnsupportedJpeg as e:
                check(want["refused"] in str(e), f"19a: {name} refused naming {want['refused']}: {e}")
                continue
            check(False, f"19a: {name} must be refused")
        img = jpeg.imdecode(files[name], "cuda")
        check(list(img.shape) == want["shape"] and sha256(img) == want["sha256"],
              f"19a: {name} decodes on the card to cv2's frame")
        decoded += 1
    counts = {k: w.launches for k, w in wrappers.items()}
    for kernel, count in counts.items():
        check(count == decoded, f"19a: {kernel} launched {count} times for {decoded} progressive "
                                f"frames, want {decoded}")
        launches[kernel]["progressive JPEG stills (19a)"] = count
    host_checked = 0
    for name in names:
        if "refused" in record[name]:
            continue
        header = jpeg.parse(files[name])
        if header.blocks <= JPEG_PLAIN_BLOCKS:
            check(np.array_equal(jpeg.coefficients_host(files[name], header).numpy(),
                                 jpeg.coefficients_plain(files[name], header)),
                  f"19a: the host progressive decoder gives the plain coefficients on {name}")
            host_checked += 1
    dev = torch.device("cuda", 0)
    timing = {}
    for name in ("gray_1024", "gray_1024_progressive", "c420_1024", "c420_1024_progressive"):
        data = files.get(name) or read_still(name + ".jpg", JPEG_DIR)
        header = jpeg.parse(data)
        staging = jpeg._staging(header.blocks)
        coefs = jpeg.coefficients_host(data, header, staging).to(dev)
        q = torch.from_numpy(header.quant.astype(np.int32)).to(dev)
        timing[name] = {
            "bytes": len(data), "scans": len(header.scans), "blocks": header.blocks,
            "entropy_ms": median_ms(lambda: jpeg.coefficients_host(data, header, staging), 5),
            "j1_j2_device_ms": device_ms(lambda: jpeg.color_cuda(jpeg.idct_cuda(coefs, q, header), header),
                                         ["jpeg_idct_kernel", "jpeg_color_kernel"]),
            "frame_ms": median_ms(lambda: jpeg.imdecode(data, "cuda"), 5),
        }
    figures = {"files": len(names), "decoded": decoded, "host_vs_plain": host_checked,
               "launches": counts, "ms_1024": timing}
    log(f"19a {decoded} progressive JPEGs decoded on the card to cv2's frames (the truncated ones "
        f"smoothed by J6); J1/J2 launches {counts}; host vs plain coefficients on "
        f"{host_checked} ({card})")
    for name, t in timing.items():
        log(f"19a {name} ({t['bytes']} bytes, {t['scans']} scans, {t['blocks']} blocks): host entropy "
            f"{t['entropy_ms']:.3f} ms, J1 + J2 on the device {t['j1_j2_device_ms']:.4f} ms, whole "
            f"frame on the card's route {t['frame_ms']:.3f} ms ({card})")
    return figures


def check_still_decodes(card):
    """19b: every committed BMP and TIFF still on the card's route to cv2's
    recorded frame or refused naming its feature; the host C LZW and
    PackBits against the plain ones both ways on the strips of the 1024^2
    TIFF; decode ms a 1024^2 frame. Returns the figures it prints."""
    from sleap_tpu_torch.io import stills, tiff

    record = still_record("decoded.json")["stills"]
    decoded = refused = 0
    for name, want in sorted(record.items()):
        data = read_still(name)
        if "refused" in want:
            try:
                stills.imdecode(data, "cuda", name)
            except ValueError as e:
                check(want["refused"] in str(e), f"19b: {name} refused naming {want['refused']}: {e}")
                refused += 1
                continue
            check(False, f"19b: {name} must be refused")
        img = stills.imdecode(data, "cuda", name)
        check([list(img.shape), str(img.dtype)] == [want["shape"], want["dtype"]]
              and sha256(img) == want["sha256"], f"19b: {name} decodes on the card to cv2's frame")
        decoded += 1
    # The host codecs against the plain ones on the 1024^2 TIFF's strips.
    frame = stills.imdecode(read_still("cv2_gray_1024.tif"), "cuda")
    diff = frame.copy()
    diff[:, 1:] -= frame[:, :-1]
    rows = max(1, 8192 // frame.shape[1])
    strips = [diff[y:y + rows].tobytes() for y in range(0, frame.shape[0], rows)]
    for strip in strips:
        lzw = tiff.lzw_encode_host(strip)
        packed = tiff.packbits_encode_host(strip)
        check(lzw == tiff.lzw_encode_plain(strip) and packed == tiff.packbits_encode_plain(strip),
              "19b: the host LZW and PackBits encoders give the plain ones' bytes")
        check(tiff.lzw_decode_host(lzw, len(strip)) == tiff.lzw_decode_plain(lzw, len(strip)) == strip
              and tiff.packbits_decode_host(packed, len(strip)) == strip
              == tiff.packbits_decode_plain(packed, len(strip)),
              "19b: the host LZW and PackBits decoders give the plain ones' bytes")
    timing = {}
    for name in ("cv2_gray_1024.tif", "cv2_gray16_1024.tif"):
        data = read_still(name)
        timing[name] = {"bytes": len(data),
                        "card_route_ms": median_ms(lambda: stills.imdecode(data, "cuda"), 5),
                        "cpu_route_ms": median_ms(lambda: stills.imdecode(data, "cpu"), 1)}
    figures = {"decoded": decoded, "refused": refused, "lzw_strips": len(strips), "ms_1024": timing}
    log(f"19b {decoded} BMP and TIFF stills decoded on the card's route to cv2's frames, {refused} "
        f"refused naming their features; host LZW and PackBits equal the plain ones both ways on "
        f"{len(strips)} strips; 1024^2 decode ms card route / CPU route: " + ", ".join(
            f"{k} {v['card_route_ms']:.2f} / {v['cpu_route_ms']:.1f}" for k, v in timing.items())
        + f" ({card})")
    return figures


def check_still_writes(card, kept):
    """19c: ``encoded.json``'s write cases on the card's route to cv2's
    bytes; phase 8a's frames as a TIFF package (and a PNG one for 19d) and
    as BMP and TIFF ImgStores, read back bitwise on the card. The packages
    stay in ``kept`` ("tif_pkg", "png_pkg"). Returns the figures it
    prints."""
    from sleap_tpu_torch.core.instance import Instance, LabeledFrame
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.core.skeleton import Skeleton
    from sleap_tpu_torch.io import stills
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video

    record = still_record("encoded.json")["frames"]
    t0 = time.perf_counter()
    sources = {}
    for name, want in record.items():
        base, fmt = name.rsplit(".", 1)
        src = base.split("_crop_")[0]
        if src not in sources:
            sources[src] = stills.imdecode(read_still(src), "cuda")
        img = sources[src]
        if "_crop_" in base:
            w, h = (int(v) for v in base.split("_crop_")[1].split("x"))
            img = np.ascontiguousarray(img[1:1 + h, 1:1 + w])
        data = stills.imencode(img, fmt, "cuda")
        check(len(data) == want["bytes"] and sha256(data) == want["sha256"],
              f"19c: {name} encodes on the card's route to cv2's bytes")
    cases_s = time.perf_counter() - t0
    frames, xy = cli_frames()
    skeleton = Skeleton("blob")
    skeleton.add_node("A")
    skeleton.add_node("B")
    video = Video.from_numpy(frames)
    labels = Labels([LabeledFrame(video, i, [Instance(skeleton, np.array([[x - 6, y], [x + 6, y]]))
                                             for x, y in points]) for i, points in enumerate(xy)])
    n = len(frames)
    figures = {"write_cases": len(record), "write_cases_s": cases_s, "frames": n}
    kept["tif_pkg"] = os.path.join(kept["dir"], "frames.tif.pkg.slp")
    kept["png_pkg"] = os.path.join(kept["dir"], "frames.png.pkg.slp")
    t0 = time.perf_counter()
    labels.save(kept["tif_pkg"], with_images=True, image_format="tif")
    figures["tif_pkg_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels.save(kept["png_pkg"], with_images=True)
    figures["png_pkg_write_s"] = time.perf_counter() - t0
    figures["tif_pkg_mb"] = os.path.getsize(kept["tif_pkg"]) / 1e6
    figures["png_pkg_mb"] = os.path.getsize(kept["png_pkg"]) / 1e6
    got = read_labels(kept["tif_pkg"]).video
    check(torch.device(got.backend.device).type == "cuda", "19c: the TIFF package decodes on the card")
    t0 = time.perf_counter()
    back = np.stack([got.get_frame(i) for i in range(n)])
    figures["tif_pkg_read_ms"] = 1e3 * (time.perf_counter() - t0) / n
    check(np.array_equal(back, frames), "19c: the TIFF package holds the frames, bitwise")
    with tempfile.TemporaryDirectory() as root:
        for fmt in ("bmp", "tif"):
            path = os.path.join(root, fmt)
            t0 = time.perf_counter()
            store = video.to_imgstore(path, format=fmt)
            figures[f"{fmt}_imgstore_write_s"] = time.perf_counter() - t0
            figures[f"{fmt}_imgstore_mb"] = sum(
                os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 1e6
            t0 = time.perf_counter()
            back = np.stack([store.get_frame(i) for i in range(n)])
            figures[f"{fmt}_imgstore_read_ms"] = 1e3 * (time.perf_counter() - t0) / n
            check(np.array_equal(back, frames), f"19c: the {fmt} ImgStore holds the frames, bitwise")
    log(f"19c {len(record)} write cases encoded on the card's route to cv2's bytes in {cases_s:.2f} s; "
        f"{n} frames of {IMG}^2 gray: TIFF .pkg.slp {figures['tif_pkg_write_s']:.3f} s "
        f"({figures['tif_pkg_mb']:.2f} MB; PNG {figures['png_pkg_write_s']:.3f} s, "
        f"{figures['png_pkg_mb']:.2f} MB), read on the card {figures['tif_pkg_read_ms']:.2f} ms a frame; "
        f"BMP ImgStore {figures['bmp_imgstore_write_s']:.3f} s ({figures['bmp_imgstore_mb']:.2f} MB, "
        f"read {figures['bmp_imgstore_read_ms']:.2f} ms a frame), TIFF ImgStore "
        f"{figures['tif_imgstore_write_s']:.3f} s ({figures['tif_imgstore_mb']:.2f} MB, read "
        f"{figures['tif_imgstore_read_ms']:.2f} ms a frame); all bitwise ({card})")
    return figures


def check_tiff_cli(td, wrappers, launches, card, kept):
    """19d: ``sleap-track`` on 19c's TIFF package and on its PNG one with
    phase 4's float32 pair on the card, in this process: the same
    predictions exactly, kernels 2, 3 and 1 once a batch. Returns the
    figures it prints."""
    from sleap_tpu_torch.io.slp import read_labels

    runs = {}
    with tempfile.TemporaryDirectory() as root:
        folders = write_run_folders(root)
        paths = [folders["centroid"], folders["instance"]]
        for path, tm in zip(paths, (td.centroid_model, td.confmap_model)):
            torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                       os.path.join(path, "best_model.pt"))
        for name in ("png_pkg", "tif_pkg"):
            out = os.path.join(root, name + ".predictions.slp")
            seconds, counts = cli_run([kept[name], "-m", paths[0], "-m", paths[1], "--batch_size",
                                       str(BATCH), "--max_instances", str(MAX_INSTANCES),
                                       "--verbosity", "none", "-o", out], wrappers)
            runs[name] = {"cli_s": seconds, "launches": counts, "labels": read_labels(out)}
    n = len(runs["tif_pkg"]["labels"])
    n_batches = -(-n // BATCH)
    for name, run in runs.items():
        for kernel, count in run["launches"].items():
            check(count == n_batches, f"19d: {kernel} launched {count} times on the {name}, want one a batch")
    for kernel, count in runs["tif_pkg"]["launches"].items():
        launches[kernel]["CLI TIFF package (19d)"] = count
    insts = [i for lf in runs["tif_pkg"]["labels"] for i in lf.instances]
    check(n == CLI_FRAMES and len(insts) >= n, "19d: frames with instances")
    compare_predictions(runs["tif_pkg"]["labels"], runs["png_pkg"]["labels"], 0.0, 0.0,
                        "19d: TIFF package vs PNG package")
    figures = {"frames": n, "instances": len(insts),
               **{f"{k}_cli_s": v["cli_s"] for k, v in runs.items()},
               **{f"{k}_cli_fps": n / v["cli_s"] for k, v in runs.items()},
               "launches": runs["tif_pkg"]["launches"]}
    log(f"19d sleap-track on the TIFF package: {figures['tif_pkg_cli_fps']:.1f} FPS "
        f"({runs['tif_pkg']['cli_s']:.3f} s for {n} frames; PNG package {figures['png_pkg_cli_fps']:.1f} "
        f"FPS), {len(insts)} instances, the PNG package's predictions exactly; launches "
        f"{runs['tif_pkg']['launches']} ({card})")
    return figures


def check_still_images(td, wrappers, launches, card, kept):
    """Phase 19: 19a-19d, each part's seconds printed."""
    figures = {}
    for part, fn, args in (("19a", check_progressive, (card, launches)),
                           ("19b", check_still_decodes, (card,)),
                           ("19c", check_still_writes, (card, kept)),
                           ("19d", check_tiff_cli, (td, wrappers, launches, card, kept))):
        figures[part] = timed_phase(part, fn, *args)
    return figures


# --------------------------------------------------------------------------- #
# Phase 20: users' own HDF5 files
# --------------------------------------------------------------------------- #


def hdf5_manifest_module():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import hdf5_manifest

    return hdf5_manifest


def check_hdf5_fixtures(card):
    """20a: every object of every committed HDF5 fixture read on the card's
    route (``device="cuda"``: LZF in host C) against ``manifest.json``
    (h5py's read), each refusal raised naming its feature."""
    from sleap_tpu_torch.io import hdf5, lzf

    hm = hdf5_manifest_module()
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), *HDF5_DIR)
    with open(os.path.join(folder, "manifest.json")) as fh:
        record = json.load(fh)
    figures, cwd = {}, os.getcwd()
    os.chdir(folder)  # the external raw file is named relative to it, as libhdf5 resolves it
    try:
        for name, entry in record["files"].items():
            t0 = time.perf_counter()
            with hdf5.File(name, device="cuda") as f:
                got = hm.manifest(f, entry["refused"], probe=True)
                route = f._lzf_decode
            seconds = time.perf_counter() - t0
            diffs = hm.differences(entry["objects"], got)
            check(not diffs, f"20a {name}: the card's route reads what h5py read: {diffs[:3]}")
            check(route is lzf.decode_host, f"20a {name}: LZF decoded in host C ({route})")
            refused = {e["path"]: e["refused"] for e in got if "refused" in e}
            check(refused == entry["refused"], f"20a {name}: refusals {refused}")
            figures[name] = {"objects": len(got), "refused": sorted(refused), "read_s": seconds}
    finally:
        os.chdir(cwd)
    log(f"20a HDF5 fixtures read on the card's route as h5py read them (h5py {record['h5py']}, HDF5 "
        f"{record['hdf5']}): {figures} ({card})")
    return figures


def lzf_streams(path):
    """(stored LZF stream, decoded size) of every LZF chunk of ``path``
    that lzf compressed (a chunk it could not shrink is stored raw), with
    the Fletcher-32 checksum that follows it on the file stripped."""
    from sleap_tpu_torch.io import hdf5

    streams = []

    def walk(group):
        for key, target in group._members.items():
            if isinstance(target, tuple):
                continue  # links to other files: their own chunks are listed there
            try:
                obj = group[key]
            except hdf5.UnsupportedFeature:
                continue  # a refused object (20a holds it to its refusal)
            if isinstance(obj, hdf5.Group):
                walk(obj)
                continue
            ids = [fid for fid, _ in getattr(obj, "filters", [])]
            if 32000 not in ids:
                continue
            at = ids.index(32000)
            size = int(np.prod(obj.chunks)) * obj.dtype.itemsize
            for _, mask, stored, addr in obj._chunk_entries():
                if not mask >> at & 1:
                    stream = bytes(f._buf[addr:addr + stored])
                    streams.append((stream[:-4] if 3 in ids[at + 1:] else stream, size))

    with hdf5.File(path, device="cpu") as f:
        walk(f)
    return streams


def check_lzf_routes(card):
    """20b: LZF decoded by the host C decoder and by the plain one: equal
    bytes on every LZF chunk of the fixtures; ms a 384^2 frame of
    ``latest_raw.slp`` and MB/s on each route."""
    from sleap_tpu_torch.io import lzf

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)), *HDF5_DIR)
    streams = {name: lzf_streams(os.path.join(folder, name)) for name in ("latest_raw.slp", "features.h5",
                                                                       "features_earliest.h5")}
    for name, chunks in streams.items():
        for stream, size in chunks:
            check(lzf.decode_host(stream, size) == lzf.decode_plain(stream),
                  f"20b {name}: host and plain LZF decode to the same bytes")
    frames = streams["latest_raw.slp"]
    check(len(frames) == 8 and all(size == 384 * 384 for _, size in frames), "20b: 8 LZF frames of 384^2")
    routes = {"host": lambda s, n: lzf.decode_host(s, n), "plain": lambda s, n: lzf.decode_plain(s)}
    times = {}
    for label in ("host", "plain", "plain", "host"):  # in turns
        t0 = time.perf_counter()
        for stream, size in frames:
            routes[label](stream, size)
        times.setdefault(label, []).append((time.perf_counter() - t0) / len(frames))
    figures = {"chunks": {k: len(v) for k, v in streams.items()},
               "stored_bytes_a_frame": float(np.mean([len(s) for s, _ in frames]))}
    for label, values in times.items():
        ms = 1e3 * float(np.mean(values))
        figures[f"{label}_ms_a_frame"] = ms
        figures[f"{label}_MB_s"] = 384 * 384 / ms / 1e3
    log(f"20b LZF, {sum(map(len, streams.values()))} chunks equal on both routes; a 384^2 frame "
        f"({figures['stored_bytes_a_frame']:.0f} bytes stored): host C {figures['host_ms_a_frame']:.3f} ms "
        f"({figures['host_MB_s']:.1f} MB/s), plain {figures['plain_ms_a_frame']:.3f} ms "
        f"({figures['plain_MB_s']:.1f} MB/s) ({card})")
    return figures


def check_latest_cli(wrappers, launches, card):
    """20c: ``sleap-track`` (in this process) with phase 8b's trained
    top-down pair on ``latest_raw.slp`` and on ``raw.slp`` (8b's run,
    again), with cuDNN's deterministic algorithms: the same predictions
    exactly, kernels 2, 3 and 1 once a batch; FPS and ms a frame read of
    each. (At cuDNN's defaults two runs of this pair on one file differ by
    up to 3.05e-5 px: the convolutions' algorithm is not bitwise
    repeatable.)"""
    from sleap_tpu_torch.io.slp import read_labels

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    centroid, instance = (os.path.join(runs, f) for f in CLI_TRAINED[:2])
    sources = {"latest_raw.slp": os.path.join(here, *HDF5_DIR, "latest_raw.slp"),
               "raw.slp": os.path.join(here, *FIXTURE_DIR, "raw.slp")}
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp()
    try:
        for name, src in sources.items():
            dst = os.path.join(root, name + ".predictions.slp")
            seconds, counts = cli_run([src, "-m", centroid, "-m", instance, "--peak_threshold", "0.05",
                                       "--batch_size", "4", "--verbosity", "none", "-o", dst], wrappers)
            video = read_labels(src).video
            video.get_frame(0)
            t0 = time.perf_counter()
            for i in range(video.num_frames):
                video.get_frame(i)
            read_ms = 1e3 * (time.perf_counter() - t0) / video.num_frames
            out[name] = {"labels": read_labels(dst), "seconds": seconds, "launches": counts,
                         "read_ms": read_ms, "frames": video.num_frames}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    latest = out["latest_raw.slp"]
    n_batches = -(-latest["frames"] // 4)
    for kernel, count in latest["launches"].items():
        check(count == n_batches, f"20c: {kernel} launched {count} times on latest_raw.slp, want one a batch")
        launches[kernel]["CLI latest_raw.slp (20c)"] = count
    compare_predictions(latest["labels"], out["raw.slp"]["labels"], 0.0, 0.0,
                        "20c: latest_raw.slp vs raw.slp")
    check(sum(len(lf.instances) for lf in latest["labels"]) >= 8, "20c: instances found")
    figures = {name: {"fps": run["frames"] / run["seconds"], "cli_s": run["seconds"],
                      "read_ms_a_frame": run["read_ms"], "launches": run["launches"]}
               for name, run in out.items()}
    log(f"20c sleap-track on latest_raw.slp: {figures['latest_raw.slp']['fps']:.1f} FPS, "
        f"{figures['latest_raw.slp']['read_ms_a_frame']:.3f} ms a frame read (SWMR layout, lzf, host C); "
        f"raw.slp: {figures['raw.slp']['fps']:.1f} FPS, {figures['raw.slp']['read_ms_a_frame']:.3f} ms a "
        f"frame read (gzip); the same predictions (cuDNN deterministic); launches {latest['launches']} ({card})")
    return figures


def check_hdf5_files(wrappers, launches, card):
    """Phase 20: 20a-20c, each part's seconds printed."""
    return {part: timed_phase(part, fn, *args)
            for part, fn, args in (("20a", check_hdf5_fixtures, (card,)),
                                   ("20b", check_lzf_routes, (card,)),
                                   ("20c", check_latest_cli, (wrappers, launches, card)))}


# --------------------------------------------------------------------------- #
# Phase 11: training the other backbones, and their bf16 inference
# --------------------------------------------------------------------------- #


DLC_FRAMES = tuple(range(0, CLI_FRAMES, 2))  # phase 14's DeepLabCut project: 16 of 8a's frames


def match_instances(got, want, tol, what):
    """Two frames' predictions in any order: each instance of ``got`` has
    one of ``want`` whose visible points and scores are within ``tol``.
    Returns (max |dxy|, max |dscore|)."""
    check(len(got) == len(want), f"{what}: {len(got)} instances, want {len(want)}")
    d_xy = d_val = 0.0
    free = list(want)
    for inst in got:
        xy = inst.numpy()

        def gap(other):
            oxy = other.numpy()
            if not np.array_equal(np.isnan(xy), np.isnan(oxy)):
                return np.inf
            return float(np.abs(np.nan_to_num(xy - oxy)).max())

        best = min(free, key=gap)
        d_xy = max(d_xy, gap(best))
        d_val = max(d_val, abs(inst.score - best.score),
                    float(np.abs(inst.points["score"] - best.points["score"]).max()))
        free.remove(best)
    check(d_xy <= tol and d_val <= tol,
          f"{what}: max |dxy| {d_xy:.3g}, max |dscore| {d_val:.3g} (tolerance {tol})")
    return d_xy, d_val


def write_dlc_project(root, frames, xy):
    """A multi-animal DeepLabCut project of ``DLC_FRAMES``: ``config.yaml``,
    ``labeled-data/clip/imgNNNN.png`` (the port's PNG encoder) and
    ``CollectedData_me.csv`` holding each blob's centre. Returns the
    config's path and the PNG encode seconds."""
    from sleap_tpu_torch.io import png

    sub = os.path.join(root, "labeled-data", "clip")
    os.makedirs(sub)
    animals = [f"animal{i}" for i in range(xy.shape[1])]
    with open(os.path.join(root, "config.yaml"), "w") as fh:
        fh.write("Task: blobs\nscorer: me\ndate: Jan1\nmultianimalproject: true\nidentity:\n"
                 f"project_path: {root}\nvideo_sets:\n  {root}/videos/clip.avi:\n"
                 f"    crop: 0, {IMG}, 0, {IMG}\nindividuals:\n" + "".join(f"- {a}\n" for a in animals)
                 + "uniquebodyparts: []\nmultianimalbodyparts:\n- blob\nbodyparts: MULTI!\nskeleton: []\n"
                 "pcutoff: 0.6\n")
    rows = ["scorer," + ",".join(["me"] * 2 * len(animals)),
            "individuals," + ",".join(a for a in animals for _ in "xy"),
            "bodyparts," + ",".join(["blob"] * 2 * len(animals)),
            "coords," + ",".join(c for _ in animals for c in "xy")]
    encode_s = 0.0
    for k in DLC_FRAMES:
        t0 = time.perf_counter()
        data = png.encode(frames[k])
        encode_s += time.perf_counter() - t0
        with open(os.path.join(sub, f"img{k:04d}.png"), "wb") as fh:
            fh.write(data)
        rows.append(f"labeled-data/clip/img{k:04d}.png," + ",".join(repr(float(v)) for v in xy[k].reshape(-1)))
    with open(os.path.join(sub, "CollectedData_me.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return os.path.join(root, "config.yaml"), encode_s


def check_data_model(td, wrappers, launches, card, kept, fps_8a):
    """Phase 14: the card's Python on the labels the card predicted (phase
    8a's tracked ``.slp``): the data model's calls, ``sleap-convert`` to an
    analysis ``.h5`` and ``.csv`` in fresh processes, and a DeepLabCut
    project of 8a's frames imported and tracked by ``sleap-track``. Returns
    the figures it prints."""
    import contextlib
    import io

    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io import formats, hdf5
    from sleap_tpu_torch.io.slp import read_labels

    seconds = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    predicted = kept["labels"]
    labels = step("load", lambda: Labels.load_file(kept["slp"]))
    names = [t.name for t in labels.tracks]
    want = np.full((CLI_FRAMES, len(names), N_NODES, 2), np.nan, np.float32)
    for lf in predicted:
        for inst in lf.instances:
            want[lf.frame_idx, names.index(inst.track.name)] = inst.numpy()
    arr = step("numpy", labels.numpy)
    check(arr.shape == want.shape and np.array_equal(arr, want, equal_nan=True),
          f"14: Labels.numpy() {arr.shape} is 8a's predictions {want.shape}")
    cleared = step("copy and remove_predictions",
                   lambda: (lambda c: (c.remove_predictions(), c)[1])(labels.copy()))
    check(len(cleared) == 0 and len(labels) == CLI_FRAMES
          and np.array_equal(labels.numpy(), arr, equal_nan=True),
          "14: remove_predictions empties the copy and leaves the labels")
    a, b = labels.tracks[0], labels.tracks[1]
    half = CLI_FRAMES // 2
    step("track_swap", lambda: labels.track_swap(labels.video, b, a, (0, half)))
    swapped = arr.copy()
    swapped[:half, [0, 1]] = arr[:half, [1, 0]]
    check(np.array_equal(labels.numpy(), swapped, equal_nan=True), "14: track_swap swaps the columns")
    labels.track_swap(labels.video, a, b, (0, half))
    check(np.array_equal(labels.numpy(), arr, equal_nan=True), "14: track_swap back")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        step("describe", labels.describe)
    n_insts = sum(len(lf.instances) for lf in predicted)
    check(f"Frames (user/predicted): 0/{CLI_FRAMES}" in printed.getvalue()
          and f"Instances (user/predicted): 0/{n_insts}" in printed.getvalue(),
          f"14: describe: {printed.getvalue()[-200:]}")
    # (the merged frame brings the other file's skeleton: describe first)
    labels.remove_frame(labels.labeled_frames[-1])
    step("merge", lambda: labels.merge(Labels.load_file(kept["slp"])))
    check([len(lf.instances) for lf in labels] == [len(lf.instances) for lf in predicted],
          "14: merge adds the missing frame and no duplicate")
    check(np.array_equal(labels.labeled_frames[-1].numpy(), predicted.labeled_frames[-1].numpy(),
                         equal_nan=True), "14: the merged frame's points")

    # sleap-convert in fresh processes: the analysis .h5, then the CSV.
    here = os.path.dirname(os.path.abspath(__file__))
    stem = os.path.join(kept["dir"], "clip.predictions.000_clip.analysis")
    for fmt, suffix in (("analysis", ".h5"), ("analysis.csv", ".csv")):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "sleap_tpu_torch.io.convert", kept["slp"], "--format", fmt],
                             cwd=here, capture_output=True, text=True, timeout=300)
        seconds[f"convert {fmt}"] = time.perf_counter() - t0
        check(run.returncode == 0 and f"Saved: {stem}{suffix}" in run.stdout,
              f"14: sleap-convert --format {fmt}: exit {run.returncode} {run.stdout[-300:]} {run.stderr[-2000:]}")
    fresh = Labels.load_file(kept["slp"]).numpy()
    occupied = ~np.all(np.isnan(fresh), axis=(0, 2, 3))
    imported = step("analysis import", lambda: formats.read(stem + ".h5"))
    check(np.array_equal(imported.numpy(all_frames=False), fresh[:, occupied], equal_nan=True),
          "14: the analysis file's tracks read back equal labels.numpy()")
    with hdf5.File(stem + ".h5") as f:
        raw = f["tracks"][:].T  # (frames, nodes, 2, tracks)
    check(np.array_equal(raw.transpose(0, 3, 1, 2), fresh[:, occupied].astype(np.float64), equal_nan=True),
          "14: the analysis file's tracks dataset")
    with open(stem + ".csv") as fh:
        rows = list(csv.reader(fh))
    got_xy = {(int(r[0]), r[1]): [float(v) if v else np.nan for v in r[3:]] for r in rows[1:]}
    check(len(got_xy) == n_insts, f"14: {len(got_xy)} CSV rows, want {n_insts}")
    bad = [k for k, v in got_xy.items() if not np.array_equal(
        np.asarray(v).reshape(N_NODES, 3)[:, :2],
        fresh[k[0], names.index(k[1])].astype(np.float64), equal_nan=True)]
    check(not bad, f"14: CSV points differ at {bad[:3]}")

    # A DeepLabCut project of 8a's frames, imported and tracked.
    frames, xy = cli_frames()
    with tempfile.TemporaryDirectory() as root:
        config, encode_s = write_dlc_project(os.path.join(root, "blobs-me-2026-01-01"), frames, xy)
        seconds["dlc write (png encode)"] = encode_s
        dlc = step("dlc import", lambda: formats.read(config))
        check(len(dlc) == len(DLC_FRAMES) and [t.name for t in dlc.tracks] == [f"animal{i}" for i in range(4)],
              "14: the DeepLabCut project's frames and individuals")
        points = np.stack([[i.numpy()[0] for i in lf.instances] for lf in dlc])
        check(np.array_equal(points, xy[list(DLC_FRAMES)]), "14: the project's points are the blob centres")
        decoded = step("dlc frames decode", lambda: dlc.video[:])
        check(np.array_equal(decoded, frames[list(DLC_FRAMES)]), "14: the PNG frames decode bitwise")
        dlc_slp = os.path.join(root, "dlc.slp")
        step("dlc save", lambda: dlc.save(dlc_slp))
        folders = write_run_folders(root)
        paths = [folders["centroid"], folders["instance"]]
        for path, tm in zip(paths, (td.centroid_model, td.confmap_model)):
            torch.save({k: v.float().cpu() for k, v in tm.module.state_dict().items()},
                       os.path.join(path, "best_model.pt"))
        out = os.path.join(root, "dlc.predictions.slp")
        cli_s, counts = cli_run([dlc_slp, "-m", paths[0], "-m", paths[1], "--batch_size", str(BATCH),
                                 "--max_instances", str(MAX_INSTANCES), "--verbosity", "none", "-o", out],
                                wrappers)
        seconds["dlc sleap-track"] = cli_s
        got = read_labels(out)
    n_batches = -(-len(DLC_FRAMES) // BATCH)
    for kernel, count in counts.items():
        check(count == n_batches, f"14: {kernel} launched {count} times by the CLI, want one a batch")
        launches[kernel]["CLI DeepLabCut project (14)"] = count
    by_frame = {lf.frame_idx: lf for lf in predicted}
    check([lf.frame_idx for lf in got] == list(range(len(DLC_FRAMES))), "14: a prediction a project frame")
    d_xy = d_val = 0.0
    for lf in got:
        dx, dv = match_instances(lf.instances, by_frame[DLC_FRAMES[lf.frame_idx]].instances, CLI_TOL,
                                 f"14: DeepLabCut frame {lf.frame_idx} vs 8a frame {DLC_FRAMES[lf.frame_idx]}")
        d_xy, d_val = max(d_xy, dx), max(d_val, dv)
    fps = len(DLC_FRAMES) / cli_s
    figures = {"seconds": seconds, "tracks_shape": list(arr.shape), "instances": n_insts,
               "dlc_frames": len(DLC_FRAMES), "dlc_cli_fps": fps, "cli_fps_8a": fps_8a,
               "launches": counts, "max_abs_dxy": d_xy, "max_abs_dscore": d_val}
    for name, value in seconds.items():
        log(f"14 {name}: {value:.3f} s ({card})")
    log(f"14 sleap-track on the DeepLabCut project ({len(DLC_FRAMES)} PNG frames of {IMG}^2): "
        f"{cli_s:.3f} s = {fps:.1f} FPS (8a: {fps_8a:.1f} FPS); launches {counts}; vs 8a max |dxy| "
        f"{d_xy:.3g}, max |dscore| {d_val:.3g} ({card})")
    return figures


# --------------------------------------------------------------------------- #
# Phase 15: sleap-export and re-tracking
# --------------------------------------------------------------------------- #


def program_arrays(out):
    """An exported program's outputs as the host arrays ``predict`` keeps."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy() for k, v in out.items()}


def exported_vs_predict(pred, got, want):
    """Largest |difference| of a program batch's outputs, through the
    predictor's host step, from one ``predict`` example: points and values
    separately; NaN patterns and masks must be equal."""
    host = pred._postprocess(program_arrays(got), {"scale": np.ones(len(want["frame_ind"]), np.float32)})
    d_xy = d_val = 0.0
    for key, value in host.items():
        pairs = zip(value, want[key]) if isinstance(value, list) else [(value, want[key])]
        for a, b in pairs:
            a, b = np.asarray(a), np.asarray(b)
            check(a.shape == b.shape and np.array_equal(np.isnan(a.astype(np.float64)),
                                                        np.isnan(b.astype(np.float64))),
                  f"15: {key} shapes and NaN patterns")
            d = float(np.abs(np.nan_to_num(a.astype(np.float64) - b.astype(np.float64))).max(initial=0))
            if key in ("instance_peaks", "centroids", "points"):
                d_xy = max(d_xy, d)
            else:
                d_val = max(d_val, d)
    return d_xy, d_val


def check_exported(name, pred, frames, want, wrappers, launches, fps, card, batch=BATCH):
    """15a-c: ``pred`` exported on the card at its batch and the frames'
    size, loaded back with ``load_exported_model`` and run on the frames
    ``predict`` ran in its timed batches (``want``, its example dicts):
    outputs within EXPORT_XY_TOL and EXPORT_VAL_TOL of ``predict``'s, each
    kernel of ``wrappers`` launched once a batch; FPS beside ``predict``'s."""
    from sleap_tpu_torch.inference.export import load_exported_model

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        pred.export_model(root, image_size=frames.shape[1])
        export_s = time.perf_counter() - t0
        with open(os.path.join(root, "info.json")) as f:
            info = json.load(f)
        program_mb = os.path.getsize(os.path.join(root, "model.pt2")) / 1e6
        t0 = time.perf_counter()
        program = load_exported_model(root)
        load_s = time.perf_counter() - t0
    check(torch.device(info["device"]).type == "cuda" and info["input_shape"] == [batch, *frames.shape[1:]],
          f"15 {name}: a program for the card and the path's batches ({info})")
    program(frames[:batch])  # warm-up
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs = [program(frames[i:i + batch]) for i in range(batch, len(frames), batch)]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = {k: w.launches for k, w in wrappers.items()}
    for kernel, count in counts.items():
        check(count == len(outs), f"15 {name}: {kernel} launched {count} times, want one a batch")
        launches[kernel][f"exported {name} (15)"] = count
    check(len(want) == len(outs), f"15 {name}: a predict batch for each program batch")
    diffs = [exported_vs_predict(pred, got, ex) for got, ex in zip(outs, want)]
    d_xy, d_val = max(d for d, _ in diffs), max(d for _, d in diffs)
    program_fps = (len(frames) - batch) / run_s
    figures = {"predictor": info["predictor"], "export_s": export_s, "load_s": load_s,
               "program_mb": program_mb, "fps": program_fps, "predict_fps": fps,
               "max_abs_dxy": d_xy, "max_abs_dval": d_val, "launches": counts}
    log(f"15 exported {name} ({info['predictor']}, {info['compute_dtype']}, input "
        f"{info['input_shape']}): export {export_s:.2f} s, {program_mb:.1f} MB, load {load_s:.2f} s; "
        f"{len(frames) - batch} frames in {run_s:.3f} s = {program_fps:.1f} FPS (predict: {fps:.1f} "
        f"FPS); launches {counts}; vs predict max |dxy| {d_xy:.3g}, max |dval| {d_val:.3g} ({card})")
    check(d_xy <= EXPORT_XY_TOL and d_val <= EXPORT_VAL_TOL,
          f"15 {name}: the program vs predict: max |dxy| {d_xy:.3g} (tolerance {EXPORT_XY_TOL}), "
          f"max |dval| {d_val:.3g} ({EXPORT_VAL_TOL})")
    return figures


def check_trained_export(drive, wrappers, launches, fps, card):
    """15c: the trained ``.convergence_runs`` single-instance folder, read
    from its checkpoint, through ``predict`` (timed as the paths are) and
    as an exported program, on 4g's frames (RGB, as the model was trained)."""
    import sleap_tpu_torch

    name, folders, size = TRAINED[2]
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".convergence_runs", folders[0])
    frames = np.repeat(synthetic_frames((1 + TIMED_BATCHES) * SI_BATCH, seed=0, size=size,
                                        blobs=TRAINED_BLOBS, sigma=TRAINED_SIGMA), 3, axis=-1)
    pred = sleap_tpu_torch.load_model(path, batch_size=SI_BATCH, peak_threshold=0.05)
    label = f"{name} (15c)"
    want = drive(label, pred, frames, wrappers, SI_BATCH)
    return check_exported(name, pred, frames, want, wrappers, launches, fps[label], card, SI_BATCH)


def check_retrack(kept, card):
    """15d: phase 8a's tracked ``.slp`` re-tracked by the tracker's ``main``
    (flow) on the card and with ``--cpu``: the same instances and tracks;
    then ``trackcleaner`` to MAX_INSTANCES a frame, and ``summary`` and
    ``metrics`` on the result. Returns the figures it prints. (Run beside
    the exports in a second process, the CPU's flow and the exports' tracing
    slowed each other 4-5x on the card's machine.)"""
    import contextlib
    import io

    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.info import metrics, summary, trackcleaner
    from sleap_tpu_torch.tracking import tracker

    seconds, outs = {}, {}
    for where, flags in (("card", []), ("cpu", ["--cpu"])):
        outs[where] = os.path.join(kept["dir"], f"retracked.{where}.slp")
        t0 = time.perf_counter()
        tracker.main([kept["slp"], "-o", outs[where], *flags])
        seconds[f"retrack {where}"] = time.perf_counter() - t0
    card_labels, cpu_labels = (Labels.load_file(outs[w]) for w in ("card", "cpu"))
    insts = [i for lf in card_labels for i in lf.instances]
    check(len(card_labels) == CLI_FRAMES and insts and all(i.track is not None for i in insts),
          "15d: every instance re-tracked")
    compare_predictions(card_labels, cpu_labels, 0.0, 0.0, "15d: re-tracked on the card vs --cpu")
    score_d = max(abs(x.tracking_score - y.tracking_score)
                  for a, b in zip(card_labels, cpu_labels) for x, y in zip(a.instances, b.instances))
    check(score_d <= TRACK_SCORE_TOL, f"15d: tracking scores card vs --cpu {score_d:.3g}")
    same_as_8a = all((x.track and x.track.name) == (y.track and y.track.name)
                     for a, b in zip(card_labels, kept["labels"]) for x, y in zip(a.instances, b.instances))
    cleaned = os.path.join(kept["dir"], "retracked.cleaned.slp")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        trackcleaner.main([outs["card"], "-c", str(MAX_INSTANCES), "-o", cleaned])
    seconds["trackcleaner"] = time.perf_counter() - t0
    clean = Labels.load_file(cleaned)
    check(len(clean) == CLI_FRAMES and max(len(lf.instances) for lf in clean) <= MAX_INSTANCES
          and all(i.track is not None for lf in clean for i in lf.instances),
          f"15d: trackcleaner leaves at most {MAX_INSTANCES} tracked animals a frame")
    t0 = time.perf_counter()
    series = summary.StatisticSeries(clean)
    counts = series.get_point_count_series(clean.video)
    scores = series.get_instance_score_series(clean.video)
    moves = series.get_point_displacement_series(clean.video, reduction="max")
    # The two files hold the same instances in the same order: paired in
    # order, every distance is 0.
    frame_idxs, dists, _, _ = metrics.matched_instance_distances(
        card_labels, cpu_labels, match_lists_function=lambda a, b: (a, b))
    seconds["summary and metrics"] = time.perf_counter() - t0
    check(sorted(counts) == list(range(CLI_FRAMES)) and all(v > 0 for v in counts.values())
          and all(np.isfinite(v) for v in scores.values()) and len(moves) >= CLI_FRAMES - 1,
          "15d: a statistic for every frame")
    check(len(frame_idxs) == len(insts) and np.nanmax(dists) == 0.0,
          "15d: metrics pair the card's and the CPU's instances at distance 0")
    figures = {"seconds": seconds, "instances": len(insts), "tracks": len(card_labels.tracks),
               "max_tracking_score_diff": score_d, "tracks_as_8a": same_as_8a,
               "max_displacement_px": max(moves.values())}
    log(f"15d re-tracked 8a's .slp ({CLI_FRAMES} frames of {IMG}^2, {len(insts)} instances): "
        f"card {seconds['retrack card']:.2f} s, --cpu {seconds['retrack cpu']:.2f} s, equal tracks "
        f"({len(card_labels.tracks)}), tracking scores within {score_d:.3g}, tracks as 8a's: "
        f"{same_as_8a}; trackcleaner {seconds['trackcleaner']:.2f} s; summary and metrics "
        f"{seconds['summary and metrics']:.3f} s ({card})")
    return figures


def step_grads(trainer, init, examples, dtype, inputs=None, backward=True):
    """One train-mode forward (and, with ``backward``, backward) of
    ``trainer``'s module from the weights and statistics ``init`` on
    ``examples``: float32 runs the trainer's own ``compute_loss`` (ground
    truth made on the trainer's device); float64 a float64 copy of the module
    on ``inputs`` (images and ground truth, the same tensors for every
    device) with the trainer's loss terms summed in float64 (the trainer's
    own loss is float32). Returns (loss, gradients (empty without
    ``backward``), running statistics) on the CPU."""
    if dtype == torch.float32:
        module = trainer.module
        module.load_state_dict(init)
        module.train()
        module.zero_grad()
        with torch.set_grad_enabled(backward):
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
    grads = {}
    if backward:
        loss.backward()
        grads = {n: p.grad.detach().double().cpu() for n, p in module.named_parameters()}
    stats = {k: v.detach().double().cpu() for k, v in module.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, stats


def step_differences(card, cpu):
    """(loss, gradients, statistics) of two steps: the loss's relative
    difference; the largest gradient difference over that gradient's
    largest magnitude, floored at BB_STEP_GRAD_RTOL of the step's largest
    gradient (a bias in front of a train-mode batch norm has gradient 0 in
    exact arithmetic); the largest running-statistic difference over that
    statistic's largest magnitude, a mean's measured in units of its
    layer's standard deviation (a mean can be 0 in exact arithmetic); the
    gradient difference is None where the steps computed no gradients."""
    (l_a, g_a, s_a), (l_b, g_b, s_b) = card, cpu
    grad = None  # a step without gradients
    if g_b:
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
    td_frames = td_frames[:(1 + BB_TIMED_BATCHES) * BATCH]
    root = tempfile.mkdtemp(prefix="chip_smoke_backbones_")
    try:
        t10 = time.perf_counter()
        backbones, models, si_frames = check_backbones(root, drive, fps, td_frames, td_wrappers,
                                                       si_wrappers, card)
        log(f"phase 10 took {time.perf_counter() - t10:.1f} s")
        t11 = time.perf_counter()
        training = {
            "11a steps": timed_phase("11a", check_backbone_steps, card),
            "11b throughput": timed_phase("11b", check_backbone_train_throughput, card),
            "11c sleap-train Hourglass": timed_phase("11c", check_backbone_cli_train, card,
                                                     si_wrappers, launches),
            "11d bf16": timed_phase("11d", check_backbones_bf16, drive, fps, td_frames, si_frames,
                                    models, card)}
        log(f"phase 11 took {time.perf_counter() - t11:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return backbones, training


def check_backbone_steps(card):
    """11a: one train step of each backbone at its default width on
    BB_STEP_BATCH blob frames of BB_STEP_SIZE^2, on the card and on the
    CPU from the same lecun-seeded weights, TF32 off. Float32, through the
    trainer, forward only: the loss within BB_STEP_LOSS_RTOL; the
    statistics' differences are printed, not held, and no float32 gradient
    is computed (a deep batch-norm net at its initial weights amplifies
    float32 rounding and the two devices' one-ulp differences in the ground
    truth to 1e-2 of a gradient, PERF.md section 6, so no gate read them;
    their backward pass on the CPU was host time). Float64, on the
    same images and ground truth: the loss within BB_STEP_LOSS_RTOL, the
    gradients within BB_STEP_GRAD_RTOL and the running statistics within
    BB_STEP_STATS_RTOL, each statistic moved from the init."""
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
            steps = [step_grads(t, init, examples, dtype, inputs, backward=dtype == torch.float64)
                     for t in (on_card, on_cpu)]
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
    """11b: BB_TRAIN_STEPS synchronised train steps after TRAIN_WARMUP of each
    backbone at its default width, float32 and mixed precision: single-
    instance BB_SI_IMG^2, batch BB_SI_BATCH, and the top-down
    centered-instance pretrained-encoder ResNet-50 on crops of CROP from
    1024^2 frames, batch TRAIN_BATCH (``bench.py``'s train_topdown shape)."""
    from sleap_tpu_torch.models.encoder_decoder import FlaxBatchNorm2d

    results = {}
    for name in BB_TRAIN_BACKBONES:
        topdown = name == "pretrained-encoder ResNet-50"
        for mixed in (False, True):
            t0 = time.perf_counter()
            trainer = backbone_trainer(name, topdown, mixed)
            batch = bench_batch("topdown" if topdown else "single", trainer.device,
                                size=IMG if topdown else BB_SI_IMG,
                                batch=TRAIN_BATCH if topdown else BB_SI_BATCH,
                                animals=3 if topdown else 1)
            key = (f"11b train {'top-down' if topdown else 'single-instance'} {name} "
                   f"{'mixed precision' if mixed else 'f32'}")
            # The profiler sessions of a mixed-precision step (15-20 s each
            # for HRNet and EfficientNet-b0, host bound) are left out, and
            # HRNet's float32 ones (~14 s of its 19: 22,866 launches a step,
            # profiled until two sessions agree; PERF.md section 5 has its
            # busy share). No gate reads them.
            results[key] = time_train_steps(key, trainer, batch, card, steps=BB_TRAIN_STEPS,
                                            profile=not mixed and name != "HRNet")
            results[key]["seconds"] = time.perf_counter() - t0  # set-up, steps, profile
            bns = [m for m in trainer.module.modules() if isinstance(m, FlaxBatchNorm2d)]
            check(all(t.dtype == torch.float32 for m in bns for t in (*m.parameters(), *m.buffers())),
                  f"{key}: float32 batch norm")
            check(all(bool(torch.isfinite(m.running_var).all()) for m in bns),
                  f"{key}: finite running statistics")
            del trainer, batch
            torch.cuda.empty_cache()
            log(f"{key}: {time.perf_counter() - t0:.1f} s with set-up and profile")
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
            h5.create_dataset("video", data=frames[:BB_CLI_FRAMES], compression=None)
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
# Phase 16: the host modules (diagnostic, system, from_trained_models,
# VisualPredictor, NWB/NIX, image-feature suggestions, prefs, util, message)
# --------------------------------------------------------------------------- #

# The optional packages the port imports only inside the functions that need
# them; sleap-diagnostic must import none of them either.
OPTIONAL_PACKAGES = ("sklearn", "zmq", "pynwb", "ndx_pose", "nixio")
VISUAL_CPU_FRAMES = 4

_HOST_MODULES_CHILD = r"""
import json, os, socket, sys, tempfile, threading, time

import numpy as np

from sleap_tpu_torch import message, prefs, util
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.info.feature_suggestions import FeatureSuggestionPipeline
from sleap_tpu_torch.info.suggestions import VideoFrameSuggestions
from sleap_tpu_torch.io import hdf5

clip, n_frames = sys.argv[1], int(sys.argv[2])
out = {}

# 16d: features of the clip's frames (decoded on the card), then suggestions.
labels = Labels.load_file(clip)
video = labels.videos[0]
for feature in ("raw", "hog"):
    pipeline = FeatureSuggestionPipeline(per_video=n_frames, feature_type=feature)
    t0 = time.perf_counter()
    feats = np.stack([pipeline._frame_feature(video.get_frame(i)) for i in pipeline.get_sample_idxs(video)])
    out[feature] = {"shape": list(feats.shape), "finite": bool(np.isfinite(feats).all()),
                    "varies": bool(feats.std(axis=0).max() > 0), "s": time.perf_counter() - t0}
params = {"videos": labels.videos, "per_video": n_frames, "sample_method": "stride", "scale": 1.0,
          "merge_video_features": "across all videos", "feature_type": "hog", "pca_components": 3,
          "n_clusters": 4, "per_cluster": 2}
try:
    got = VideoFrameSuggestions.image_feature_based_method(labels=labels, **params)
    out["suggestions"] = {"ran": True, "frames": sorted([s.frame_idx, s.group] for s in got)}
except ImportError as e:
    out["suggestions"] = {"ran": False, "error": str(e)}

with tempfile.TemporaryDirectory() as home:
    # prefs in a temporary HOME: never the machine's own.
    prefs.Preferences._filename = os.path.join(home, ".sleap_tpu", "preferences.yaml")
    p = prefs.Preferences()
    p["marker size"], p["palette"] = 9, "alphabet"
    try:
        p.save()
        q = prefs.Preferences()
        out["prefs"] = {"saved": True, "read_back": [q["marker size"], q["palette"], q["trail width"]]}
    except ImportError as e:
        out["prefs"] = {"saved": False, "error": str(e)}
    path = os.path.join(home, "dict.h5")
    data = {"a": np.arange(12, dtype="f4").reshape(3, 4), "b": {"c": ["x", "yy"], "d": np.int64(7)}}
    with hdf5.Writer(path) as w:
        util.save_dict_to_hdf5(w, "root", data)
    group = util.read_hdf5_group(path, "root")
    out["hdf5"] = {"keys": sorted(group),
                   "equal": bool(np.array_equal(group["root/a"], data["a"])
                                 and [v.decode() for v in group["root/b/c"]] == data["b"]["c"]
                                 and int(util.read_hdf5_dataset(path, "root/b/d")) == 7)}
try:
    import zmq  # noqa: F401
except ImportError:
    zmq = None
if zmq is None:
    try:
        message.PairedSender("tcp://127.0.0.1:1").setup()
        out["zmq"] = {"present": False, "error": None}
    except ImportError as e:
        out["zmq"] = {"present": False, "error": str(e)}
else:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    sender, receiver = message.PairedSender(address), message.PairedReceiver(address)
    sender.setup()
    receiver.setup()
    done = threading.Event()
    thread = threading.Thread(target=lambda: [receiver.check_messages(0.01) for _ in iter(done.is_set, True)])
    thread.start()
    shook = sender.send_handshake(timeout=10.0)
    done.set()
    thread.join()
    sender.send_dict({"event": "epoch_end"})
    got = []
    for _ in range(50):
        got += receiver.check_messages(0.1)
        if got:
            break
    sender.close()
    receiver.close()
    out["zmq"] = {"present": True, "handshake": shook, "received": got}
print(json.dumps(out))
"""


def start_host_modules_child(here, clip):
    """16d's and 16e's child process, started first so it runs beside
    16a-16c. What may import an optional package runs there, not in this
    process, whose JAX-side check counts yaml, attr and pandas: PyYAML to
    save preferences, scikit-learn (which imports attr and pandas) for the
    suggestions, pyzmq for the pair."""
    return subprocess.Popen([sys.executable, "-c", _HOST_MODULES_CHILD, clip, str(CLI_FRAMES)],
                            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_diagnostic(here, card):
    """16a: ``python -m sleap_tpu_torch.diagnostic`` in a fresh process
    names this card and imports nothing of the JAX side or of the optional
    packages; this process's ``system`` finds the card."""
    from sleap_tpu_torch import system

    watched = JAX_SIDE + OPTIONAL_PACKAGES
    code = ("import runpy, sys; runpy.run_module('sleap_tpu_torch.diagnostic', run_name='__main__'); "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({watched!r})))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"16a: sleap-diagnostic exit {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    summary, loaded = lines[:-1], lines[-1]
    for line in summary:
        log(f"16a sleap-diagnostic | {line}")
    name = torch.cuda.get_device_name(0)
    check(any(name in line for line in summary), f"16a: sleap-diagnostic names the card ({name})")
    check(loaded == "[]", f"16a: sleap-diagnostic imported {loaded}")
    gpus = system.get_all_gpus()
    check(len(gpus) >= 1 and system.is_accelerator_system() and system.get_all_tpus() == gpus,
          f"16a: system finds the card ({gpus})")
    check(system.best_logical_device_name() == "cuda:0", "16a: cuda:0 is the current device")
    log("16a system.summary():")
    system.summary()
    log(f"16a sleap-diagnostic in a fresh process: {seconds:.1f} s ({card})")
    return {"fresh_process_s": seconds, "summary": summary, "gpus": len(gpus)}


def from_trained_vs_load_model(name, build, folders, runs, wrappers, launches, total):
    """16b for one trained head type: its predictor from
    ``from_trained_models`` against ``load_model``'s on 4g's frames, both
    warmed up; the kernels' launches of the former's run are counted."""
    import sleap_tpu_torch

    size = next(s for n, _, s in TRAINED if n == name)
    paths = [os.path.join(runs, f) for f in folders]
    frames = synthetic_frames(4, seed=0, size=size, blobs=TRAINED_BLOBS, sigma=TRAINED_SIGMA)
    built = build(paths)
    loaded = sleap_tpu_torch.load_model(paths, batch_size=4, peak_threshold=0.05)
    check(type(built) is type(loaded) and built.device.type == "cuda", f"16b {name}: on the card")
    for pred in (loaded, built):  # warm-up: cuDNN plans
        pred.predict(frames, make_labels=False)
    want = loaded.predict(frames, make_labels=False)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    got = built.predict(frames, make_labels=False)
    torch.cuda.synchronize()
    counts = {k: w.launches for k, w in wrappers.items() if w.launches}
    for kernel, count in counts.items():
        launches[kernel][f"from_trained_models {name} (16b)"] = count
        total[kernel] += count
    d_xy, d_val = outputs_diff(got, want)
    r_xy, r_val = outputs_diff(loaded.predict(frames, make_labels=False), want)
    check(d_xy == 0.0 and d_val == 0.0, f"16b {name}: from_trained_models equals load_model "
          f"(max |dxy| {d_xy}, max |dval| {d_val}; load_model against itself {r_xy}, {r_val})")
    log(f"16b {name} ({type(built).__name__}) from_trained_models vs load_model on the card: "
        f"max |dxy| {d_xy}, max |dval| {d_val} (load_model against itself {r_xy}, {r_val}); "
        f"launches {counts}")
    return {"launches": counts}


def check_from_trained_models(td_cpu, wrappers, launches, card):
    """16b with cuDNN's deterministic convolutions: two runs of the same
    weights agree bit for bit only with them (the default ones differ by a
    few ulps from call to call: 3.8e-06 px on the trained top-down pair)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _check_from_trained_models(td_cpu, wrappers, launches, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _check_from_trained_models(td_cpu, wrappers, launches, card):
    """16b: each head type built with ``from_trained_models`` from the
    trained ``.convergence_runs`` folders, on the card, on 4g's frames:
    outputs equal ``load_model``'s exactly, and kernels 1, 2 and 3 launch.
    Then VisualPredictor on phase 4's float32 centroid folder (full width,
    1024^2, batch 16; the weights phase 4 ran) and on the trained bottom-up
    folder: its maps equal the module's head outputs on the card and the
    same predictor's on the CPU within PATH_VAL_TOL."""
    import sleap_tpu_torch
    from sleap_tpu_torch.inference.bottomup import BottomUpPredictor
    from sleap_tpu_torch.inference.multiclass import TopDownMultiClassPredictor
    from sleap_tpu_torch.inference.predictors import (
        SingleInstancePredictor,
        TopDownPredictor,
        VisualPredictor,
        _preprocess,
    )
    from sleap_tpu_torch.models.params import flax_from_state_dict
    from sleap_tpu_torch.precision import ieee_fp32

    runs = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".convergence_runs")
    builders = {
        "trained top-down": lambda p: TopDownPredictor.from_trained_models(
            centroid_model_path=p[0], confmap_model_path=p[1], batch_size=4, peak_threshold=0.05),
        "trained bottom-up": lambda p: BottomUpPredictor.from_trained_models(
            p[0], batch_size=4, peak_threshold=0.05),
        "trained single-instance": lambda p: SingleInstancePredictor.from_trained_models(
            p[0], batch_size=4, peak_threshold=0.05),
        "trained multiclass": lambda p: TopDownMultiClassPredictor.from_trained_models(
            centroid_model_path=p[0], confmap_model_path=p[1], batch_size=4, peak_threshold=0.05),
    }
    figures, total = {}, {k: 0 for k in wrappers}
    for name, folders, _ in TRAINED:
        figures[name] = from_trained_vs_load_model(name, builders[name], folders, runs, wrappers,
                                                   launches, total)
    for kernel in ("global_peaks", "local_peaks", "crop_unit"):
        check(total[kernel] > 0, f"16b: kernel {kernel} launched by from_trained_models predictors")

    # VisualPredictor on phase 4's float32 centroid model, and the trained
    # bottom-up folder; the CPU runs the first VISUAL_CPU_FRAMES frames.
    visual = {}
    with tempfile.TemporaryDirectory() as root:
        folder = write_run_folders(root)["centroid"]
        params = {folder: flax_from_state_dict(td_cpu.centroid_model.module)}
        cases = [("phase 4 centroid float32", folder, params, synthetic_frames(BATCH, seed=16), BATCH),
                 ("trained bottom-up", os.path.join(runs, TRAINED[1][1][0]), None,
                  synthetic_frames(4, seed=0, size=TRAINED[1][2], blobs=TRAINED_BLOBS,
                                   sigma=TRAINED_SIGMA), 4)]
        for name, path, weights, frames, batch in cases:
            gpu = VisualPredictor.from_trained_models(path, params=weights, batch_size=batch)
            cpu = VisualPredictor.from_trained_models(path, device="cpu", params=weights,
                                                      batch_size=VISUAL_CPU_FRAMES)
            gpu.predict(frames)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gpu.predict(frames)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            want = cpu.predict(frames[:VISUAL_CPU_FRAMES])
            tm = gpu.model
            with torch.inference_mode(), ieee_fp32():
                imgs = _preprocess(torch.from_numpy(frames).cuda(), tm.grayscale, tm.input_scale,
                                   tm.pad_to_stride, imagenet_mode=tm.imagenet_mode)
                heads = {k: v.float().cpu().numpy() for k, v in tm.module(imgs).items()}
            check(len(got) == 1 and set(got[0]) >= set(gpu.head_specific_output_keys()),
                  f"16b VisualPredictor {name}: one batch of {gpu.head_specific_output_keys()}")
            d_cpu, d_module = 0.0, 0.0
            for key, value in got[0].items():
                if key in ("frame_ind", "video_ind"):
                    continue
                d_cpu = max(d_cpu, float(np.abs(value[:VISUAL_CPU_FRAMES] - want[0][key]).max()))
                head = next(k for k in heads if VisualPredictor._NAMES.get(k) == key)
                d_module = max(d_module, float(np.abs(value - heads[head]).max()))
            check(d_module == 0.0, f"16b VisualPredictor {name}: maps equal the module's ({d_module})")
            check(d_cpu <= PATH_VAL_TOL, f"16b VisualPredictor {name}: card vs CPU {d_cpu}")
            shapes = {k: list(v.shape) for k, v in got[0].items() if k not in ("frame_ind", "video_ind")}
            visual[name] = {"maps": shapes, "max_abs_vs_module": d_module, "max_abs_vs_cpu": d_cpu,
                            "card_s": card_s}
            log(f"16b VisualPredictor {name}: maps {shapes}; vs the module's heads {d_module}, card vs "
                f"CPU max |d| {d_cpu:.3g}; {card_s:.3f} s a batch of {batch} on the card ({card})")
    return {"from_trained_models": figures, "visual": visual}


def check_nwb_nix(kept, card):
    """16c: NWB and NIX on 8a's tracked .slp: the pose arrays go back to the
    same points exactly, the nixtrack arrays assemble, and the writers,
    the reader and ``sleap-convert --format nwb`` raise the ImportError that
    names pynwb/nixio where it is absent (or write and read back)."""
    import contextlib
    import io

    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.io import convert
    from sleap_tpu_torch.io.formats import ndx_pose, nix

    labels = Labels.load_file(kept["slp"])  # its video, the clip beside it
    video = labels.videos[0]
    arr, untracked = ndx_pose.labels_to_pose_arrays(labels, video)
    lfs = ndx_pose.tracks_numpy_to_labeled_frames(arr[..., :2], arr[..., 2], not untracked, video,
                                                  labels.skeleton)
    n_rows = int((~np.isnan(arr[..., :2]).all(axis=(-1, -2))).sum())
    exact = all(np.array_equal(arr[lf.frame_idx, int(inst.track.name[5:]), :, :2], inst.numpy(),
                               equal_nan=True)
                for lf in lfs for inst in lf.instances)
    n_insts = sum(len(lf.instances) for lf in lfs)
    check(not untracked and exact and n_insts == n_rows > 0,
          f"16c: the pose arrays give the points back exactly ({n_insts} instances of {n_rows} rows)")
    data = nix.assemble_nix_arrays(labels, video)
    check(data["n_instances"] == len(labels.predicted_instances), "16c: the nixtrack arrays assemble")
    outcomes = {}
    with tempfile.TemporaryDirectory() as root:
        calls = {
            "export_nwb": ("pynwb", lambda: labels.export_nwb(os.path.join(root, "a.nwb"))),
            "export_nix": ("nixio", lambda: labels.export_nix(os.path.join(root, "a.nix"))),
            "load_nwb": ("pynwb", lambda: Labels.load_nwb(os.path.join(root, "a.nwb"))),
            "sleap-convert --format nwb": ("pynwb", lambda: convert.main(
                [kept["slp"], "--format", "nwb"])),
        }
        for name, (package, call) in calls.items():
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    result = call()
                outcomes[name] = "wrote" if result is None else f"read {len(result)} frames"
            except ImportError as e:
                check(package in str(e), f"16c {name}: the ImportError names {package}: {e}")
                outcomes[name] = f"ImportError: {e}"
    for name, outcome in outcomes.items():
        log(f"16c {name}: {outcome}")
    return {"instances": n_insts, "nix_instances": data["n_instances"], "calls": outcomes}


def finish_host_modules_child(proc, card):
    """16d and 16e from the child: the "raw" and "hog" features of 8a's
    frames and the image-feature suggestions (or their ImportError naming
    scikit-learn); the prefs round trip, HDF5 helpers and ZMQ pair."""
    stdout, stderr = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"16d/16e: exit {proc.returncode}: {stderr[-2000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    for feature, size in (("raw", 1024), ("hog", 144)):
        f = out[feature]
        check(f["shape"] == [CLI_FRAMES, size] and f["finite"] and f["varies"],
              f"16d: {feature} features of 8a's frames {f}")
    sug = out["suggestions"]
    if sug["ran"]:
        check(0 < len(sug["frames"]) <= 8 and all(0 <= i < CLI_FRAMES for i, _ in sug["frames"]),
              f"16d: image-feature suggestions {sug}")
        log(f"16d image-feature suggestions ran (scikit-learn present): {sug['frames']}")
    else:
        check("scikit-learn" in sug["error"], f"16d: the ImportError names scikit-learn: {sug}")
        log(f"16d image-feature suggestions: scikit-learn absent here: {sug['error']}")
    log(f"16d raw features {out['raw']['s']:.3f} s, hog {out['hog']['s']:.3f} s for {CLI_FRAMES} "
        f"frames of {IMG}^2 ({card})")
    p = out["prefs"]
    if p["saved"]:
        check(p["read_back"] == [9, "alphabet", 4.0], f"16e: preferences read back {p}")
    else:
        check("PyYAML" in p["error"], f"16e: saving preferences names PyYAML: {p}")
    check(out["hdf5"]["equal"] and out["hdf5"]["keys"] == ["root/a", "root/b/c", "root/b/d"],
          f"16e: util's HDF5 helpers {out['hdf5']}")
    z = out["zmq"]
    if z["present"]:
        check(z["handshake"] and z["received"] == [{"event": "epoch_end"}], f"16e: the ZMQ pair {z}")
    else:
        check("pyzmq" in (z["error"] or ""), f"16e: the ImportError names pyzmq {z}")
    log(f"16e prefs {'saved and read back' if p['saved'] else 'refused to save: ' + p['error']}; "
        f"HDF5 helpers {out['hdf5']['keys']}; ZMQ "
        f"{'handshake ' + str(z['handshake']) if z['present'] else 'absent: ' + z['error']}")
    return out


def check_host_modules(td_cpu, wrappers, launches, kept, card):
    """Phase 16: the child of 16d and 16e first, then 16a-16c here."""
    here = os.path.dirname(os.path.abspath(__file__))
    child = start_host_modules_child(here, kept["clip"])
    try:
        res = {"16a diagnostic": check_diagnostic(here, card),
               "16b from_trained_models": check_from_trained_models(td_cpu, wrappers, launches, card),
               "16c nwb nix": check_nwb_nix(kept, card)}
    except BaseException:
        child.kill()
        child.communicate()
        raise
    res["16d 16e child"] = finish_host_modules_child(child, card)
    return res


# --------------------------------------------------------------------------- #
# Phase 17: the pipeline blocks, the training pipelines, sleap-train --zmq
# with the trainer's visualizations, MoveNet, and the host helpers
# --------------------------------------------------------------------------- #

# 17b: phase 7's recipe (uniform noise frames at IMG^2, 3 animals of 13
# nodes at uniform places 100 px inside), 24 frames so that each builder
# gives two batches of TRAIN_BATCH, each animal on its own track (the
# multiclass builders' classes). Card vs CPU: crops sample the frames at
# float32 positions near 1024 px, whose ulp is 6.1e-5 px, and neighbouring
# noise pixels differ by up to 1 after scaling, so one ulp of position moves
# a crop's value by up to 6.1e-5 (a trial read 2.9e-5); maps move less.
PIPE_FRAMES, PIPE_BATCHES, PIPE_CPU_TOL = 24, 2, 1e-4
# 17c: phase 9's centroid profile cut to ZMQ_EPOCHS epochs of ZMQ_BATCHES
# batches; the learning rate asked for over ZMQ after the first epoch.
ZMQ_EPOCHS, ZMQ_BATCHES, ZMQ_LR = 4, 5, 1e-5
# 17d: MOVENET_FRAMES of phase 4's gray frames and as many seeded RGB
# 640 x 480 frames.
MOVENET_FRAMES = 8


def block_chain(td, frames, device, batch):
    """Phase 4's top-down pair as pipeline blocks on ``device``: the frames
    scaled by the centroid model's input scale, the centroid
    ``ModelPredictor``, ``LocalPeakFinder`` (kernel 2; MAX_INSTANCES a
    frame), unit crops of the frames at the centroids
    (``crop_bboxes_unit``, kernel 3), the instance ``ModelPredictor``,
    ``GlobalPeakFinder`` (kernel 1), and, per instance,
    ``PredictedCenterInstanceNormalizer``. Returns the per-instance
    examples."""
    from sleap_tpu_torch.data import dataset_ops as ops
    from sleap_tpu_torch.data import inference as blocks
    from sleap_tpu_torch.data.normalization import ensure_float
    from sleap_tpu_torch.data.resizing import resize_image
    from sleap_tpu_torch.ops.peak_finding import crop_bboxes_unit

    cm, im = td.centroid_model, td.confmap_model
    crop = int(im.crop_size)

    def scaled(ex):
        x = ensure_float(torch.from_numpy(ex["image"]).to(device))
        return {**ex, "centroid_image": resize_image(x, cm.input_scale).cpu().numpy()}

    def crops(ex):
        cents = ex["predicted_centroids"]
        top_left = (cents - (crop - 1) / 2.0).astype(np.float32)
        inds = ex["predicted_centroid_sample_inds"]
        c = crop_bboxes_unit(torch.from_numpy(ex["image"]).to(device), torch.from_numpy(top_left).to(device),
                             torch.from_numpy(inds.astype(np.int64)).to(device), (crop, crop))
        return {"instance_image": torch.trunc(c).to(torch.uint8).cpu().numpy(), "centroid": cents,
                "centroid_confidence": ex["predicted_centroid_confidences"],
                "bbox": np.concatenate([top_left[:, ::-1], top_left[:, ::-1] + crop - 1], axis=1),
                "scale": np.ones((len(cents), 2), np.float32), "frame_ind": ex["frame_ind"][inds]}

    stream = ({"image": frames[i:i + batch], "frame_ind": np.arange(i, min(i + batch, len(frames)))}
              for i in range(0, len(frames), batch))
    for block in (
            ops.LambdaMap(scaled),
            blocks.ModelPredictor(model=cm, model_input_keys="centroid_image",
                                  model_output_keys="centroid_confidence_maps", device=device),
            blocks.LocalPeakFinder(confmaps_stride=int(cm.output_stride / cm.input_scale),
                                   peak_threshold=td.peak_threshold, max_peaks=MAX_INSTANCES,
                                   keep_confmaps=False, device=device),
            ops.LambdaMap(crops),
            blocks.ModelPredictor(model=im, model_input_keys="instance_image", device=device),
            blocks.GlobalPeakFinder(confmaps_stride=im.output_stride, peak_threshold=td.peak_threshold,
                                    keep_confmaps=False, device=device),
            ops.Unbatcher(),
            blocks.PredictedCenterInstanceNormalizer()):
        stream = block.transform_dataset(stream)
    return list(stream)


def chain_arrays(examples):
    keys = ("frame_ind", "predicted_centroid", "predicted_centroid_confidence", "predicted_instance",
            "predicted_instance_confidences")
    return {k: np.stack([np.asarray(ex[k]) for ex in examples]) for k in keys}


def check_block_chain(td, td_cpu, frames, wrappers, launches, card):
    """17a: the chain on the card over phase 4's frames in batches of BATCH
    (one warm-up batch, then the timed ones, each launching kernels 1, 2
    and 3 once), the card against the CPU on the first 4 frames (phase 4's
    PATH_XY_TOL and PATH_VAL_TOL), and ``MockGlobalPeakFinder`` on phase 7's
    ground truth."""
    from sleap_tpu_torch.data.inference import MockGlobalPeakFinder

    block_chain(td, frames[:BATCH], td.device, BATCH)  # warm-up
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = block_chain(td, frames[BATCH:], td.device, BATCH)  # the results are on the host
    seconds = time.perf_counter() - t0
    n_batches = -(-(len(frames) - BATCH) // BATCH)
    counts = {k: w.launches for k, w in wrappers.items()}
    for kernel, n in counts.items():
        check(n == n_batches, f"17a: {kernel} launched {n} times for {n_batches} batches")
        launches[kernel]["pipeline blocks (17a)"] = n
    res = chain_arrays(out)
    check(len(out) >= n_batches and np.isfinite(res["predicted_instance"]).any(),
          f"17a: {len(out)} instances, finite points")
    check(np.isfinite(res["predicted_instance_confidences"]).all(), "17a: finite values")
    g = chain_arrays(block_chain(td, frames[:4], td.device, 4))
    c = chain_arrays(block_chain(td_cpu, frames[:4], td_cpu.device, 4))
    check(np.array_equal(g["frame_ind"], c["frame_ind"]), "17a: card vs CPU, the same instances")
    d = {k: float(np.nanmax(np.abs(g[k] - c[k]))) for k in g if k != "frame_ind"}
    check(all(np.array_equal(np.isnan(g[k]), np.isnan(c[k])) for k in g), "17a: card vs CPU NaNs")
    check(d["predicted_centroid"] <= PATH_XY_TOL and d["predicted_instance"] <= PATH_XY_TOL,
          f"17a: card vs CPU points {d}")
    check(d["predicted_centroid_confidence"] <= PATH_VAL_TOL
          and d["predicted_instance_confidences"] <= PATH_VAL_TOL, f"17a: card vs CPU values {d}")

    _, points = phase7_recipe(4)
    mocked = 0
    for i, pts in enumerate(points):
        for a in range(len(pts)):
            centroid = pts[a, 0]  # its anchor: nearer to its own nodes than to any other's
            bbox = np.array([centroid[1] - 80, centroid[0] - 80, centroid[1] + 79, centroid[0] + 79])
            (ex,) = MockGlobalPeakFinder(keep_confmaps=False).transform_dataset(
                [{"instances": pts, "centroid": centroid, "bbox": bbox, "scale": np.ones(2)}])
            want = (pts[a] - bbox[[1, 0]]).astype(np.float32)
            check(np.array_equal(ex["predicted_center_instance_points"], want), "17a: mock peaks exact")
            mocked += 1
    ms = 1000 * seconds / n_batches
    log(f"17a blocks: {len(out)} instances in {n_batches} batches of {BATCH} {IMG}^2 frames, "
        f"{ms:.1f} ms a batch; launches {counts}; card vs CPU {d}; mock exact on {mocked} "
        f"instances ({card})")
    return {"ms_a_batch": ms, "instances": len(out), "launches": counts, "card_vs_cpu": d}


def pipeline_builders(device):
    """The six builders at phase 7's widths and strides, batch
    TRAIN_BATCH, augmentation off (the default), on ``device``."""
    from sleap_tpu_torch import config as c
    from sleap_tpu_torch.data import pipelines as P

    def data(crop=None):
        d = c.DataConfig(preprocessing=c.PreprocessingConfig(pad_to_stride=16))
        d.instance_cropping.crop_size = crop
        return d

    opt = c.OptimizationConfig()
    opt.batch_size = TRAIN_BATCH
    cm = dict(output_stride=4, sigma=2.5)
    kw = dict(optimization_config=opt, device=device)
    return {
        "single_instance": P.SingleInstanceConfmapsPipeline(
            data_config=data(), single_instance_confmap_head=c.SingleInstanceConfmapsHeadConfig(**cm), **kw),
        "centroid": P.CentroidConfmapsPipeline(
            data_config=data(), centroid_confmap_head=c.CentroidsHeadConfig(**cm), **kw),
        "centered_instance": P.TopdownConfmapsPipeline(
            data_config=data(CROP), instance_confmap_head=c.CenteredInstanceConfmapsHeadConfig(**cm), **kw),
        "multi_instance": P.BottomUpPipeline(
            data_config=data(), confmaps_head=c.MultiInstanceConfmapsHeadConfig(**cm),
            pafs_head=c.PartAffinityFieldsHeadConfig(output_stride=8, sigma=5.0), **kw),
        "multi_class_bottomup": P.BottomUpMultiClassPipeline(
            data_config=data(), confmaps_head=c.MultiInstanceConfmapsHeadConfig(**cm),
            class_maps_head=c.ClassMapsHeadConfig(output_stride=4, sigma=5.0), **kw),
        "multi_class_topdown": P.TopDownMultiClassPipeline(
            data_config=data(CROP), instance_confmap_head=c.CenteredInstanceConfmapsHeadConfig(**cm),
            class_vectors_head=c.ClassVectorsHeadConfig(num_fc_layers=1), **kw),
    }


def check_training_pipelines(device, card):
    """17b: each builder's ``make_training_pipeline`` on the card, its first
    PIPE_BATCHES batches: equal to the trainer's own ``make_batch`` and
    ``build_gt_fn`` on the same examples (the pipeline's order and
    padding), exactly; the first batch within PIPE_CPU_TOL of the same
    pipeline on the CPU."""
    labels = labels_of(*phase7_recipe(PIPE_FRAMES), tracked=True)
    card_builders, cpu_builders = pipeline_builders(device), pipeline_builders("cpu")
    res = {}
    for head, builder in card_builders.items():
        pipe = builder.make_training_pipeline(labels)
        trainer = pipe.example_maker.__self__
        check(trainer.device == device, f"17b {head}: the trainer is on the card")
        gt_fn = trainer.build_gt_fn()
        order = np.random.default_rng(pipe.seed).permutation(len(pipe.examples))
        batches, t0 = [], time.perf_counter()
        for batch, n_valid in pipe:
            batches.append((batch, n_valid))
            if len(batches) == PIPE_BATCHES:
                break
        ms = 1000 * (time.perf_counter() - t0) / PIPE_BATCHES  # the batches are on the host
        for k, (batch, n_valid) in enumerate(batches):
            idx = order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH]
            check(n_valid == len(idx), f"17b {head}: batch {k} holds {n_valid} examples, want {len(idx)}")
            while len(idx) < TRAIN_BATCH:  # the pipeline pads by repeating examples
                idx = np.concatenate([idx, idx])[:TRAIN_BATCH]
            ref = trainer.make_batch([pipe.examples[i] for i in idx], None)
            with torch.no_grad():
                imgs, gt = gt_fn(trainer.to_device(ref), torch.Generator(device=device).manual_seed(0))
            check(np.array_equal(batch["image"], imgs.cpu().numpy()), f"17b {head}: images equal the trainer's")
            check(sorted(batch) == sorted(["image", "instances", *gt]), f"17b {head}: keys {sorted(batch)}")
            for key, value in gt.items():
                check(np.array_equal(batch[key], value.cpu().numpy()), f"17b {head}: {key} equals the trainer's")
        cpu_batch, _ = next(iter(cpu_builders[head].make_training_pipeline(labels)))
        diffs = {k: float(np.abs(cpu_batch[k] - batches[0][0][k]).max()) for k in cpu_batch if k != "instances"}
        diff = max(diffs.values())
        check(diff <= PIPE_CPU_TOL, f"17b {head}: card vs CPU {diffs}")
        shapes = {k: list(v.shape) for k, v in batches[0][0].items()}
        res[head] = {"ms_a_batch": ms, "card_vs_cpu": diffs, "shapes": shapes}
        log(f"17b {head}: {ms:.1f} ms a batch of {TRAIN_BATCH} ({card}); card vs CPU {diffs}; {shapes}")
    return res


def zmq_monitor(publish_port, controller_port, events, sent):
    """17c's GUI stand-in, in a thread: a SUB on the trainer's progress and
    a PUB on its controller. After the first ``epoch_end`` it sends
    ``set_lr`` ZMQ_LR, after the second ``stop``, once each (the trainer
    takes one command a batch, so a repeated one would queue). ``events``
    gets every message, ``sent`` the epoch after whose end each command
    went."""
    import zmq

    ctx = zmq.Context()
    sub, pub = ctx.socket(zmq.SUB), ctx.socket(zmq.PUB)
    sub.setsockopt_string(zmq.SUBSCRIBE, "")
    sub.setsockopt(zmq.RECONNECT_IVL, 10)
    sub.connect(f"tcp://127.0.0.1:{publish_port}")
    pub.bind(f"tcp://127.0.0.1:{controller_port}")
    commands = [{"command": "set_lr", "lr": ZMQ_LR}, {"command": "stop"}]
    deadline = time.time() + 600
    try:
        while time.time() < deadline:
            if not sub.poll(10, zmq.POLLIN):
                continue
            msg = json.loads(sub.recv_string())
            events.append(msg)
            if msg["what"] == "train_end":
                break
            if msg["what"] == "epoch_end" and commands:
                command = commands.pop(0)
                pub.send_string(json.dumps(command))
                sent[command["command"]] = msg["epoch"]
    finally:
        sub.close(linger=0)
        pub.close(linger=0)
        ctx.term()


def check_zmq_train(device, card):
    """17c: ``cli.train.main --zmq`` of phase 9's centroid profile on the
    card (its project), a monitor thread holding the other ends; the event
    order, the learning rate (from the epoch after the request) and the
    stop in ``training_log.csv``, the folder loading with ``load_model``,
    and the visualizations."""
    import importlib.util
    import socket
    import threading

    import sleap_tpu_torch
    from sleap_tpu_torch.cli import train as cli_train
    from sleap_tpu_torch.training.trainer import Trainer

    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    log(f"17c matplotlib on the card: {has_mpl}; pyzmq: {importlib.util.find_spec('zmq') is not None}")
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    root = tempfile.mkdtemp(prefix="chip_smoke_17c_")
    try:
        project = write_cli_project(root)
        profile, cfg = cut_profile(TRAIN_CLI_PROFILES[0][1], root)
        cfg["optimization"].update(epochs=ZMQ_EPOCHS, batches_per_epoch=ZMQ_BATCHES)
        cfg["outputs"].update(save_visualizations=True, keep_viz_images=True)
        with open(profile, "w") as f:
            json.dump(cfg, f)
        events, sent = [], {}
        monitor = threading.Thread(target=zmq_monitor, args=(ports[1], ports[0], events, sent), daemon=True)
        monitor.start()
        setup_zmq = Trainer._setup_zmq

        def joined(self):  # the monitor's SUB joins before the first event, as a GUI's does
            setup_zmq(self)
            time.sleep(0.5)

        Trainer._setup_zmq = joined
        t0 = time.perf_counter()
        try:
            cli_train.main([profile, project, "--run_name", "zmq", "--zmq", "--controller_port", str(ports[0]),
                            "--publish_port", str(ports[1]), *(["--cpu"] if device.type == "cpu" else [])])
        finally:
            Trainer._setup_zmq = setup_zmq
        seconds = time.perf_counter() - t0
        monitor.join(timeout=60)
        check(not monitor.is_alive(), "17c: the monitor saw train_end")
        kinds = [m["what"] for m in events]
        folder = os.path.join(root, "zmq")
        with open(os.path.join(folder, "training_log.csv")) as f:
            rows = list(csv.DictReader(f))
        want = []
        for e, row in enumerate(rows):
            n = sum(1 for m in events if m["what"] == "batch_end" and m["epoch"] == e)
            want += ["epoch_begin"] + ["batch_end"] * n + ["epoch_end"]
            check([m["batch"] for m in events if m["what"] == "batch_end" and m["epoch"] == e] == list(range(n))
                  and 1 <= n <= ZMQ_BATCHES, f"17c: epoch {e}'s batches")
        check(kinds == want + ["train_end"], f"17c: events in order {kinds}")
        check(sent.get("set_lr") == 0 and sent.get("stop") == 1, f"17c: commands sent {sent}")
        lrs = [float(r["lr"]) for r in rows]
        check(all(lr == ZMQ_LR for lr in lrs[1:]) and lrs[0] != ZMQ_LR, f"17c: set_lr in the log {lrs}")
        check(2 <= len(rows) < ZMQ_EPOCHS, f"17c: stopped early ({len(rows)} epochs)")
        pred = sleap_tpu_torch.load_model(folder, device=device)
        check(pred.centroid_model is not None, "17c: the folder loads")
        viz = os.path.join(folder, "viz")
        pngs = sorted(os.listdir(viz)) if os.path.isdir(viz) else []
        if has_mpl:
            check(pngs == [f"epoch_{e:03d}.png" for e in range(len(rows))]
                  and all(os.path.getsize(os.path.join(viz, p)) > 0 for p in pngs), f"17c: visualizations {pngs}")
        else:
            check(pngs == [], f"17c: no visualizations without matplotlib {pngs}")
        log(f"17c sleap-train --zmq: {len(rows)} epochs in {seconds:.1f} s, {len(events)} events, lr {lrs}, "
            f"visualizations {pngs} ({card})")
        return {"seconds": seconds, "epochs": len(rows), "events": len(events), "lr": lrs,
                "matplotlib": has_mpl, "visualizations": pngs}
    finally:
        shutil.rmtree(root, ignore_errors=True)


class MoveNetStandIn:
    """MoveNet's contract computed on ``device``: int32 (1, S, S, 3) in,
    (1, 1, 17, 3) [y, x, score] out; each keypoint the first argmax of a
    seeded 17-channel integer 5 x 5 convolution (stride 4) of the image, its
    score the sum there mod 100 over 100. Integer sums below 2^24 make the
    card and the CPU agree exactly."""

    def __init__(self, device, seed=0):
        gen = torch.Generator().manual_seed(seed)
        self.weight = torch.randint(-2, 3, (17, 3, 5, 5), generator=gen).float().to(device)
        self.device = device

    def __call__(self, images):
        size = images.shape[1]
        x = torch.from_numpy(images).to(self.device).permute(0, 3, 1, 2).float()
        y = torch.round(F.conv2d(x, self.weight, stride=4))[0].flatten(1).long()  # (17, h*w)
        w, n = (size - 5) // 4 + 1, y.shape[1]
        idx = (y * n + (n - 1 - torch.arange(n, device=self.device))).argmax(dim=1)
        val = y.gather(1, idx[:, None])[:, 0]
        idx, val = idx.cpu().numpy(), val.cpu().numpy()
        out = np.stack([(4 * (idx // w) + 2) / size, (4 * (idx % w) + 2) / size, (val % 100) / 100.0], axis=-1)
        return out.astype(np.float32).reshape(1, 1, 17, 3)


def check_movenet(frames, device, card):
    """17d: ``MoveNetPredictor`` of both sizes with the stand-in on the card
    and on the CPU, on MOVENET_FRAMES of phase 4's gray frames and as many
    RGB 640 x 480 ones: the same points and scores exactly; the offline
    error of ``load_model("movenet-thunder")``."""
    import importlib.util

    import sleap_tpu_torch
    from sleap_tpu_torch.inference.movenet import MoveNetPredictor

    rgb = np.random.default_rng(17).integers(0, 255, (MOVENET_FRAMES, 480, 640, 3), np.uint8)
    res = {}
    for name in ("lightning", "thunder"):
        for what, data in (("gray", frames[:MOVENET_FRAMES]), ("rgb", rgb)):
            out = {}
            for where in ("card", "cpu"):
                dev = device if where == "card" else torch.device("cpu")
                pred = MoveNetPredictor.from_trained_models(name, model_path=MoveNetStandIn(dev), device=dev)
                check(pred.device == dev, "17d: the predictor's device")
                t0 = time.perf_counter()
                labels = pred.predict(data)
                out[where] = (np.stack([lf.instances[0].numpy() for lf in labels]),
                              np.stack([lf.instances[0].scores for lf in labels]), time.perf_counter() - t0)
            same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(out["card"][:2], out["cpu"][:2]))
            check(same, f"17d {name} {what}: card vs CPU points")
            check(np.isfinite(out["card"][0]).any() and np.isnan(out["card"][0]).any(),
                  f"17d {name} {what}: points and thresholded NaNs")
            res[f"{name} {what}"] = {"ms_a_frame": 1000 * out["card"][2] / len(data),
                                     "finite_points": int(np.isfinite(out["card"][0][..., 0]).sum())}
    try:
        sleap_tpu_torch.load_model("movenet-thunder")
        check(False, "17d: load_model('movenet-thunder') without a model must raise")
    except NotImplementedError as e:
        check("offline" in str(e) and "tfhub.dev/google/movenet/singlepose/thunder" in str(e),
              f"17d: the offline error {e}")
    res["tensorflow"] = importlib.util.find_spec("tensorflow") is not None
    log(f"17d MoveNet: {res} ({card})")
    return res


def check_host_helpers(kept, device, card):
    """17e: ``match_points`` on card tensors against the CPU; a
    Shuffler -> Batcher -> Prefetcher -> Unbatcher chain over 8a's
    ``.slp``; ``generate_skeleton_preview_image`` where matplotlib imports."""
    from sleap_tpu_torch import nn_viz
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.data import dataset_ops as ops
    from sleap_tpu_torch.data.providers import LabelsReader
    from sleap_tpu_torch.ops.utils import match_points

    rng = np.random.default_rng(18)
    for n, m in ((40, 35), (12, 30), (7, 7)):
        p1, p2 = rng.uniform(0, IMG, (n, 2)), rng.uniform(0, IMG, (m, 2))
        got = match_points(torch.from_numpy(p1).to(device), torch.from_numpy(p2).to(device))
        want = match_points(p1, p2)
        check(all(np.array_equal(a, b) and a.dtype == np.int32 for a, b in zip(got, want)),
              f"17e: match_points {n} x {m} card vs CPU")
    labels = Labels.load_file(kept["slp"], device=device)
    direct = {int(ex["frame_ind"]): ex["image"] for ex in LabelsReader(labels=labels)}
    chain = ops.Unbatcher().transform_dataset(ops.Prefetcher(buffer_size=2).transform_dataset(
        ops.Batcher(batch_size=5).transform_dataset(ops.Shuffler(seed=0, buffer_size=8).transform_dataset(
            LabelsReader(labels=labels)))))
    back = {int(ex["frame_ind"]): ex["image"] for ex in chain}
    check(sorted(back) == sorted(direct) and all(np.array_equal(back[k], direct[k]) for k in direct),
          "17e: the dataset_ops chain gives every example back")
    try:
        png = nn_viz.generate_skeleton_preview_image(labels[0].instances[0])
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "17e: a PNG preview")
        preview = len(png)
    except ImportError as e:
        check("matplotlib" in str(e), f"17e: the ImportError names matplotlib {e}")
        preview = None
    log(f"17e match_points card = CPU; {len(back)} examples through the chain; preview PNG bytes {preview} "
        f"({card})")
    return {"examples": len(back), "preview_png_bytes": preview}


def check_slice_modules(td, td_cpu, frames, wrappers, launches, kept, card):
    """Phase 17: 17a-17e, on the card of ``td``."""
    device = td.device
    return {"17a blocks": check_block_chain(td, td_cpu, frames, wrappers, launches, card),
            "17b training pipelines": check_training_pipelines(device, card),
            "17c sleap-train --zmq": check_zmq_train(device, card),
            "17d movenet": check_movenet(frames, device, card),
            "17e host helpers": check_host_helpers(kept, device, card)}


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


# --------------------------------------------------------------------------- #
# Phase 21: users' AVI videos (the demuxer, Motion-JPEG through J5, raw frames)
# --------------------------------------------------------------------------- #


AVI_DIR = ("tests", "torch_data", "avi")
AVI_CLIP = "gray_1024.avi"  # 21b's clip: 8 gray 1024^2 frames of 8a's kind
AVI_REFUSED = {"opencv_mjpeg_37x29.avi": "odd height"}  # swscale's scaler, not modelled
AVI_PLAIN_BLOCKS = 5000  # 21a: J5 vs its plain version on every MJPEG frame up to this many blocks
AVI_BATCH = 4

_CLI_MAIN_AVI = """
import time
t_start = time.perf_counter()
import json, sys, torch
from sleap_tpu_torch.cli import track
from sleap_tpu_torch.io import mjpeg
from sleap_tpu_torch.ops import cuda_crops, cuda_peaks
wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
            "global_peaks": cuda_peaks.global_peaks_cuda, "jpeg_idct_ffmpeg": mjpeg.idct_cuda}
for w in wrappers.values():
    w.launches = 0
torch.backends.cudnn.deterministic = True
t0 = time.perf_counter()
track.main(sys.argv[1:])
torch.cuda.synchronize()
print(json.dumps({"cli_s": time.perf_counter() - t0, "import_s": t0 - t_start,
                  "launches": {k: w.launches for k, w in wrappers.items()}}))
"""


def avi_path(name) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *AVI_DIR, name)


def avi_manifest() -> dict:
    with open(avi_path("manifest.json")) as fh:
        return json.load(fh)["files"]


def without_dht(data: bytes) -> bytes:
    """A JPEG with its DHT segments cut out, as Motion-JPEG frames come."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + data[pos:])


def check_avi_fixtures(card):
    """21a: every committed AVI through ``MediaVideo``'s card route to the
    manifest's cv2 frames (BGR and the blue channel), in order and at
    random, with cv2's frame count and fps; the odd-height colour one
    refused by name; J5 bitwise against its plain version on the card on
    every MJPEG frame of up to AVI_PLAIN_BLOCKS blocks; DHT-less copies of
    the baseline JPEG stills through ``jpeg.imdecode`` on the card to cv2's
    recorded frames. Returns the figures it prints."""
    from sleap_tpu_torch.io import avi, jpeg, mjpeg
    from sleap_tpu_torch.io.video import MediaVideo

    manifest, dev = avi_manifest(), torch.device("cuda", 0)
    figures = {"files": 0, "frames_read": 0, "j5_frames_vs_plain": 0}
    j5_err = 0
    t0 = time.perf_counter()
    for name, want in sorted(manifest.items()):
        path = avi_path(name)
        colour, gray = MediaVideo(path, grayscale=False, bgr=False), MediaVideo(path, grayscale=True)
        if name in AVI_REFUSED:
            try:
                colour.get_frame(0)
            except NotImplementedError as e:
                check(AVI_REFUSED[name] in str(e) and "ROADMAP.md item 3g" in str(e),
                      f"21a: {name} refused naming it: {e}")
                continue
            check(False, f"21a: {name} must be refused")
        check((colour.frames, colour.fps) == (want["frames"], want["fps"]),
              f"21a: {name} has cv2's count and fps {(colour.frames, colour.fps)}")
        n = want["readable"]
        order = list(range(n)) + [int(i) for i in np.random.default_rng(0).permutation(n)]
        for i in order:
            check(sha256(colour.get_frame(i)) == want["bgr"][i]
                  and sha256(gray.get_frame(i)) == want["gray"][i],
                  f"21a: frame {i} of {name} is cv2's")
        figures["frames_read"] += 2 * len(order)
        figures["files"] += 1
        demux = colour._reader.demux
        if demux.codec != "mjpeg":
            continue
        with open(path, "rb") as fh:
            for i in range(n):
                data = demux.read(fh, i)
                frame = mjpeg.parse_frame(data, abs(demux.height))
                if frame.header.blocks > AVI_PLAIN_BLOCKS:
                    continue
                coefs = jpeg.coefficients_host(data, frame.header).to(dev)
                quant = torch.from_numpy(frame.header.quant.astype(np.int32)).to(dev)
                card_out = mjpeg.idct_cuda(coefs, quant, frame.header)
                plain = mjpeg.idct_plain(coefs, quant, jpeg.block_components(frame.header).to(dev))
                j5_err = max(j5_err, max_abs(card_out, plain))
                check(torch.equal(card_out, plain), f"21a: J5 equals its plain version on {name} {i}")
                figures["j5_frames_vs_plain"] += 1
    figures["fixtures_s"] = time.perf_counter() - t0
    record = jpeg_record()["stills"]
    for name in sorted(n for n in record if "refused" not in record[n] and "progressive" not in n
                       and "optimized" not in n and not n.startswith("pil_")):
        cut = without_dht(read_still(name + ".jpg", JPEG_DIR))
        check(sha256(jpeg.imdecode(cut, "cuda")) == record[name]["sha256"],
              f"21a: {name} without DHT decodes on the card to cv2's frame")
        figures["dht_less_stills"] = figures.get("dht_less_stills", 0) + 1
    figures["j5_max_abs_err"] = j5_err
    log(f"21a {figures['files']} AVI fixtures on the card: {figures['frames_read']} reads equal to "
        f"cv2's (FFmpeg) frames in order and at random, counts and fps equal, "
        f"{sorted(AVI_REFUSED)} refused; J5 equals its plain version on "
        f"{figures['j5_frames_vs_plain']} frames; {figures['dht_less_stills']} DHT-less stills "
        f"equal cv2's; {figures['fixtures_s']:.2f} s ({card})")
    return figures, j5_err


def mjpeg_stages(data):
    """ms a Motion-JPEG frame by stage on the card (host entropy decoding,
    copy in, J5, conversion, copy out, and the whole route), J5 checked
    against its plain version; returns (split, frame, J5's row numbers)."""
    from sleap_tpu_torch.io import jpeg, mjpeg, yuv

    dev = torch.device("cuda", 0)
    frame = mjpeg.parse_frame(data)
    header = frame.header
    staging = jpeg._staging(header.blocks)
    coefs = jpeg.coefficients_host(data, header, staging)
    c = coefs.to(dev)
    q = torch.from_numpy(header.quant.astype(np.int32)).to(dev)
    comp = jpeg.block_components(header).to(dev)
    samples = mjpeg.idct_cuda(c, q, header)
    check(torch.equal(samples, mjpeg.idct_plain(c, q, comp)), "J5 equals its plain version")
    planes = [p[:k.height, :k.width] for p, k in zip(jpeg.planes_of(samples, header),
                                                    header.components)]

    def convert():
        if frame.sampling == "gray":
            return planes[0][..., None].expand(*planes[0].shape, 3).contiguous()
        return yuv.to_bgr(*planes, sampling=frame.sampling, full_range=frame.full_range)

    out = convert()
    split = {
        "entropy_ms": median_ms(lambda: jpeg.coefficients_host(data, header, staging), 5),
        "copy_in_ms": events_ms(lambda: staging.to(dev, non_blocking=True)),
        "j5_ms": events_ms(lambda: mjpeg.idct_cuda(c, q, header)),
        "convert_ms": events_ms(convert),
        "copy_out_ms": median_ms(lambda: out.cpu(), 5),
        "frame_ms": median_ms(lambda: mjpeg.decode(data, "cuda").cpu(), 5),
    }
    j5_dev = device_ms(lambda: mjpeg.idct_cuda(c, q, header), ["jpeg_idct_ffmpeg_kernel"])
    j5_plain = time_ms(lambda: mjpeg.idct_plain(c, q, comp), iters=10, warmup=2)
    # Bound: the coefficients and tables read once, the samples written
    # once; about 600 integer operations a block (two passes of eight
    # 1-D transforms) at the float32 rate outside the tensor cores.
    j5_bytes, j5_ops = nbytes(c, q, samples), 600 * header.blocks
    numbers = {"ms": split["j5_ms"], "plain_ms": j5_plain, "device_ms": j5_dev,
               "bytes_ms": j5_bytes / HBM_BYTES_PER_S * 1e3,
               "ops_ms": j5_ops / F32_OPS_PER_S * 1e3}
    split.update(j5_device_ms=j5_dev, j5_plain_ms=j5_plain,
                 j5_bound_ms=max(numbers["bytes_ms"], numbers["ops_ms"]))
    return split, frame, numbers


def time_avi_stages(card):
    """21a: ms a 1024^2 frame by stage (host entropy decoding, copy in, J5,
    conversion, copy out) on the 21b clip's gray frame and on the 1024^2
    4:2:0 JPEG still taken as a Motion-JPEG frame; J5's device ms, plain ms
    and bound. Returns (figures, the J5 row's numbers)."""
    from sleap_tpu_torch.io import avi

    demux = avi.AviVideo.open(avi_path(AVI_CLIP))
    with open(demux.filename, "rb") as fh:
        frames = {"gray_1024": demux.read(fh, 0)}
    frames["c420_1024"] = read_still("c420_1024.jpg", JPEG_DIR)
    figures, row = {}, None
    for name, data in frames.items():
        split, frame, numbers = mjpeg_stages(data)
        header = frame.header
        figures[name] = {**split, "bytes": len(data), "blocks": header.blocks,
                         "sampling": frame.sampling}
        row = row or numbers  # the row is the gray clip's frame, 21b's
        log(f"21a Motion-JPEG {name} ({len(data)} bytes, {header.blocks} blocks, "
            f"{frame.sampling}), ms a frame: entropy (host C) {split['entropy_ms']:.3f}, copy in "
            f"{split['copy_in_ms']:.3f}, J5 {split['j5_ms']:.4f} (device {split['j5_device_ms']:.4f}, "
            f"plain {split['j5_plain_ms']:.3f}, bound {split['j5_bound_ms']:.4f}), conversion "
            f"{split['convert_ms']:.4f}, copy out {split['copy_out_ms']:.3f}; whole card route "
            f"{split['frame_ms']:.3f} ({card})")
    row["colour"] = figures["c420_1024"]
    return figures, row


def check_avi_cli(launches, card, fps_12b, fps_13c, keep):
    """21b: ``sleap-track clip.avi`` (the committed 1024^2 gray Motion-JPEG
    AVI) with phase 8b's trained top-down pair in a fresh process on the
    card, against ``load_model`` in this process on the frames the card
    decodes (held to cv2's hashes): predictions within CLI_TOL, kernels 2,
    3 and 1 once a batch, J5 once a decoded frame. Both sides run cuDNN's
    deterministic algorithms: at its defaults they differ by a float32 ulp
    of the points (6.1e-5 px), too near CLI_TOL (as in 20c). Returns the
    figures it prints; ``keep["avi_labels"]`` gets the CLI's predictions,
    phase 25b's reference."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    centroid, instance = (os.path.join(runs, f) for f in CLI_TRAINED[:2])
    clip, want_frames = avi_path(AVI_CLIP), avi_manifest()[AVI_CLIP]
    video = Video.from_filename(clip)
    decoded = video[:]
    n = len(decoded)
    check(video.shape == (n, IMG, IMG, 1) and n == want_frames["readable"]
          and all(sha256(f) == h for f, h in zip(decoded, want_frames["gray"])),
          f"21b: the card decodes {AVI_CLIP} ({video.shape}) to cv2's gray frames")
    pred = sleap_tpu_torch.load_model([centroid, instance], batch_size=AVI_BATCH,
                                      peak_threshold=0.05, max_instances=MAX_INSTANCES)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = pred.predict(decoded)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "clip.predictions.slp")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", _CLI_MAIN_AVI, clip, "-m", centroid, "-m", instance,
             "--peak_threshold", "0.05", "--batch_size", str(AVI_BATCH), "--max_instances",
             str(MAX_INSTANCES), "--verbosity", "none", "-o", out],
            cwd=here, capture_output=True, text=True, timeout=300)
        process_s = time.perf_counter() - t0
        check(run.returncode == 0, f"21b: sleap-track clip.avi exit {run.returncode}: "
              f"{run.stderr[-2000:]}")
        result = json.loads(run.stdout.strip().splitlines()[-1])
        got = read_labels(out)
    keep["avi_labels"] = got
    n_batches = -(-n // AVI_BATCH)
    counts = result["launches"]
    for kernel in ("local_peaks", "crop_unit", "global_peaks"):
        check(counts[kernel] == n_batches,
              f"21b: {kernel} launched {counts[kernel]} times by the CLI, want one a batch")
        launches[kernel]["CLI clip.avi (21b)"] = counts[kernel]
    check(counts["jpeg_idct_ffmpeg"] >= n, f"21b: J5 launched {counts['jpeg_idct_ffmpeg']} times "
          f"for {n} frames")
    launches["jpeg_idct_ffmpeg"]["CLI clip.avi (21b)"] = counts["jpeg_idct_ffmpeg"]
    insts = [i for lf in got for i in lf.instances]
    check(len(got) == n and len(insts) >= n, f"21b: instances in every frame ({len(insts)})")
    d_xy, d_val = compare_predictions(got, want, CLI_TOL, CLI_TOL, "21b: CLI on clip.avi vs in-process")
    cli_fps = n / result["cli_s"]
    figures = {"frames": n, "cli_s": result["cli_s"], "cli_fps": cli_fps, "cli_fps_12b": fps_12b,
               "cli_fps_13c": fps_13c, "process_s": process_s, "launches": counts,
               "instances": len(insts), "max_abs_dxy": d_xy, "max_abs_dscore": d_val}
    log(f"21b sleap-track {AVI_CLIP} ({n} Motion-JPEG frames of {IMG}^2 gray) with the trained pair "
        f"in a fresh process: main {result['cli_s']:.3f} s = {cli_fps:.1f} FPS (12b clip.mp4: "
        f"{'not measured' if fps_12b is None else f'{fps_12b:.1f} FPS'}; 13c jpeg_pkg.slp: "
        f"{fps_13c:.1f} FPS), process {process_s:.1f} s; {len(insts)} instances, launches {counts}; "
        f"vs in-process max |dxy| {d_xy:.3g}, max |dscore| {d_val:.3g} ({card})")
    return figures


def check_avi_videos(launches, card, fps_12b, fps_13c, keep):
    """Phase 21: 21a and 21b, each part's seconds printed. Returns (figures,
    J5's (max |err|, row numbers)); ``keep`` gets 21b's predictions."""
    fixtures, j5_err = timed_phase("21a fixtures", check_avi_fixtures, card)
    stages, j5_row = timed_phase("21a stages", time_avi_stages, card)
    launches["jpeg_idct_ffmpeg"] = {}
    cli = timed_phase("21b", check_avi_cli, launches, card, fps_12b, fps_13c, keep)
    return {"fixtures": fixtures, "stages": stages, "cli": cli}, (j5_err, j5_row)


def avi_kernel_row(j5, launches):
    """The ``kernels`` line's row of J5, at the 21b clip's 1024^2 gray frame."""
    err, r = j5
    return {
        "name": "jpeg_idct_ffmpeg", "route": "cuda", "source": "sleap_tpu_torch/csrc/jpeg.cu",
        "replaces": "sleap_tpu/io/video.py:73",
        "replaces_note": "cv2.VideoCapture (FFmpeg's Motion-JPEG decoder) on the host in "
                         "MediaVideo; no TPU kernel",
        "device_function": "jpeg_idct_ffmpeg_kernel",
        "launches": sum(launches["jpeg_idct_ffmpeg"].values()),
        "launches_by_path": launches["jpeg_idct_ffmpeg"], "max_abs_err": err, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": None, "device_ms": r["device_ms"],
        "colour_420": {k: r["colour"][k] for k in ("j5_ms", "j5_device_ms", "j5_plain_ms",
                                                   "j5_bound_ms", "convert_ms")},
    }


# --------------------------------------------------------------------------- #
# Phase 22: every still cv2 reads (TIFF and JPEG layouts, J2's modes, J6)
# --------------------------------------------------------------------------- #

#: The four 1024^2 frames of animals (two blobs the trained top-down pair
#: finds): a 4:4:0 JPEG, a progressive JPEG cut short (J6), a JPEG-in-TIFF
#: of 16 strips and a CCITT Group 4 page.
ANIMAL_STILLS = (("jpeg", "animals_c440_1024.jpg"), ("jpeg", "animals_c420_1024_progressive_truncated.jpg"),
                 ("stills", "animals_jpeg_ycbcr22_1024.tif"), ("stills", "animals_ccitt_g4_1024.tif"))
def jpeg_streams(folder, data):
    """The headers of the JPEG streams a decode of a still runs through J1
    and J2: the file's own, or a JPEG-in-TIFF's strips or tiles each with
    its JPEGTables, in the colour space libtiff sets; none for another
    TIFF."""
    from sleap_tpu_torch.io import jpeg, tiff

    if folder == "jpeg":
        return [jpeg.parse(data)]
    lay = tiff._layout(*tiff.read_ifd(data))
    if lay["compression"] != 7:
        return []
    return [jpeg.parse(jpeg.with_tables(lay["tables"], data[o:o + c]), lay["jpeg_colorspace"])
            for o, c in zip(lay["offsets"], lay["counts"])]


#: The samplings J2 upsampled before this slice (4:4:4, 4:2:2, 4:2:0).
FIRST_UPSAMPLINGS = ((1, 1), (2, 1), (2, 2))


def check_slice_kernels(card):
    """22a: on each JPEG still that reaches what this slice added to the
    kernels (a colour space other than gray or YCbCr, an upsampling other
    than 4:4:4, 4:2:2 or 4:2:0, four components, or block smoothing), J6,
    J1 and J2 bitwise equal to ``smooth_plain``, ``idct_plain`` and
    ``color_plain`` on the same inputs; the host CCITT decoder equal to the
    plain one on every TIFF of compression 2-4. Which still that is comes
    from its parsed header. (13b and 19b hold every still's decode on the
    card's route to cv2's recorded frame.) Returns (figures, J6's max
    |err|)."""
    from sleap_tpu_torch.io import jpeg, tiff

    dev = torch.device("cuda", 0)
    checked = {"j6": [], "j1_j2": [], "ccitt": []}
    ccitt_strips, j6_err = 0, 0.0
    for name, want in sorted(jpeg_record()["stills"].items()):
        if "refused" in want:
            continue
        data = read_still(name + ".jpg", JPEG_DIR)
        header = jpeg.parse(data)
        new = (header.color not in ("gray", "ycc") or len(header.components) == 4 or header.smooth
               or any(jpeg.upsampling(header, c)[:2] not in FIRST_UPSAMPLINGS for c in header.components))
        if not new:
            continue
        coefs = jpeg.coefficients_host(data, header).to(dev)
        if header.smooth:
            smoothed = jpeg.smooth_cuda(coefs, header)
            plain = jpeg.smooth_plain(coefs.cpu(), header)
            j6_err = max(j6_err, max_abs(smoothed.cpu(), plain))
            check(torch.equal(smoothed.cpu(), plain), f"22a: J6 equals smooth_plain on {name}")
            checked["j6"].append(name)
            coefs = smoothed
        q = torch.from_numpy(header.quant.astype(np.int32)).to(dev)
        samples = jpeg.idct_cuda(coefs, q, header)
        out = jpeg.color_cuda(samples, header)
        check(torch.equal(samples.cpu(), jpeg.idct_plain(coefs.cpu(), q.cpu(), jpeg.block_components(header)))
              and torch.equal(out.cpu(), jpeg.color_plain(jpeg.planes_of(samples.cpu(), header), header)),
              f"22a: J1 and J2 ({header.color}) equal idct_plain and color_plain on {name}")
        checked["j1_j2"].append(name)
    for name, want in sorted(still_record("decoded.json")["stills"].items()):
        if "refused" in want or not name.endswith(".tif"):
            continue
        data = read_still(name)
        lay = tiff._layout(*tiff.read_ifd(data))
        if lay["compression"] in (2, 3, 4):
            check(np.array_equal(tiff.samples_of(data, lay, "cuda"), tiff.samples_of(data, lay, "cpu")),
                  f"22a: the host CCITT decoder gives the plain one's rows on {name}")
            checked["ccitt"].append(name)
            ccitt_strips += len(lay["offsets"])
    figures = {"j6_vs_plain": len(checked["j6"]), "j1_j2_vs_plain": len(checked["j1_j2"]),
               "ccitt_files_host_vs_plain": len(checked["ccitt"]), "ccitt_strips_host_vs_plain": ccitt_strips}
    log(f"22a J6 equals smooth_plain on {len(checked['j6'])} JPEGs, J1 and J2 equal idct_plain and "
        f"color_plain on {len(checked['j1_j2'])} (new colour spaces, samplings, CMYK, smoothing); host "
        f"CCITT equals the plain decoder on {len(checked['ccitt'])} TIFFs ({ccitt_strips} strips) ({card})")
    return figures, j6_err


def time_animal_stills(card):
    """22a: ms a 1024^2 frame of each of ANIMAL_STILLS on the card's route,
    with its host stage (entropy decoding, or CCITT) split out, and J6's
    numbers on the cut progressive one (the kernels line's row). Returns
    (figures, J6's row numbers)."""
    from sleap_tpu_torch.io import jpeg, stills, tiff

    dev = torch.device("cuda", 0)
    figures, j6_row = {}, None
    for folder, name in ANIMAL_STILLS:
        data = read_still(name, ("tests", "torch_data", folder))
        t = {"bytes": len(data), "frame_ms": median_ms(lambda: stills.imdecode(data, "cuda"), 5)}
        if folder == "jpeg":
            header = jpeg.parse(data)
            staging = jpeg._staging(header.blocks)
            t["host_entropy_ms"] = median_ms(lambda: jpeg.coefficients_host(data, header, staging), 5)
            coefs = jpeg.coefficients_host(data, header, staging).to(dev)
            q = torch.from_numpy(header.quant.astype(np.int32)).to(dev)
            if header.smooth:
                smoothed = jpeg.smooth_cuda(coefs, header)
                cpu_coefs = coefs.cpu()
                # Bound: each block's 64 coefficients read once and written
                # once; some 25 multiply-adds for each of up to ten estimates.
                j6_row = {"ms": events_ms(lambda: jpeg.smooth_cuda(coefs, header)),
                          "device_ms": device_ms(lambda: jpeg.smooth_cuda(coefs, header),
                                                 ["jpeg_smooth_kernel"]),
                          "plain_ms": median_ms(lambda: jpeg.smooth_plain(cpu_coefs, header), 3),
                          "bytes_ms": nbytes(coefs, smoothed) / HBM_BYTES_PER_S * 1e3,
                          "ops_ms": 500 * header.blocks / F32_OPS_PER_S * 1e3,
                          "blocks": header.blocks}
                t["j6_device_ms"] = j6_row["device_ms"]
                coefs = smoothed
            samples = jpeg.idct_cuda(coefs, q, header)
            t["j1_j2_device_ms"] = device_ms(lambda: jpeg.color_cuda(jpeg.idct_cuda(coefs, q, header), header),
                                             ["jpeg_idct_kernel", "jpeg_color_kernel"])
            del samples
        else:
            lay = tiff._layout(*tiff.read_ifd(data))
            chunks = [data[o:o + c] for o, c in zip(lay["offsets"], lay["counts"])]
            if lay["compression"] == 7:
                streams = [jpeg.with_tables(lay["tables"], c) for c in chunks]
                headers = jpeg_streams(folder, data)
                t["strips"] = len(chunks)
                t["host_entropy_ms"] = median_ms(
                    lambda: [jpeg.coefficients_host(x, h) for x, h in zip(streams, headers)], 5)
            else:
                t["host_ccitt_ms"] = median_ms(lambda: tiff.samples_of(data, lay, "cuda"), 5)
                t["plain_ccitt_ms"] = median_ms(lambda: tiff.samples_of(data, lay, "cpu"), 1)
        figures[name] = t
        log(f"22a {name} ({len(data)} bytes), ms a 1024^2 frame on the card's route: "
            + ", ".join(f"{k} {v:.4f}" for k, v in t.items() if k.endswith("_ms")) + f" ({card})")
    check(j6_row is not None, "22a: J6 timed on the cut progressive frame")
    log(f"22a J6 at 1024^2 ({j6_row['blocks']} blocks): {j6_row['ms']:.4f} ms a call, device "
        f"{j6_row['device_ms']:.4f}, plain {j6_row['plain_ms']:.2f}, bound {j6_row['bytes_ms']:.4f} ms "
        f"({card})")
    return figures, j6_row


def check_animal_stills_predict(launches, card):
    """22b: top-down ``predict`` with phase 4g's trained pair over a
    ``SingleImageVideo`` of the four 1024^2 frames of animals on the card
    (decoded by J6, J1, J2, host CCITT) against the same frames given as a
    ``NumpyVideo``: the same predictions exactly (cuDNN deterministic);
    kernels 2, 3 and 1 once a batch; J1 and J2 once a JPEG stream (each
    file's, each strip of the JPEG-in-TIFF), J6 once a smoothed one
    (counted into the kernels line). An equality check: one batch of four
    frames is no rate, and none is taken. Returns the figures it prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io import jpeg
    from sleap_tpu_torch.io.video import SingleImageVideo, Video
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    paths = [os.path.join(runs, f) for f in TRAINED[0][1]]
    files = [os.path.join(here, "tests", "torch_data", folder, name) for folder, name in ANIMAL_STILLS]
    streams = [h for folder, name in ANIMAL_STILLS
               for h in jpeg_streams(folder, read_still(name, ("tests", "torch_data", folder)))]
    expected = {"local_peaks": 1, "crop_unit": 1, "global_peaks": 1, "jpeg_idct": len(streams),
                "jpeg_color": len(streams), "jpeg_smooth": sum(h.smooth for h in streams)}
    pred = sleap_tpu_torch.load_model(paths, batch_size=len(files), peak_threshold=0.05)
    wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
                "global_peaks": cuda_peaks.global_peaks_cuda, "jpeg_idct": jpeg.idct_cuda,
                "jpeg_color": jpeg.color_cuda, "jpeg_smooth": jpeg.smooth_cuda}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pred.predict(np.zeros((len(files), 1024, 1024, 1), np.uint8), make_labels=False)  # warm-up
        video = Video(backend=SingleImageVideo(filenames=files, grayscale=True))
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        got = pred.predict(video)
        torch.cuda.synchronize()
        counts = {k: w.launches for k, w in wrappers.items()}
        frames = np.stack([video.get_frame(i) for i in range(len(files))])
        want = pred.predict(Video.from_numpy(frames))
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = deterministic
    check(torch.device(video.backend.device).type == "cuda", "22b: the stills decode on the card")
    for kernel, count in counts.items():
        check(count == expected[kernel], f"22b: {kernel} launched {count} times, want {expected[kernel]} "
                                         f"(one batch; {len(streams)} JPEG streams)")
        launches.setdefault(kernel, {})["SingleImageVideo 1024^2 stills (22b)"] = count
    compare_predictions(got, want, 0.0, 0.0, "22b: SingleImageVideo vs NumpyVideo")
    insts = [i for lf in got for i in lf.instances]
    check(len(got) == len(files) and all(len(lf.instances) for lf in got),
          "22b: animals found in every frame")
    figures = {"frames": len(files), "instances": len(insts), "launches": counts}
    log(f"22b top-down predict on a SingleImageVideo of {len(files)} 1024^2 stills (4:4:0 JPEG, cut "
        f"progressive JPEG, JPEG-in-TIFF, CCITT G4): {len(insts)} instances, the NumpyVideo run's "
        f"predictions exactly; launches {counts} as expected ({card})")
    return figures


def check_all_stills(launches, card):
    """Phase 22: 22a and 22b, each part's seconds printed. Returns (figures,
    J6's (max |err|, row numbers))."""
    kernels, j6_err = timed_phase("22a kernels", check_slice_kernels, card)
    timing, j6_row = timed_phase("22a timing", time_animal_stills, card)
    launches["jpeg_smooth"] = {}
    predict = timed_phase("22b", check_animal_stills_predict, launches, card)
    return {"kernels_vs_plain": kernels, "timing_1024": timing, "predict": predict}, (j6_err, j6_row)


def smooth_kernel_row(j6, launches):
    """The ``kernels`` line's row of J6, at the cut 1024^2 progressive frame."""
    err, r = j6
    return {
        "name": "jpeg_smooth", "route": "cuda", "source": "sleap_tpu_torch/csrc/jpeg.cu",
        "replaces": "sleap_tpu/io/video.py:477",
        "replaces_note": "cv2.imread (libjpeg-turbo's block smoothing) on the host in "
                         "SingleImageVideo.get_frame; no TPU kernel",
        "device_function": "jpeg_smooth_kernel",
        "launches": sum(launches["jpeg_smooth"].values()),
        "launches_by_path": launches["jpeg_smooth"], "max_abs_err": err, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": None, "device_ms": r["device_ms"],
    }


# --------------------------------------------------------------------------- #
# Phase 23: data-parallel inference and training
# --------------------------------------------------------------------------- #

PARALLEL_BATCH = BATCH  # 23a: each replica's batch (the global batch is twice it)
PARALLEL_TIMED_BATCHES = 3  # 23a: global batches timed after one warm-up batch
PARALLEL_BU_BATCH, PARALLEL_BU_IMG = 4, 512  # 23b: the cut size
SHARDED_XY_TOL = 1e-3  # tests/test_parallel.py's bound, sharded vs unsharded
DP_LOSS_RTOL = 1e-5
DP_PARAM_RTOL, DP_PARAM_ATOL = 2e-3, 2e-4  # tests/test_parallel.py's bound
DP_IMG_BN = 512  # 23c workload 2's frames
DP_WORKLOADS = {  # name: (steps, global batch)
    "centroid UNet": (3, 16),
    "ResNet-18 batch norm, OHKM": (2, 8),
}


def parallel_meshes():
    """The meshes of phase 23: the card named twice (two replicas or ranks
    on one card, gloo), and the first two cards (NCCL) where there are two."""
    from sleap_tpu_torch.parallel.mesh import make_mesh

    meshes = {"one card twice": make_mesh(devices=["cuda:0", "cuda:0"])}
    if torch.cuda.device_count() >= 2:
        meshes["two cards"] = make_mesh(2)
    return meshes


def sharded_path(name, pred, frames, wrappers, launches, mesh, batch):
    """``pred`` at ``batch`` a replica sharded over ``mesh`` against the
    unsharded predictor at the global batch, on the same frames after one
    warm-up batch each: (sharded outputs, unsharded outputs, sharded FPS,
    unsharded FPS). Every kernel of ``wrappers`` launches once a replica a
    global batch; the counts are zeroed just before the sharded run and
    read just after it."""
    from sleap_tpu_torch.parallel.distributed import make_sharded_predictor

    n_data = mesh.shape["data"]
    sharded = make_sharded_predictor(dataclasses.replace(pred, batch_size=batch), mesh)
    whole = dataclasses.replace(pred, batch_size=batch * n_data)
    check(sharded.batch_size == whole.batch_size, f"{name}: the global batch")
    gb = whole.batch_size
    outs, rates = [], []
    for which, p in (("sharded", sharded), ("unsharded", whole)):
        p.predict(frames[:gb], make_labels=False)  # warm-up
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        outs.append(p.predict(frames[gb:], make_labels=False))
        torch.cuda.synchronize()
        rates.append((len(frames) - gb) / (time.perf_counter() - t0))
        if which == "sharded":
            counts = {k: w.launches for k, w in wrappers.items()}
    n_batches = -(-(len(frames) - gb) // gb)
    for kernel, count in counts.items():
        launches[kernel][name] = count
        check(count == n_batches * n_data,
              f"{name}: {kernel} launched {count} times, want once a replica a batch "
              f"({n_batches} x {n_data})")
    log(f"{name}: {len(frames) - gb} frames, global batch {gb} ({n_data} x {batch}); sharded "
        f"{rates[0]:.1f} FPS, unsharded {rates[1]:.1f} FPS; launches {counts}")
    return outs[0], outs[1], rates[0], rates[1]


def same_points(name, got, want, keys):
    """Points within SHARDED_XY_TOL with the same NaN pattern; the largest
    difference of each key."""
    worst = {}
    for k in keys:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        check(g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w)), f"{name}: {k} NaNs")
        worst[k] = float(np.abs(np.nan_to_num(g) - np.nan_to_num(w)).max()) if g.size else 0.0
        check(worst[k] <= SHARDED_XY_TOL, f"{name}: {k} differ by {worst[k]:.3g} px")
    return worst


def check_sharded_inference(td, bu, frames, td_wrappers, hwcs_wrappers, launches, meshes):
    """23a: phase 4's float32 top-down pair, 1024^2, 16 frames a replica;
    23b: phase 4b's bf16 bottom-up at 512^2, 4 frames a replica."""
    out = {}
    n_td = (1 + PARALLEL_TIMED_BATCHES) * 2 * PARALLEL_BATCH
    small = synthetic_frames(6 * 2 * PARALLEL_BU_BATCH, seed=7, size=PARALLEL_BU_IMG)
    for mesh_name, mesh in meshes.items():
        name = f"sharded top-down (23a, {mesh_name})"
        got, want, fps, fps_whole = sharded_path(name, td, frames[:n_td], td_wrappers, launches,
                                                 mesh, PARALLEL_BATCH)
        n = n_td - 2 * PARALLEL_BATCH
        g, w = merged(got, n), merged(want, n)
        check(np.array_equal(g["centroid_mask"], w["centroid_mask"]) and g["centroid_mask"].any(),
              f"{name}: centroid masks")
        diff = same_points(name, g, w, ("centroids", "instance_peaks"))
        check(np.abs(np.nan_to_num(g["instance_peak_vals"] - w["instance_peak_vals"])).max()
              <= PATH_VAL_TOL, f"{name}: peak values")
        out[f"23a {mesh_name}"] = {"replicas": [str(d) for d in mesh.data_devices],
                                   "fps": fps, "unsharded_fps": fps_whole, "max_dxy": diff}

        name = f"sharded bottom-up bf16 (23b, {mesh_name})"
        got, want, fps, fps_whole = sharded_path(name, bu, small, hwcs_wrappers, launches, mesh,
                                                 PARALLEL_BU_BATCH)
        g, w = frames_instances(got), frames_instances(want)
        check([len(x[0]) for x in g] == [len(x[0]) for x in w] and sum(len(x[0]) for x in g) > 0,
              f"{name}: instance counts")
        diff = same_points(name, {"points": np.concatenate([x[0] for x in g])},
                           {"points": np.concatenate([x[0] for x in w])}, ("points",))
        out[f"23b {mesh_name}"] = {"replicas": [str(d) for d in mesh.data_devices],
                                   "fps": fps, "unsharded_fps": fps_whole, "max_dxy": diff}
    return out


def dp_config(name, root):
    """23c's workloads: phase 7's centroid UNet at full width, and a
    pretrained-encoder ResNet-18 (random weights; batch norm throughout, the
    decoder's too) single-instance model with hard keypoint mining; one
    train step and one validation step an epoch, a run folder under
    ``root``."""
    from sleap_tpu_torch import config as c

    steps, batch = DP_WORKLOADS[name]
    if name.startswith("centroid"):
        cfg = train_config("centroid", batch=batch)
    else:
        cfg = c.TrainingJobConfig()
        cfg.model.backbone.pretrained_encoder = c.PretrainedEncoderConfig(
            encoder="resnet18", pretrained=False, output_stride=4)
        cfg.model.heads.single_instance = c.SingleInstanceConfmapsHeadConfig(output_stride=4,
                                                                            sigma=2.5)
        cfg.optimization.batch_size = batch
        cfg.optimization.hard_keypoint_mining.online_mining = True
    cfg.optimization.epochs = steps
    cfg.optimization.batches_per_epoch = 1
    cfg.optimization.val_batches_per_epoch = 1
    cfg.outputs.save_outputs = True
    cfg.outputs.runs_folder = root
    cfg.outputs.run_name = "run"
    return cfg


def dp_labels(name):
    if name.startswith("centroid"):
        return labels_of(*phase7_recipe(8, seed=5))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 255, (8, DP_IMG_BN, DP_IMG_BN, 1), np.uint8)
    return labels_of(frames, rng.uniform(60, DP_IMG_BN - 60, (8, 1, N_NODES, 2)))


def count_saved_activations(trainer):
    """Count the bytes autograd saves for the backward of ``trainer``'s
    first train step (distinct storages: activations, weights and halos),
    which a band divides; peak memory also holds cuDNN's workspace, which
    cuDNN sizes to the free memory. Returns a dict that holds ``gib`` once
    that step has run. (The trainer no longer pickles.)"""
    out = {}
    compute_loss = trainer.compute_loss

    def counted(batch, generator):
        if out or not torch.is_grad_enabled():
            return compute_loss(batch, generator)
        storages = {}

        def pack(t):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = compute_loss(batch, generator)
        out["gib"] = sum(storages.values()) / 2**30
        return loss

    trainer.compute_loss = counted
    return out


def dp_train(name, root, devices, float64=False, saved=None, **placement):
    """``Trainer.train()`` of workload ``name`` on the card (``devices``
    None) or data-parallel over ``devices`` (or as ``placement`` says:
    ``n_devices`` and ``spatial_sharding`` in a group already open); with
    ``float64``, the module set up is swapped for its float64 twin first, as
    phase 11a's float64 step does; with ``saved`` (a dict), the first
    step's saved activations are counted into it; (trainer, seconds)."""
    from sleap_tpu_torch.training.trainer import Trainer

    labels = dp_labels(name)
    trainer = Trainer.from_config(dp_config(name, root), training_labels=labels,
                                  validation_labels=labels, devices=devices, **placement)
    if saved is not None:
        saved.update(count=count_saved_activations(trainer))
    trainer.group_timeout = 300.0
    t0 = time.perf_counter()
    if float64:
        trainer.setup()
        module = trainer.model.make_module(trainer._input_channels, compute_dtype=torch.float64)
        module.load_state_dict(trainer.module.state_dict())
        trainer.module = module.to(trainer.device)
    trainer.train()
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


def dp_runs():
    """23c's runs: (workload, float64). The batch-norm workload runs in
    float64 too: in float32 the single-process and two-rank runs agree
    bitwise in the first step's loss and drift after it by rounding that
    Adam's normalisation and the deep batch-norm net amplify (the CPU:
    2e-6 relative after one update, 7e-5 after two; float64: equal)."""
    return [(name, False) for name in DP_WORKLOADS] + [(n, True) for n in DP_WORKLOADS
                                                        if "batch norm" in n]


def held_to_one_process(what, name, float64, trainer_loss, got, single, folder, later_rtol=None):
    """A sharded run of workload ``name`` against the one-process run
    ``single`` (its losses, weights): per-step losses within DP_LOSS_RTOL
    (in float32 on the batch-norm net, the first step's; in float32 with
    ``later_rtol``, the first step's, and every step's within
    ``later_rtol``), weights and running statistics within
    DP_PARAM_RTOL/ATOL, one run folder (rank 0's) with its
    ``best_model.pt``; (relative losses, margin, statistics)."""
    want_loss, want = single["loss"], single["state"]
    rel = [abs(a - b) / abs(b) for a, b in zip(trainer_loss, want_loss)]
    check(len(trainer_loss) == len(want_loss) == DP_WORKLOADS[name][0], f"{what}: steps")
    float32_first = not float64 and ("batch norm" in name or later_rtol is not None)
    held = rel[:1] if float32_first else rel
    check(max(held) <= DP_LOSS_RTOL, f"{what}: losses {trainer_loss} vs {want_loss}")
    if later_rtol is not None and not float64:
        check(max(rel) <= later_rtol, f"{what}: losses {trainer_loss} vs {want_loss} "
              f"beyond {later_rtol} after the first step")
    margin = max(float(((got[k].to(w.device) - w).abs() - (DP_PARAM_ATOL + DP_PARAM_RTOL * w.abs()))
                       .max()) for k, w in want.items())
    check(margin <= 0, f"{what}: weights beyond rtol {DP_PARAM_RTOL}, atol {DP_PARAM_ATOL}")
    n_stats = sum(k.endswith(("running_mean", "running_var")) for k in got)
    check((n_stats > 0) == ("batch norm" in name), f"{what}: running statistics")
    check(os.listdir(folder) == ["run"], f"{what}: one run folder")
    check(os.path.exists(os.path.join(folder, "run", "best_model.pt")), f"{what}: best_model.pt")
    return rel, margin, n_stats


def check_data_parallel_training(meshes, card, singles, groups):
    """23c: each run of ``dp_runs`` trained by one process on the card and
    by two ranks over each mesh, held by ``held_to_one_process``; the
    one-process runs' losses, weights (on the CPU), seconds and peak memory
    are kept in ``singles`` for phase 24. The first run's ranks are
    ``Trainer.train()``'s own (the caller and a spawned rank 1); the later
    runs go to ``groups`` (``start_spatial_ranks``'), each mesh's pair
    opening its group once, as ``torchrun`` ranks do, so their start
    (~17 s a spawned rank) is paid once."""
    from sleap_tpu_torch.parallel.distributed import backend_for

    out, runs = {}, dp_runs()
    for k, (name, float64) in enumerate(runs):
        run = f"{name}{', float64' if float64 else ''}"
        with tempfile.TemporaryDirectory() as root:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            saved = {}
            single, single_s = dp_train(name, os.path.join(root, "single"), None, float64, saved)
            singles[run] = {"loss": [r["loss"] for r in single.log_rows],
                            "state": {k: v.cpu() for k, v in single.module.state_dict().items()},
                            "train_s": single_s, "epoch_s": single.epoch_seconds,
                            "peak_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
                            "saved_gib": saved["count"]["gib"]}
            del single
            if k:
                continue
            for mesh_name, mesh in meshes.items():
                folder = os.path.join(root, mesh_name.replace(" ", "_"))
                backend = backend_for(mesh.data_devices)
                log(f"23c {run}: 2 ranks on {[str(d) for d in mesh.data_devices]} over {backend}, "
                    f"rank 1 spawned by train()")
                dp, dp_s = dp_train(name, folder, mesh.data_devices, float64)
                loss = [r["loss"] for r in dp.log_rows]
                out[f"{run}, {mesh_name}"] = held_data_parallel(
                    f"23c {run} ({mesh_name})", run, backend, loss, dp.module.state_dict(), folder,
                    dp_s, dp.epoch_seconds, singles, card)
                del dp
            torch.cuda.empty_cache()
    for group in groups:
        results = group_results(group, "23c", "dp")
        for run, row in results[0].items():
            out[f"{run}, {group['mesh']}"] = held_data_parallel(
                f"23c {run} ({group['mesh']}, started ranks)", run, group["backend"], row["loss"],
                row["state"], row["folder"], row["train_s"], row["epoch_s"], singles, card)
    return out


def held_data_parallel(what, run, backend, loss, state, folder, seconds, epoch_s, singles, card):
    """A two-rank run of 23c held to its one-process run; its figures."""
    float64 = run.endswith(", float64")
    name = run[:-len(", float64")] if float64 else run
    rel, margin, n_stats = held_to_one_process(what, name, float64, loss, state, singles[run], folder)
    single = singles[run]
    log(f"{what}: losses {loss}, relative to one process {rel}; train() {seconds:.1f} s (one "
        f"process {single['train_s']:.1f} s); epochs {[round(s, 3) for s in epoch_s]} s vs "
        f"{[round(s, 3) for s in single['epoch_s']]} s ({card})")
    return {"backend": backend, "steps": len(loss), "global_batch": DP_WORKLOADS[name][1],
            "loss": loss, "loss_rel": rel, "running_stats": n_stats, "param_margin": margin,
            "train_s": seconds, "epoch_s": epoch_s, "single_train_s": single["train_s"],
            "single_epoch_s": single["epoch_s"]}


def check_parallel(td, bu, frames, td_wrappers, hwcs_wrappers, launches, card, singles,
                   before_training):
    """Phase 23: sharded inference (23a, 23b) and data-parallel training
    (23c) on each mesh of ``parallel_meshes``; ``before_training`` is called
    between them (phase 24's ranks start up then) and returns the groups of
    ranks that train 23c's later runs."""
    meshes = parallel_meshes()
    for mesh_name, mesh in meshes.items():
        log(f"phase 23 mesh {mesh_name}: {mesh.shape}, data devices "
            f"{[str(d) for d in mesh.data_devices]}")
    inference = check_sharded_inference(td, bu, frames, td_wrappers, hwcs_wrappers, launches,
                                        meshes)
    groups = before_training()
    return {"inference": inference,
            "training": check_data_parallel_training(meshes, card, singles, groups)}


# --------------------------------------------------------------------------- #
# Phase 24: spatially sharded training
# --------------------------------------------------------------------------- #

SPATIAL_TIMEOUT = 600.0  # s: a rank's wait for its go, and each collective
# A float32 band run against one process: the first step's loss within
# DP_LOSS_RTOL, every step's within SPATIAL_LATER_RTOL. cuDNN picks other
# algorithms for a band than for a frame, and some are not deterministic, so
# float32 losses after the first Adam update differ by rounding that Adam
# amplifies (centroid UNet's third step: 3.0e-6 to 1.3e-5 relative in four
# runs on one card; float64 runs are held at every step to DP_LOSS_RTOL).
# parallel_scaling.py --spatial holds its epochs to the same pair of bounds.
SPATIAL_LATER_RTOL = 1e-4


def spatial_meshes():
    """Phase 24's ``(1, 2)`` meshes: (name, card of each rank, backend): the
    card named twice (gloo), and the first two cards (NCCL) where there are
    two."""
    meshes = [("one card twice", (0, 0), "gloo")]
    if torch.cuda.device_count() >= 2:
        meshes.append(("two cards", (0, 1), "nccl"))
    return meshes


def spatial_rank(rank, cards, backend, tmp, go, staged):
    """A rank of phases 23c and 24, as ``torchrun`` runs one: a process of a
    group that ``Trainer.train()`` joins. It starts up (CUDA context,
    imports) while 23c's first runs go, waits for ``go["dp"]``, opens its
    group and trains 23c's later runs with ``n_devices=2``, sets
    ``staged``, waits for ``go["spatial"]`` and trains each run of
    ``dp_runs`` with ``n_devices=2, spatial_sharding=2``. Each stage's
    seconds and peak memory, and rank 0's losses, weights and run folder,
    are pickled into ``tmp`` (a traceback on failure, and exit code 1)."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    failed = False
    try:
        os.environ["LOCAL_RANK"] = str(cards[rank])
        torch.cuda.set_device(cards[rank])
        torch.zeros(1, device="cuda")
        importlib.import_module("torch._dynamo")  # the optimizer's first step imports it
        importlib.import_module("sleap_tpu_torch.training.trainer")
        for stage, spatial, runs in (("dp", 1, dp_runs()[1:]), ("spatial", 2, dp_runs())):
            out = {}
            try:
                if not go[stage].wait(SPATIAL_TIMEOUT):
                    raise RuntimeError(f"ranks: no go for {stage}")
                if not dist.is_initialized():
                    dist.init_process_group(backend, timeout=timedelta(seconds=SPATIAL_TIMEOUT),
                                            init_method="file://" + os.path.join(tmp, "rendezvous"),
                                            world_size=2, rank=rank)
                for name, float64 in runs:
                    run = f"{name}{', float64' if float64 else ''}"
                    folder = os.path.join(tmp, f"{stage}{len(out)}")
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    saved = {}
                    trainer, seconds = dp_train(name, folder, None, float64, saved, n_devices=2,
                                                spatial_sharding=spatial)
                    row = {"train_s": seconds, "epoch_s": trainer.epoch_seconds,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "saved_gib": saved["count"]["gib"]}
                    if rank == 0:
                        row.update(loss=[r["loss"] for r in trainer.log_rows], folder=folder,
                                   state={k: v.cpu() for k, v in trainer.module.state_dict().items()})
                    out[run] = row
                    del trainer
                    torch.cuda.empty_cache()
                result = (True, out)
            except BaseException:
                result, failed = (False, traceback.format_exc()), True
            with open(os.path.join(tmp, f"rank{rank}_{stage}.pkl"), "wb") as f:
                pickle.dump(result, f)
            if stage == "dp":
                staged.set()
            if failed:
                break
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failed:
        sys.exit(1)


def start_spatial_ranks():
    """The two ranks of each mesh of ``spatial_meshes`` (23c's later runs,
    then phase 24's), spawned to start up and wait: each group a dict of
    its mesh name, backend, folder, go events, staged events and
    processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    groups = []
    for mesh_name, cards, backend in spatial_meshes():
        tmp = tempfile.mkdtemp(prefix="chip_smoke_24_")
        go = {"dp": ctx.Event(), "spatial": ctx.Event()}
        staged = [ctx.Event() for _ in range(2)]
        procs = [ctx.Process(target=spatial_rank, args=(r, cards, backend, tmp, go, staged[r]),
                             daemon=True) for r in range(2)]
        for p in procs:
            p.start()
        groups.append({"mesh": mesh_name, "backend": backend, "tmp": tmp, "go": go,
                       "staged": staged, "procs": procs})
    return groups


def group_results(group, phase, stage):
    """Start a group's ``stage``, wait for both ranks and read their pickled
    results (rank 0's first)."""
    import pickle

    group["go"][stage].set()
    for r, p in enumerate(group["procs"]):
        if stage == "dp":
            group["staged"][r].wait(SPATIAL_TIMEOUT)
        else:
            p.join(SPATIAL_TIMEOUT)
    results = []
    for r, p in enumerate(group["procs"]):
        path = os.path.join(group["tmp"], f"rank{r}_{stage}.pkl")
        check(os.path.exists(path), f"{phase} ({group['mesh']}): rank {r} ended with exit code "
              f"{p.exitcode} and no result")
        with open(path, "rb") as f:
            ok, value = pickle.load(f)
        check(ok, f"{phase} ({group['mesh']}): rank {r} failed:\n{value}")
        results.append(value)
    return results


def stop_ranks(groups):
    """Release every group's ranks (each go set), join them, kill any that
    hang, and remove their folders."""
    for group in groups:
        for event in group["go"].values():
            event.set()
        for p in group["procs"]:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(group["tmp"], ignore_errors=True)


def check_spatial_training(groups, singles, card):
    """Phase 24: each run of ``dp_runs`` trained by two ranks on a ``(1, 2)``
    mesh, each rank a horizontal band of every frame, over each mesh of
    ``spatial_meshes``, held to 23c's one-process run by
    ``held_to_one_process``; ``train()`` seconds and each rank's peak
    memory beside one process's."""
    out = {}
    try:
        for group in groups:
            mesh_name, backend = group["mesh"], group["backend"]
            results = group_results(group, "24", "spatial")
            for run, row in results[0].items():
                float64 = run.endswith(", float64")
                name = run[:-len(", float64")] if float64 else run
                what = f"24 {run} ({mesh_name})"
                rel, margin, n_stats = held_to_one_process(what, name, float64, row["loss"],
                                                           row["state"], singles[run], row["folder"],
                                                           later_rtol=SPATIAL_LATER_RTOL)
                single = singles[run]
                peaks = [results[r][run]["peak_gib"] for r in range(2)]
                saved = [results[r][run]["saved_gib"] for r in range(2)]
                out[f"{run}, {mesh_name}"] = {
                    "backend": backend, "mesh": {"data": 1, "spatial": 2},
                    "steps": len(row["loss"]), "global_batch": DP_WORKLOADS[name][1],
                    "loss": row["loss"], "loss_rel": rel, "running_stats": n_stats,
                    "param_margin": margin, "train_s": [results[r][run]["train_s"] for r in range(2)],
                    "epoch_s": row["epoch_s"], "peak_gib": peaks, "saved_gib": saved,
                    "single_train_s": single["train_s"], "single_epoch_s": single["epoch_s"],
                    "single_peak_gib": single["peak_gib"], "single_saved_gib": single["saved_gib"]}
                log(f"{what}: losses {row['loss']}, relative to one process {rel}; train() "
                    f"{row['train_s']:.1f} s (one process {single['train_s']:.1f} s); epochs "
                    f"{[round(s, 3) for s in row['epoch_s']]} s vs "
                    f"{[round(s, 3) for s in single['epoch_s']]} s; peak memory by rank "
                    f"{[round(g, 3) for g in peaks]} GiB vs one process "
                    f"{single['peak_gib']:.3f} GiB; saved for backward by rank "
                    f"{[round(g, 3) for g in saved]} GiB vs {single['saved_gib']:.3f} GiB ({card})")
                check(max(saved) < single["saved_gib"],
                      f"{what}: a band saves less for the backward than the whole frame")
    finally:
        stop_ranks(groups)
    return out


# --------------------------------------------------------------------------- #
# Phase 25: users' QuickTime and Matroska videos (edit lists, Motion-JPEG
# through J5, H.264 in Matroska to NVDEC)
# --------------------------------------------------------------------------- #

CONTAINER_DIR = ("tests", "torch_data", "containers")
#: 25b's clips: 21b's 8 JPEG payloads in QuickTime and Matroska.
CONTAINER_CLIPS = ("gray_1024.mov", "gray_1024.mkv")


def container_path(name) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *CONTAINER_DIR, name)


def container_manifest() -> dict:
    with open(container_path("manifest.json")) as fh:
        return json.load(fh)["files"]


def check_container_fixtures(card, mode):
    """25a: every committed QuickTime/ISO-BMFF and Matroska fixture through
    ``MediaVideo``'s card route (colour BGR and gray) to the manifest's cv2
    frames, in order and at random, with cv2's frame count and fps; the
    route picked by content (an AVI named .mkv, Matroska named .mov); J5
    bitwise against its plain version on every Motion-JPEG frame of up to
    AVI_PLAIN_BLOCKS blocks. The H.264 fixtures (Matroska, an edit list
    trimming an .mp4) meet phase 12's refusal where NVDEC is refused
    (:func:`check_refused`), else hold cv2's frames too. Returns (figures,
    J5's max |err|)."""
    from sleap_tpu_torch.io import avi, jpeg, mjpeg, mkv, mp4
    from sleap_tpu_torch.io.video import MediaVideo, container_of

    manifest, dev = container_manifest(), torch.device("cuda", 0)
    figures = {"files": 0, "frames_read": 0, "j5_frames_vs_plain": 0, "h264": {}}
    j5_err = 0
    for name, want in sorted(manifest.items()):
        path = container_path(name)
        with open(path, "rb") as fh:
            kind = container_of(fh.read(12))
        n = want["readable"]
        order = list(range(n)) + [int(i) for i in np.random.default_rng(0).permutation(n)]
        if name.startswith("h264"):
            demux = (mkv.MkvVideo if kind == "matroska" else mp4.Mp4Video).open(path)
            check((demux.frames, demux.fps, demux.readable) == (want["frames"], want["fps"], n),
                  f"25a: {name} has cv2's count, fps and readable frames")
            if mode == "refused":
                check_refused(path, demux, f"25a {name}")
                figures["h264"][name] = "refused: cuvidCreateDecoder, CUDA_ERROR_OUT_OF_MEMORY"
                continue
            video = MediaVideo(path, grayscale=False, bgr=False)
            for i in order:
                check(sha256(video.get_frame(i)) == want["bgr"][i], f"25a: frame {i} of {name} is cv2's")
            figures["h264"][name] = f"decoded: {len(order)} reads equal to cv2's"
            figures["frames_read"] += len(order)
            continue
        colour, gray = MediaVideo(path, grayscale=False, bgr=False), MediaVideo(path, grayscale=True)
        check((colour.frames, colour.fps) == (want["frames"], want["fps"]),
              f"25a: {name} has cv2's count and fps {(colour.frames, colour.fps)}")
        for i in order:
            check(sha256(colour.get_frame(i)) == want["bgr"][i]
                  and sha256(gray.get_frame(i)) == want["gray"][i], f"25a: frame {i} of {name} is cv2's")
        reader = colour._reader
        check(isinstance(reader, avi.AviReader if kind == "avi" else mjpeg.MotionJpegReader),
              f"25a: {name} ({kind}) read by {type(reader).__name__}")
        figures["frames_read"] += 2 * len(order)
        figures["files"] += 1
        demux = reader.demux
        height = abs(demux.height)  # the container's: strf, the sample entry or PixelHeight
        with open(path, "rb") as fh:
            for i in range(n):
                data = demux.read(fh, i)
                frame = mjpeg.parse_frame(data, height)
                if frame.header.blocks > AVI_PLAIN_BLOCKS:
                    continue
                coefs = jpeg.coefficients_host(data, frame.header).to(dev)
                quant = torch.from_numpy(frame.header.quant.astype(np.int32)).to(dev)
                card_out = mjpeg.idct_cuda(coefs, quant, frame.header)
                plain = mjpeg.idct_plain(coefs, quant, jpeg.block_components(frame.header).to(dev))
                j5_err = max(j5_err, max_abs(card_out, plain))
                check(torch.equal(card_out, plain), f"25a: J5 equals its plain version on {name} {i}")
                figures["j5_frames_vs_plain"] += 1
        colour.reset()
        gray.reset()
    check("cv2" not in sys.modules, "25a: the card route imported cv2")
    figures["j5_max_abs_err"] = j5_err
    log(f"25a {figures['files']} QuickTime/ISO-BMFF and Matroska Motion-JPEG fixtures on the card: "
        f"{figures['frames_read']} reads equal to cv2's (FFmpeg) frames in order and at random, "
        f"counts and fps equal; J5 equals its plain version on {figures['j5_frames_vs_plain']} "
        f"frames; H.264: {figures['h264']} ({card})")
    return figures, j5_err


def check_container_cli(launches, card, avi_labels, fps_21b):
    """25b: ``sleap-track`` (in this process) on ``gray_1024.mov`` and
    ``gray_1024.mkv`` with phase 8b's trained top-down pair, cuDNN's
    algorithms deterministic: the card decodes cv2's frames, and the
    predictions equal 21b's on ``gray_1024.avi`` (the same JPEG bytes)
    exactly; kernels 2, 3 and 1 once a batch, J5 once a decoded frame (and
    the test frame); FPS beside 21b's; ms a 1024^2 frame by stage (demux,
    entropy decoding, copy in, J5, conversion, copy out), the AVI's demux
    beside. Returns the figures it prints."""
    from sleap_tpu_torch.io import avi, mjpeg
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    centroid, instance = (os.path.join(runs, f) for f in CLI_TRAINED[:2])
    wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
                "global_peaks": cuda_peaks.global_peaks_cuda, "jpeg_idct_ffmpeg": mjpeg.idct_cuda}
    manifest = container_manifest()
    figures = {}
    demuxers = {AVI_CLIP: avi.AviVideo.open(avi_path(AVI_CLIP))}
    for name in CONTAINER_CLIPS:
        path, want = container_path(name), manifest[name]
        video = Video.from_filename(path)
        decoded = video[:]
        n = len(decoded)
        check(video.shape == (n, IMG, IMG, 1) and n == want["readable"]
              and all(sha256(f) == h for f, h in zip(decoded, want["gray"])),
              f"25b: the card decodes {name} ({video.shape}) to cv2's gray frames")
        demuxers[name] = video.backend._reader.demux
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        with tempfile.TemporaryDirectory() as root:
            out = os.path.join(root, name + ".predictions.slp")
            try:
                seconds, counts = cli_run(
                    [path, "-m", centroid, "-m", instance, "--peak_threshold", "0.05", "--batch_size",
                     str(AVI_BATCH), "--max_instances", str(MAX_INSTANCES), "--verbosity", "none",
                     "-o", out], wrappers)
            finally:
                torch.backends.cudnn.deterministic = deterministic
            got = read_labels(out)
        n_batches = -(-n // AVI_BATCH)
        for kernel in ("local_peaks", "crop_unit", "global_peaks"):
            check(counts[kernel] == n_batches,
                  f"25b: {kernel} launched {counts[kernel]} times on {name}, want one a batch")
            launches[kernel][f"CLI {name} (25b)"] = counts[kernel]
        check(counts["jpeg_idct_ffmpeg"] >= n, f"25b: J5 launched {counts['jpeg_idct_ffmpeg']} times "
              f"for {n} frames of {name}")
        launches["jpeg_idct_ffmpeg"][f"CLI {name} (25b)"] = counts["jpeg_idct_ffmpeg"]
        d_xy, d_val = compare_predictions(got, avi_labels, 0.0, 0.0,
                                          f"25b: sleap-track {name} vs 21b's {AVI_CLIP}")
        insts = sum(len(lf.instances) for lf in got)
        figures[name] = {"frames": n, "cli_s": seconds, "cli_fps": n / seconds, "launches": counts,
                         "instances": insts, "max_abs_dxy": d_xy, "max_abs_dscore": d_val}
        log(f"25b sleap-track {name} ({n} Motion-JPEG frames of {IMG}^2 gray) with the trained pair "
            f"in this process: {seconds:.3f} s = {n / seconds:.1f} FPS (21b {AVI_CLIP} in a fresh "
            f"process: {fps_21b:.1f} FPS); {insts} instances equal to 21b's exactly; launches "
            f"{counts} ({card})")
    stages = {}
    for name, demux in demuxers.items():
        with open(demux.filename, "rb") as fh:
            data = demux.read(fh, 0)
            demux_ms = median_ms(lambda: demux.read(fh, 0), 5)
        split, frame, _ = mjpeg_stages(data)
        stages[name] = {"demux_ms": demux_ms, **split}
        log(f"25b {name} frame 0 ({len(data)} bytes, {frame.header.blocks} blocks), ms a frame: "
            f"demux {demux_ms:.4f}, entropy (host C) {split['entropy_ms']:.3f}, copy in "
            f"{split['copy_in_ms']:.3f}, J5 {split['j5_ms']:.4f} (device "
            f"{split['j5_device_ms']:.4f}), conversion {split['convert_ms']:.4f}, copy out "
            f"{split['copy_out_ms']:.3f}; whole decode {split['frame_ms']:.3f} ({card})")
    figures["stages"] = stages
    figures["fps_21b"] = fps_21b
    return figures


def check_containers(launches, card, mode, avi_labels, fps_21b):
    """Phase 25: 25a and 25b, each part's seconds printed. Returns (figures,
    J5's max |err| over 25a)."""
    fixtures, j5_err = timed_phase("25a", check_container_fixtures, card, mode)
    cli = timed_phase("25b", check_container_cli, launches, card, avi_labels, fps_21b)
    return {"fixtures": fixtures, "cli": cli}, j5_err


# --------------------------------------------------------------------------- #
# Phase 26: MPEG-4 Part 2 on the card (host C entropy decoding, M1, M2, M3;
# FFmpeg's simple IDCT and Xvid's)
# --------------------------------------------------------------------------- #

MPEG4_DIR = ("tests", "torch_data", "mpeg4")
MPEG4_CLIP = "fmp4_gray_1024.avi"  # 26b's clip: 24 gray 1024^2 frames, two GOPs
#: 26a's and 26c's clip: 12 gray 1024^2 frames, I, P and B-VOPs, Xvid's IDCT.
MPEG4_XVID_CLIP = "xvid_gray_1024.avi"
#: 26a: the fixtures whose VOPs the host C decoder is held to the plain
#: Python one on, and M1, M2 and M3 to their plain versions: name -> VOPs
#: decoded (None: all). cv2's 200 x 120 clip's first four, and the
#: random-syntax streams (an I-VOP and three P-VOPs at 200 x 120, all the
#: others): 4MV, MPEG quantisation, video packets, not-coded VOPs, B-VOPs of
#: every kind, Xvid's IDCT, packed bitstreams.
MPEG4_PLAIN = {"fmp4_200x120.avi": 4, "syntax_64x48.avi": None, "syntax_200x120.avi": 4,
               "syntax_gray_48x32.avi": None, "syntax_4mv_200x120.avi": 4,
               "syntax_mpeg_quant_64x48.avi": None, "syntax_mpeg_quant_default_48x32.avi": None,
               "syntax_packets_200x120.avi": 4, "syntax_nvop_64x48.avi": None,
               "bvop_64x48.avi": None, "bvop_simple_vol_48x32.avi": None,
               "bvop_gov_closed_64x48.avi": None, "bvop_gov_broken_64x48.avi": None,
               "bvop_open_200x120.avi": None, "bvop_packets_96x64.avi": None,
               "bvop_mpeg_quant_48x32.avi": None, "xvid_bvop_200x120.avi": None,
               "divx_packed_64x48.avi": None, "xvid_packed_64x48.avi": None,
               "xvid_idct_64x48.avi": None}
#: The kernels of phase 26: row name -> (wrapper name in io/mpeg4.py, device
#: function, max |err| key). M1, M2 and M3 in their simple-IDCT and Xvid-IDCT
#: instantiations.
MPEG4_KERNELS = {
    "mpeg4_intra": ("intra_cuda", "mpeg4_intra_kernel", "M1"),
    "mpeg4_inter": ("inter_cuda", "mpeg4_inter_kernel", "M2"),
    "mpeg4_bidir": ("bidir_cuda", "mpeg4_bidir_kernel", "M3"),
    "mpeg4_intra_xvid": ("intra_xvid_cuda", "mpeg4_intra_kernel", "M1x"),
    "mpeg4_inter_xvid": ("inter_xvid_cuda", "mpeg4_inter_kernel", "M2x"),
    "mpeg4_bidir_xvid": ("bidir_xvid_cuda", "mpeg4_bidir_kernel", "M3x"),
}


def mpeg4_wrappers() -> dict:
    from sleap_tpu_torch.io import mpeg4

    return {name: getattr(mpeg4, w) for name, (w, _, _) in MPEG4_KERNELS.items()}


def mpeg4_path(name) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *MPEG4_DIR, name)


def mpeg4_manifest() -> dict:
    with open(mpeg4_path("manifest.json")) as fh:
        return json.load(fh)["files"]


def mpeg4_packets(name, limit=None):
    """The AVI fixture ``name``'s packets (at most ``limit``) and its fourcc."""
    from sleap_tpu_torch.io import avi

    demux = avi.AviVideo.open(mpeg4_path(name))
    n = len(demux.offsets) if limit is None else min(limit, len(demux.offsets))
    with open(demux.filename, "rb") as fh:
        return [demux.read(fh, i) for i in range(n)], demux.compression


def mpeg4_units(name, limit=None):
    """The VOPs FFmpeg decodes of the AVI fixture ``name`` (at most
    ``limit``), in decoding order (``mpeg4.scheduled_vops``)."""
    from sleap_tpu_torch.io import mpeg4

    packets, fourcc = mpeg4_packets(name)
    return list(itertools.islice(mpeg4.scheduled_vops(packets, fourcc), limit))


def mpeg4_vs_plain(inputs, layout, ref, rounding, err, what, idct="simple"):
    """A VOP's kernels (``mpeg4.reconstruct``: M2 then M1, or M3) on the card
    and as their plain versions, with ``idct``, on the same inputs and
    references: the planes held equal, each kernel's max |err| folded into
    ``err``. M2 and M1 write disjoint blocks, so the card's M2 under M1's
    plain version tells their errors apart. Returns the card's planes."""
    from sleap_tpu_torch.io import mpeg4

    x = "x" if idct == "xvid" else ""
    card_kernels, plain_kernels = mpeg4.CARD[idct], mpeg4.PLAIN[idct]
    card = mpeg4.reconstruct(inputs, layout, ref, rounding, card_kernels, idct=idct)
    want = mpeg4.reconstruct(inputs, layout, ref, rounding, plain_kernels, idct=idct)
    if len(inputs) == 2:
        err["M3" + x] = max(err["M3" + x], *(max_abs(a, b) for a, b in zip(card, want)))
    else:
        m2 = mpeg4.reconstruct(inputs, layout, ref, rounding,
                               (card_kernels[0], plain_kernels[1], card_kernels[2]), idct=idct)
        err["M2" + x] = max(err["M2" + x], *(max_abs(a, b) for a, b in zip(m2, want)))
        err["M1" + x] = max(err["M1" + x], *(max_abs(a, b) for a, b in zip(card, m2)))
    check(all(torch.equal(a, b) for a, b in zip(card, want)),
          f"26a: M1, M2 and M3 ({idct} IDCT) equal their plain versions on {what} (max |err| {err})")
    return card


def check_mpeg4_plain(dev, err):
    """26a: on every VOP FFmpeg decodes of MPEG4_PLAIN, the host C decoder
    against the plain Python one (coefficients, jobs and the co-located
    macroblocks a B-VOP reads equal), and M1, M2 and M3 against their plain
    versions on the card's tensors (:func:`mpeg4_vs_plain`). Returns (the
    VOPs held, the B-VOPs among them)."""
    from sleap_tpu_torch.io import mpeg4

    vops = b_vops = 0
    for name, limit in MPEG4_PLAIN.items():
        staging, planes = None, {}
        for u, unit, data, vop in mpeg4_units(name, limit):
            vol = unit.vol
            layout = mpeg4.Layout(*vol.mb_size)
            n = layout.mb_w * layout.mb_h
            if staging is None or staging.coefs.shape[0] != 6 * n:
                staging = mpeg4.Staging(n, pin=True)
            col = planes[unit.future][1] if vop.kind == "B" else None
            plain = mpeg4.decode_macroblocks(data, vol, vop, col)
            inputs, colocated = mpeg4.entropy_decode(data, vol, vop, dev, staging, colocated=col)
            want = (plain.coefs, plain.bidir) if vop.kind == "B" else (plain.coefs, plain.intra,
                                                                       plain.inter)
            check(all(np.array_equal(t.cpu().numpy(), a) for t, a in zip(inputs, want))
                  and (vop.kind == "B" or np.array_equal(colocated, plain.colocated)),
                  f"26a: the host C decoder equals the plain one on {name} VOP {u} ({vop.kind})")
            ref = ((planes[unit.past][0], planes[unit.future][0]) if vop.kind == "B"
                   else planes.get(unit.past, (None,))[0])
            out = mpeg4_vs_plain(inputs, layout, ref, vop.rounding, err,
                                 f"{name} VOP {u} ({vop.kind})", unit.idct)
            if vop.kind != "B":
                planes[u] = (out, colocated)
            vops += 1
            b_vops += vop.kind == "B"
    return vops, b_vops


def mpeg4_row(kind, jobs, card_fn, plain_fn, fn_name, residual):
    """A kernel's numbers on one VOP's jobs: ms a call (events), device ms,
    plain ms, and its bound's two parts. Each job's int4 (M3: two) read,
    its reference samples (8 x 8 a direction, 9 x 9 where half-pel) and
    residual (128 bytes, where it has one) read and its 64 samples written;
    600 operations an IDCT, 4 a predicted sample and direction."""
    if kind == "M1":
        moved, ops = (16 + 128 + 64) * len(jobs), 600 * len(jobs)
    else:
        dirs = jobs[:, 6].cpu() if kind == "M3" else None
        n_dirs = len(jobs) if kind == "M2" else int(((dirs & 1) + (dirs >> 1)).sum())
        moved = (16 * (1 + (kind == "M3")) + 64) * len(jobs) + 64 * n_dirs + 128 * residual
        ops = 4 * 64 * n_dirs + 600 * residual
    return {"jobs": len(jobs), "ms": events_ms(card_fn), "device_ms": device_ms(card_fn, [fn_name]),
            "plain_ms": time_ms(plain_fn, iters=3, warmup=1),
            "bytes_ms": moved / HBM_BYTES_PER_S * 1e3, "ops_ms": ops / F32_OPS_PER_S * 1e3}


def read_stages(clip):
    """ms a 1024^2 frame by stage over a sequential read of ``clip``
    (Mpeg4Reader's host-clock stages, the card synchronised at each: demux,
    entropy (host C), upload, M2, M1, M3, to_bgr, and the copy to the host),
    and its frames/s."""
    from sleap_tpu_torch.io import avi

    demux = avi.AviVideo.open(mpeg4_path(clip))
    reader = avi.AviReader(demux, torch.device("cuda", 0))._decoder
    reader.timing = {}
    copy_s = 0.0
    n = len(demux.offsets)
    t0 = time.perf_counter()
    for i in range(n):
        out = reader.frame(i, "b")
        t1 = time.perf_counter()
        out.cpu()
        copy_s += time.perf_counter() - t1
    total = time.perf_counter() - t0
    vops = reader.timing.pop("vops")
    stages = {f"{k}_ms": 1e3 * v / n for k, v in reader.timing.items()}
    stages["host_copy_ms"] = 1e3 * copy_s / n
    stages["vops"] = vops
    stages["frames_per_s"] = n / total
    reader.close()
    return stages


def time_mpeg4_stages(card, err):
    """26a: :func:`read_stages` over the 26b clip and the Xvid I/P/B clip;
    then, on the 26b clip's first I-VOP and P-VOP, M1 and M2, on the Xvid
    clip's first I-, P- and B-VOP, the Xvid forms of M1, M2 and M3, and on
    that B-VOP M3 (simple IDCT), each held to its plain version
    (:func:`mpeg4_vs_plain`, into ``err``) and timed (:func:`mpeg4_row`).
    Returns (stages by clip, rows by kernel key)."""
    from sleap_tpu_torch.io import mpeg4

    dev = torch.device("cuda", 0)
    stages = {clip: read_stages(clip) for clip in (MPEG4_CLIP, MPEG4_XVID_CLIP)}
    rows = {}
    for clip in (MPEG4_CLIP, MPEG4_XVID_CLIP):
        staging, planes, seen = None, {}, set()
        for u, unit, data, vop in mpeg4_units(clip):
            if seen >= {"I", "P", "B"} or (clip == MPEG4_CLIP and seen >= {"I", "P"}):
                break
            layout = mpeg4.Layout(*unit.vol.mb_size)
            staging = staging or mpeg4.Staging(layout.mb_w * layout.mb_h, pin=True)
            col = planes[unit.future][1] if vop.kind == "B" else None
            inputs, colocated = mpeg4.entropy_decode(data, unit.vol, vop, dev, staging,
                                                     colocated=col)
            ref = ((planes[unit.past][0], planes[unit.future][0]) if vop.kind == "B"
                   else planes.get(unit.past, (None,))[0])
            decoded = mpeg4_vs_plain(inputs, layout, ref, vop.rounding, err,
                                     f"{clip} VOP {u} ({vop.kind})", unit.idct)
            if vop.kind != "B":
                planes[u] = (decoded, colocated)
            if vop.kind in seen:
                continue
            seen.add(vop.kind)
            out = layout.planes(dev)
            for idct in ((unit.idct, "simple") if vop.kind == "B" else (unit.idct,)):
                x = "x" if idct == "xvid" else ""
                m2, m1, m3 = mpeg4.CARD[idct]
                p2, p1, p3 = mpeg4.PLAIN[idct]
                coefs = inputs[0]
                if vop.kind == "I":
                    kind, jobs = "M1", inputs[1]
                    fns = (lambda: m1(out, coefs, jobs, layout), lambda: p1(out, coefs, jobs, layout))
                elif vop.kind == "P":
                    kind, jobs = "M2", inputs[2]
                    fns = (lambda: m2(out, ref, coefs, jobs, layout, vop.rounding),
                           lambda: p2(out, ref, coefs, jobs, layout, vop.rounding))
                else:
                    kind, jobs = "M3", inputs[1]
                    if idct != unit.idct:  # the other instantiation on the same inputs
                        mpeg4_vs_plain(inputs, layout, ref, 0, err, f"{clip} VOP {u} (B)", idct)
                    fns = (lambda: m3(out, *ref, coefs, jobs, layout),
                           lambda: p3(out, *ref, coefs, jobs, layout))
                fn_name = {"M1": "mpeg4_intra_kernel", "M2": "mpeg4_inter_kernel",
                           "M3": "mpeg4_bidir_kernel"}[kind]
                rows[kind + x] = mpeg4_row(kind, jobs, *fns, fn_name, int((jobs[:, 1] >= 0).sum()))
                rows[kind + x]["clip"] = clip
    for clip, st in stages.items():
        log(f"26a MPEG-4 {clip} (1024^2 gray, {st['vops']} VOPs, read in order): "
            f"{st['frames_per_s']:.1f} frames/s; ms a frame by stage: "
            + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in st.items() if k.endswith("_ms")) + f" ({card})")
    log("26a kernels at 1024^2: " + "; ".join(
        f"{k} {r['jobs']} jobs: {r['ms']:.4f} ms a call (device {r['device_ms']:.4f}, plain "
        f"{r['plain_ms']:.3f}, bound {max(r['bytes_ms'], r['ops_ms']):.5f})" for k, r in rows.items())
        + f"; each equal to its plain version ({card})")
    return stages, rows


def check_mpeg4_fixtures(card, launches):
    """26a: every MPEG-4 fixture through ``MediaVideo``'s card route to the
    manifest's cv2 frames (BGR, and its blue channel, the gray route's
    frame), in order and at random, with cv2's count and fps, the kernels'
    counts zeroed before and read after (each of the six launched); then
    :func:`check_mpeg4_plain` and :func:`time_mpeg4_stages`, each part's
    seconds kept. Returns (figures, the kernels' max |err|, their rows'
    numbers)."""
    from sleap_tpu_torch.io import avi, mpeg4
    from sleap_tpu_torch.io.video import MediaVideo

    manifest = mpeg4_manifest()
    figures = {"files": 0, "frames_read": 0}
    wrappers = mpeg4_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for name, want in sorted(manifest.items()):
        path = mpeg4_path(name)
        n = want["readable"]
        order = list(range(n)) + [int(i) for i in np.random.default_rng(0).permutation(n)]
        colour = MediaVideo(path, grayscale=False, bgr=False)
        check((colour.frames, colour.fps) == (want["frames"], want["fps"]),
              f"26a: {name} has cv2's count and fps {(colour.frames, colour.fps)}")
        for i in order:
            frame = colour.get_frame(i)
            check(sha256(frame) == want["bgr"][i] and sha256(frame[..., 0]) == want["gray"][i],
                  f"26a: frame {i} of {name} is cv2's")
        reader = colour._reader
        check(isinstance(reader, mpeg4.Mpeg4Reader) or (isinstance(reader, avi.AviReader)
                                                         and reader.codec == "mpeg4"),
              f"26a: {name} read by {type(reader).__name__}")
        figures["frames_read"] += len(order)
        figures["files"] += 1
        colour.reset()
    counts = {k: w.launches for k, w in wrappers.items()}
    check(all(counts.values()), f"26a: every MPEG-4 kernel launched reading the fixtures ({counts})")
    for k, c in counts.items():
        launches.setdefault(k, {})["MediaVideo MPEG-4 fixtures (26a)"] = c
    check("cv2" not in sys.modules, "26a: the card route imported cv2")
    figures["reads_s"] = time.perf_counter() - t0
    figures["launches"] = counts
    t0 = time.perf_counter()
    err = {key: 0.0 for _, _, key in MPEG4_KERNELS.values()}
    vops, b_vops = check_mpeg4_plain(torch.device("cuda", 0), err)
    figures["vops_vs_plain"], figures["b_vops_vs_plain"] = vops, b_vops
    figures["vs_plain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stages, rows = time_mpeg4_stages(card, err)
    figures["stages_s"] = time.perf_counter() - t0
    figures["stages"] = stages
    figures["max_abs_err"] = err
    log(f"26a {figures['files']} MPEG-4 Part 2 fixtures (AVI, ISO-BMFF, Matroska; B-VOPs, Xvid, "
        f"packed) on the card: {figures['frames_read']} reads equal to cv2's (FFmpeg) frames in "
        f"order and at random, counts and fps equal, launches {counts} ({figures['reads_s']:.1f} "
        f"s); host C entropy decoder equal to the plain one, M1, M2 and M3 (both IDCTs) equal to "
        f"their plain versions on {vops} VOPs, {b_vops} of them B-VOPs "
        f"({figures['vs_plain_s']:.1f} s); stages {figures['stages_s']:.1f} s ({card})")
    return figures, err, rows


def check_mpeg4_cli(launches, card, clip=MPEG4_CLIP, part="26b", kernels=("mpeg4_intra",
                                                                          "mpeg4_inter")):
    """26b (26c): ``sleap-track`` (in this process) on a 1024^2 gray MPEG-4
    clip with phase 8b's trained top-down pair, cuDNN's algorithms
    deterministic, against ``load_model`` on the frames the card decodes
    (held to cv2's hashes): the points and scores equal; kernels 2, 3 and 1
    once a batch, the clip's MPEG-4 ``kernels`` each at least once (M2 once
    a P-VOP and M1 once an I-VOP, M3 once a B-VOP). Returns the figures it
    prints."""
    import sleap_tpu_torch
    from sleap_tpu_torch.io import mpeg4
    from sleap_tpu_torch.io.slp import read_labels
    from sleap_tpu_torch.io.video import Video
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks

    here = os.path.dirname(os.path.abspath(__file__))
    runs = os.path.join(here, ".convergence_runs")
    centroid, instance = (os.path.join(runs, f) for f in CLI_TRAINED[:2])
    wrappers = {"local_peaks": cuda_peaks.local_peaks_cuda, "crop_unit": cuda_crops.crop_unit_cuda,
                "global_peaks": cuda_peaks.global_peaks_cuda, **mpeg4_wrappers()}
    path, want = mpeg4_path(clip), mpeg4_manifest()[clip]
    video = Video.from_filename(path)
    decoded = video[:]
    n = len(decoded)
    check(video.shape == (n, IMG, IMG, 1) and n == want["readable"]
          and all(sha256(f) == h for f, h in zip(decoded, want["gray"])),
          f"{part}: the card decodes {clip} ({video.shape}) to cv2's gray frames")
    packets, fourcc = mpeg4_packets(clip)
    stream = mpeg4.Stream(fourcc)
    kinds = [stream.headers(p).kind for p in packets]
    pred = sleap_tpu_torch.load_model([centroid, instance], batch_size=AVI_BATCH,
                                      peak_threshold=0.05, max_instances=MAX_INSTANCES)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        expected = pred.predict(decoded)
        with tempfile.TemporaryDirectory() as root:
            out = os.path.join(root, "clip.predictions.slp")
            seconds, counts = cli_run(
                [path, "-m", centroid, "-m", instance, "--peak_threshold", "0.05", "--batch_size",
                 str(AVI_BATCH), "--max_instances", str(MAX_INSTANCES), "--verbosity", "none",
                 "-o", out], wrappers)
            got = read_labels(out)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    n_batches = -(-n // AVI_BATCH)
    for kernel in ("local_peaks", "crop_unit", "global_peaks"):
        check(counts[kernel] == n_batches,
              f"{part}: {kernel} launched {counts[kernel]} times on {clip}, want one a batch")
        launches[kernel][f"CLI {clip} ({part})"] = counts[kernel]
    need = {"I": kinds.count("I"), "P": kinds.count("P"), "B": kinds.count("B")}
    m2, m1 = kernels[1], kernels[0]
    check(counts[m2] >= need["P"] and counts[m1] >= need["I"]
          and (len(kernels) < 3 or counts[kernels[2]] >= 1)
          and all(counts[k] == 0 for k in MPEG4_KERNELS if k not in kernels),
          f"{part}: MPEG-4 launches {({k: counts[k] for k in MPEG4_KERNELS})} for {need} VOPs")
    for kernel in kernels:
        launches.setdefault(kernel, {})[f"CLI {clip} ({part})"] = counts[kernel]
    insts = sum(len(lf.instances) for lf in got)
    # 26c's frames are noise: only 26b's clip has an animal in every frame.
    check(part != "26b" or (len(got) == n and insts >= n), f"{part}: instances ({insts})")
    d_xy, d_val = compare_predictions(got, expected, 0.0, 0.0,
                                      f"{part}: sleap-track {clip} vs load_model")
    figures = {"frames": n, "vops": need, "cli_s": seconds, "cli_fps": n / seconds,
               "launches": counts, "instances": insts, "max_abs_dxy": d_xy, "max_abs_dscore": d_val}
    log(f"{part} sleap-track {clip} ({n} MPEG-4 frames of {IMG}^2 gray, VOPs {need}) with "
        f"the trained pair in this process: {seconds:.3f} s = {n / seconds:.1f} FPS; {insts} "
        f"instances equal to load_model's exactly; launches {counts} ({card})")
    return figures


def mpeg4_kernel_rows(err, rows, launches):
    """The ``kernels`` line's rows of M1, M2 and M3, each IDCT, at the
    1024^2 clips' VOPs."""
    out = []
    for name, (_, fn, key) in MPEG4_KERNELS.items():
        r = rows[key]
        out.append({
            "name": name, "route": "cuda", "source": "sleap_tpu_torch/csrc/mpeg4.cu",
            "replaces": "sleap_tpu/io/video.py:73",
            "replaces_note": "cv2.VideoCapture (FFmpeg's MPEG-4 Part 2 decoder) on the host in "
                             "MediaVideo; no TPU kernel",
            "device_function": fn + ("<true>" if key.endswith("x") else "<false>"),
            "idct": "xvid" if key.endswith("x") else "simple",
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name], "max_abs_err": err[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": None, "device_ms": r["device_ms"], "jobs": r["jobs"], "clip": r["clip"],
        })
    return out


def check_mpeg4(launches, card):
    """Phase 26: 26a, 26b and 26c (sleap-track on the Xvid I/P/B clip),
    each part's seconds printed. Returns (figures, the kernels' rows)."""
    fixtures, err, rows = timed_phase("26a", check_mpeg4_fixtures, card, launches)
    cli = timed_phase("26b", check_mpeg4_cli, launches, card)
    xvid_cli = timed_phase("26c", check_mpeg4_cli, launches, card, MPEG4_XVID_CLIP, "26c",
                           ("mpeg4_intra_xvid", "mpeg4_inter_xvid", "mpeg4_bidir_xvid"))
    return ({"fixtures": fixtures, "cli": cli, "xvid_cli": xvid_cli},
            mpeg4_kernel_rows(err, rows, launches))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU.")
    t_start = time.perf_counter()
    # What torch.export imports of its own (its partitioner imports
    # networkx, a dependency of torch), before any module of the port: the
    # JAX-side check at the end counts only what came after.
    importlib.import_module("torch.export._trace")
    torch_own = sorted({m.split(".")[0] for m in sys.modules} & set(JAX_SIDE))
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    decoder_probe()
    nvdec_caps = decoder_caps()
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
    log(f"phase 2 took {time.perf_counter() - t0:.1f} s")

    # Phase 3: each kernel vs its plain version.
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    errs = check_kernels(device, gen)
    path_maps, heads = path_head_maps(bu[0], frames[:BATCH])
    errs["local_peaks_hwcs"] = check_hwcs(device, gen, path_maps)
    log(f"phase 3 took {time.perf_counter() - t0:.1f} s")

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
    t0 = time.perf_counter()
    td_out = drive("top-down", td, frames, td_wrappers)
    check_topdown(td, td_cpu, frames, td_out)
    log(f"phase 4 took {time.perf_counter() - t0:.1f} s")

    # Phase 4b: the bottom-up path.
    t0 = time.perf_counter()
    hwcs_wrappers = {"local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda}
    bu_out = drive("bottom-up", bu[0], frames, hwcs_wrappers)
    check_bottomup(bu, frames, bu_out, heads)
    log(f"phase 4b took {time.perf_counter() - t0:.1f} s")

    # Phase 4c: the top-down path in bf16.
    t0 = time.perf_counter()
    bf16_wrappers = {
        "local_peaks_hwcs": cuda_peaks.local_peaks_hwcs_cuda,
        "crop_unit": cuda_crops.crop_unit_cuda,
        "global_peaks": cuda_peaks.global_peaks_cuda,
    }
    check_topdown_bf16(td_bf16, frames, drive("top-down bf16", td_bf16, frames, bf16_wrappers))
    log(f"phase 4c took {time.perf_counter() - t0:.1f} s")

    # Phase 4d: single-instance in bf16.
    t0 = time.perf_counter()
    si_wrappers = {"global_peaks": cuda_peaks.global_peaks_cuda}
    out = drive("single-instance bf16", si, si_frames, si_wrappers, SI_BATCH)
    check_single(si, si_frames, out)
    log(f"phase 4d took {time.perf_counter() - t0:.1f} s")

    # Phase 5: kernel and plain version times at the main-path shapes, with
    # the card in the state phases 4-4d leave it in; the launch counts of the
    # paths after it are added to the rows at the end.
    kernels = timed_phase("5", kernel_rows, errs, launches, card)

    # Phase 4e: top-down multiclass, float32, on blobs of four sizes that
    # its class layer is set to tell apart.
    t0 = time.perf_counter()
    frames_mc = mc_frames((1 + TIMED_BATCHES) * BATCH, seed=3)
    cuts, margin = fit_class_head([td_mc, td_mc_cpu], frames_mc)
    log(f"top-down multiclass class cuts {[round(c, 5) for c in cuts]}, crops at least "
        f"{margin:.3g} of the spread from a cut")
    out = drive("top-down multiclass", td_mc, frames_mc, td_wrappers)
    check_topdown_mc(td_mc, td_mc_cpu, frames_mc, out)
    log(f"phase 4e took {time.perf_counter() - t0:.1f} s")

    # Phase 4f: bottom-up multiclass, bf16.
    t0 = time.perf_counter()
    out = drive("bottom-up multiclass bf16", bu_mc, frames, hwcs_wrappers)
    check_bottomup_mc(bu_mc, frames, out)
    log(f"phase 4f took {time.perf_counter() - t0:.1f} s")

    # Phase 4g: the trained folders, read from their checkpoints.
    all_wrappers = {**td_wrappers, **hwcs_wrappers}
    read_s = timed_phase("4g", check_trained_folders, all_wrappers, launches)

    # Phase 6: tracking.
    t0 = time.perf_counter()
    track_paths = blob_paths((1 + TRACK_TIMED_BATCHES) * BATCH, IMG,
                             [[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]],
                             [150.0, 150.0], seed=4)
    track_frames = moving_frames(track_paths, IMG, 8.0, 200.0, seed=4)
    tracked, tracking = check_tracked_path(td_tracked, track_frames, td_wrappers, launches, fps,
                                           card)
    check_tracking_card_vs_cpu(tracked)
    check_tracking_trained()
    log(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    # Phase 7: training.
    t7 = time.perf_counter()
    training = {"throughput": check_train_throughput(card),
                "step_card_vs_cpu": check_step_card_vs_cpu(card),
                "top-down pair": check_train_pair(card, td_wrappers, launches)}
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s")

    # Phase 8: sleap-track from .slp to .slp (8a's output kept for phases 14
    # and 15).
    t8 = time.perf_counter()
    kept = {"dir": tempfile.mkdtemp(prefix="chip_smoke_8a_")}
    try:
        cli = {"full_width": check_cli_full_width(td, td_wrappers, launches, card, keep=kept),
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

        # Phase 12: H.264 .mp4 on the card (demuxer, NVDEC, OpenCV's colour rule).
        t12 = time.perf_counter()
        nvdec_state = nvdec_mode(nvdec_caps, os.environ.get("NVIDIA_DRIVER_CAPABILITIES"))
        media = {"nvdec": nvdec_state, "fixtures": check_media_fixtures(card, nvdec_state),
                 "cli": check_media_cli(td, launches, card, cli["full_width"]["cli_fps"],
                                        nvdec_state)}
        log(f"phase 12 took {time.perf_counter() - t12:.1f} s")

        # Phase 13: frames in and out of users' files (PNG, JPEG, ImgStore).
        t13 = time.perf_counter()
        png_figures = check_png_packages(card)
        jpeg_figures, jpeg_rows = check_jpeg(card)
        launches["jpeg_idct"], launches["jpeg_color"] = {}, {}
        jpeg_cli = check_jpeg_cli(td, launches, card, cli["full_width"]["cli_fps"])
        for kernel in ("jpeg_idct", "jpeg_color"):
            launches[kernel]["CLI jpeg_pkg.slp (13c)"] = jpeg_cli["launches"][kernel]
        frames_io = {"png": png_figures, "jpeg": jpeg_figures, "jpeg_cli": jpeg_cli,
                     "imgstore": check_imgstore(card)}
        log(f"phase 13 took {time.perf_counter() - t13:.1f} s")

        # Phase 14: the data model, sleap-convert and a DeepLabCut project.
        data_model = timed_phase("14", check_data_model, td, td_wrappers, launches, card, kept,
                                 cli["full_width"]["cli_fps"])

        # Phase 15: sleap-export of phase 4's and 4b's paths and the trained
        # single-instance folder, run as programs; re-tracking 8a's .slp.
        export = {
            "15a top-down float32": timed_phase(
                "15a", check_exported, "top-down", td, frames, td_out, td_wrappers, launches,
                fps["top-down"], card),
            "15b bottom-up bf16": timed_phase(
                "15b", check_exported, "bottom-up", bu[0], frames, bu_out, hwcs_wrappers,
                launches, fps["bottom-up"], card),
            "15c trained single-instance": timed_phase(
                "15c", check_trained_export, drive, si_wrappers, launches, fps, card),
            "15d re-tracking": timed_phase("15d", check_retrack, kept, card),
        }

        # Phase 16: sleap-diagnostic, system, from_trained_models and
        # VisualPredictor, NWB/NIX and image-feature suggestions on 8a's
        # .slp, prefs, util and message.
        host_modules = timed_phase("16", check_host_modules, td_cpu, all_wrappers, launches, kept, card)

        # Phase 17: the pipeline blocks (kernels 2, 3 and 1), the training
        # pipelines, sleap-train --zmq with its visualizations, MoveNet, and
        # the host helpers.
        slice_modules = timed_phase("17", check_slice_modules, td, td_cpu, frames, td_wrappers, launches,
                                    kept, card)

        # Phase 18: JPEG encoding on the card (J3, J4), the JPEG writes, and
        # sleap-render writing a Motion-JPEG AVI.
        jpeg_encoding, encode_rows = timed_phase("18", check_jpeg_encoding, card, launches, kept)
        jpeg_rows.update(encode_rows)

        # Phase 19: still images: progressive JPEG through J1 and J2, BMP and
        # TIFF decoded and written on the card's route, sleap-track on a
        # TIFF package.
        still_images = timed_phase("19", check_still_images, td, td_wrappers, launches, card, kept)

        # Phase 20: users' own HDF5 files (latest format, SWMR, LZF in host
        # C), and sleap-track on the latest-format twin of raw.slp.
        hdf5_files = timed_phase("20", check_hdf5_files, td_wrappers, launches, card)

        # Phase 21: users' AVI videos on the card (the demuxer, Motion-JPEG
        # through J5, raw frames), and sleap-track clip.avi.
        fps_12b = media["cli"].get("cli_fps")
        avi_videos, j5 = timed_phase("21", check_avi_videos, launches, card, fps_12b,
                                     jpeg_cli["cli_fps"], kept)

        # Phase 22: every still cv2 reads: the TIFF and JPEG layouts of this
        # slice on the card (J2's new modes, J6, host CCITT), and top-down
        # predict on a SingleImageVideo of four 1024^2 ones.
        all_stills, j6 = timed_phase("22", check_all_stills, launches, card)

        # Phase 23: data-parallel inference (23a top-down, 23b bottom-up, on
        # replicas) and training (23c, two ranks); phase 24's ranks start up
        # during 23c.
        singles, spatial_groups = {}, []

        def start_ranks():
            spatial_groups.extend(start_spatial_ranks())
            return spatial_groups

        parallel = timed_phase("23", check_parallel, td, bu[0], frames, td_wrappers, hwcs_wrappers,
                               launches, card, singles, start_ranks)

        # Phase 24: spatially sharded training (two ranks, a band each),
        # against 23c's one-process runs.
        spatial = timed_phase("24", check_spatial_training, spatial_groups, singles, card)

        # Phase 25: users' QuickTime and Matroska videos on the card (edit
        # lists, Motion-JPEG through J5, H.264 in Matroska to NVDEC), and
        # sleap-track clip.mov / clip.mkv against 21b's clip.avi.
        containers, j5_25a = timed_phase("25", check_containers, launches, card, nvdec_state,
                                         kept.pop("avi_labels"), avi_videos["cli"]["cli_fps"])
        j5 = (max(j5[0], j5_25a), j5[1])

        # Phase 26: MPEG-4 Part 2 videos on the card (host C entropy decoding,
        # M1, M2 and M3 with FFmpeg's simple IDCT or Xvid's), and sleap-track
        # on a 1024^2 FMP4 clip and a 1024^2 Xvid clip with B-VOPs.
        mpeg4_videos, mpeg4_rows = timed_phase("26", check_mpeg4, launches, card)
    finally:
        shutil.rmtree(kept["dir"], ignore_errors=True)
    for row in kernels:
        row["launches"] = sum(row["launches_by_path"].values())
    kernels += jpeg_kernel_rows(jpeg_rows, launches)
    kernels.append(avi_kernel_row(j5, launches))
    kernels.append(smooth_kernel_row(j6, launches))
    kernels += mpeg4_rows

    leaked = [m for m in sys.modules if m.split(".")[0] in JAX_SIDE
              and m.split(".")[0] not in torch_own]
    check(not leaked, f"JAX-side modules imported: {leaked[:5]}")
    log(f"JAX-side packages none of the port imports; loaded by torch.export itself: {torch_own}")

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
    print(json.dumps({"media": media, "card": card}), flush=True)
    print(json.dumps({"frames_io": frames_io, "card": card}), flush=True)
    print(json.dumps({"data_model": data_model, "card": card}), flush=True)
    print(json.dumps({"export": export, "card": card}), flush=True)
    print(json.dumps({"host_modules": host_modules, "card": card}), flush=True)
    print(json.dumps({"pipelines": slice_modules, "card": card}), flush=True)
    print(json.dumps({"jpeg_encoding": jpeg_encoding, "card": card}), flush=True)
    print(json.dumps({"still_images": still_images, "card": card}), flush=True)
    print(json.dumps({"hdf5": hdf5_files, "card": card}), flush=True)
    print(json.dumps({"avi": avi_videos, "card": card}), flush=True)
    print(json.dumps({"all_stills": all_stills, "card": card}), flush=True)
    print(json.dumps({"parallel": parallel, "card": card}), flush=True)
    print(json.dumps({"spatial": spatial, "card": card}), flush=True)
    print(json.dumps({"containers": containers, "card": card}), flush=True)
    print(json.dumps({"mpeg4": mpeg4_videos, "card": card}), flush=True)
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
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
