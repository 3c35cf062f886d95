"""The port runs without the JAX side: in a fresh interpreter whose imports of
``sleap_tpu``, ``jax``, ``flax``, ``orbax``, ``networkx``, ``attr``, ``h5py``,
``cv2``, ``yaml``, ``imgstore``, ``zstandard``, ``tensorstore``, ``pandas``,
``sklearn``, ``zmq``, ``pynwb``, ``ndx_pose``, ``nixio``, ``matplotlib`` and
``tensorflow`` fail, every module of
``sleap_tpu_torch`` imports, a run folder written by the port's own config
code loads through ``load_model``, trained ``.convergence_runs`` folders load
from their orbax checkpoints with no ``params``, and ``predict`` returns the
port's ``Labels``, with tracks when ``load_model`` is given
``tracker="flow"``; and a centroid model trained by the port for one
epoch loads from its ``best_model.pt`` and predicts, paired with an
instance folder; and ``python -m sleap_tpu_torch.cli.track`` reads a
``.slp`` training package (PNG frames), predicts and writes a ``.slp`` that
h5py and the JAX reader read back; and ``python -m sleap_tpu_torch.cli.train``
trains a shipped profile (at filters 4) on a project of two videos of
different sizes, scores it and ``sleap-inspect`` describes the folder and
the project; and frames go in and out of users' files: a PNG training
package written and read back, an ImgStore written and read back, the
committed JPEG, BMP and TIFF stills decoded to cv2's recorded frames, a TIFF
package and BMP and TIFF ImgStores written and read back, and a JPEG
package rendered by ``sleap-render`` to a Motion-JPEG AVI; and the data
model's calls (``numpy``, ``remove_predictions``, a track swap, ``merge``,
``describe``), ``sleap-convert`` to an analysis ``.h5`` and ``.csv``, and a
DeepLabCut project import; and a ``dataset_ops`` chain (shuffle, batch,
prefetch, unbatch) over a labels reader, the pipeline blocks' top-down
chain, and a ``MoveNetPredictor`` with an injected model; and the
functions that need an optional package (NWB, NIX, image-feature
suggestions, paired messages, saving preferences, ZMQ training progress,
drawing, a MoveNet SavedModel) raise ``ImportError`` naming it, while ``sleap-diagnostic``'s summary, the
HDF5 helpers of ``util`` and reading preferences work; and, in an
interpreter of its own, ``sleap-export``
of a trained folder on the CPU, loaded back and run. Also: the entry
points default to the card, and paths are read.
"""

import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.inference import bottomup as tb
from sleap_tpu_torch.inference import multiclass as tm
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.inference.movenet import MoveNetPredictor
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import flax_from_state_dict
from sleap_tpu_torch.tracking import tracker

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("sleap_tpu", "jax", "jaxlib", "flax", "orbax", "networkx", "attr", "attrs", "h5py", "cv2",
           "yaml", "imgstore", "zstandard", "tensorstore", "pandas", "sklearn", "zmq", "pynwb", "ndx_pose",
           "nixio", "matplotlib", "tensorflow")

_SCRIPT = r"""
import importlib, json, os, pkgutil, sys

BLOCKED = set(sys.argv[1].split(","))

# As if not installed: importing them raises ImportError, and probes such as
# importlib.util.find_spec (which torch.optim's lazy torch._dynamo import
# makes for networkx) find nothing.
for name in BLOCKED:
    sys.modules[name] = None

import numpy as np
import torch

import sleap_tpu_torch
from sleap_tpu_torch.config import (
    BackboneConfig, CenteredInstanceConfmapsHeadConfig, CentroidsHeadConfig, DataConfig,
    HeadsConfig, InstanceCroppingConfig, LabelsConfig, ModelConfig, MultiInstanceConfig,
    MultiInstanceConfmapsHeadConfig, PartAffinityFieldsHeadConfig, PreprocessingConfig,
    TrainingJobConfig, UNetConfig,
)
from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.models.model import Model, init_params
from sleap_tpu_torch.models.params import flax_from_state_dict

torch.set_num_threads(1)
modules = [m.name for m in pkgutil.walk_packages(sleap_tpu_torch.__path__, "sleap_tpu_torch.")]
for name in modules:
    importlib.import_module(name)

nodes = [f"n{i}" for i in range(13)]
skeleton = Skeleton("chain")
for n in nodes:
    skeleton.add_node(n)
for a, b in zip(nodes[:-1], nodes[1:]):
    skeleton.add_edge(a, b)
unet = UNetConfig(max_stride=16, output_stride=4, filters=8, filters_rate=2.0,
                  up_interpolate=True, space_to_depth=4)
tmp = sys.argv[2]  # an empty folder the caller owns and removes


def run_folder(name, heads, input_scaling, crop_size=None, seed=0, paf_scale=1.0):
    cfg = TrainingJobConfig(
        data=DataConfig(
            labels=LabelsConfig(skeletons=[skeleton]),
            preprocessing=PreprocessingConfig(input_scaling=input_scaling, pad_to_stride=16),
            instance_cropping=InstanceCroppingConfig(crop_size=crop_size),
        ),
        model=ModelConfig(backbone=BackboneConfig(unet=unet), heads=heads),
    )
    path = os.path.join(tmp, name)
    os.makedirs(path)
    cfg.save_json(os.path.join(path, "training_config.json"))
    loaded = TrainingJobConfig.load_json(path)
    net = Model.from_config(loaded.model, skeleton=loaded.data.labels.skeletons[0]).make_module(1)
    init_params(net, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-negative heads: maps with peaks above threshold
        for hname, head in net.heads.items():
            head.weight.abs_().mul_(paf_scale if "PartAffinity" in hname else 3.0)
    return path, flax_from_state_dict(net)


centroid, c_params = run_folder(
    "centroid", HeadsConfig(centroid=CentroidsHeadConfig(output_stride=4)), 0.5, seed=0)
instance, i_params = run_folder(
    "instance", HeadsConfig(centered_instance=CenteredInstanceConfmapsHeadConfig(output_stride=4)),
    1.0, crop_size=32, seed=1)
bottomup, b_params = run_folder(
    "bottomup", HeadsConfig(multi_instance=MultiInstanceConfig(
        confmaps=MultiInstanceConfmapsHeadConfig(output_stride=4, sigma=2.5),
        pafs=PartAffinityFieldsHeadConfig(output_stride=8, sigma=5.0))),
    1.0, seed=2, paf_scale=40.0)

rng = np.random.default_rng(0)
yy, xx = np.mgrid[0:96, 0:96]
frames = rng.uniform(0, 30, (3, 96, 96, 1))
for i in range(3):
    for _ in range(3):
        cy, cx = rng.uniform(20, 76, 2)
        frames[i] += 200 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 6.0**2))[..., None]
frames = np.clip(frames, 0, 255).astype(np.uint8)

result = {"modules": modules}
for key, paths, params in (
    ("topdown", [centroid, instance], {centroid: c_params, instance: i_params}),
    ("bottomup", bottomup, {bottomup: b_params}),
):
    pred = sleap_tpu_torch.load_model(paths, device="cpu", params=params, batch_size=2,
                                      max_instances=3)
    examples = pred.predict(frames, make_labels=False)
    labels = pred.predict(frames)
    if key == "topdown":
        want = [int(m.sum()) for ex in examples for m in ex["centroid_mask"][:ex["n_valid"]]]
    else:
        want = [len(p) for ex in examples for p in ex["instance_peaks"][:ex["n_valid"]]]
    insts = [i for lf in labels for i in lf.instances]
    result[key] = {
        "predictor": type(pred).__name__,
        "labels": type(labels) is Labels,
        "frames": [type(lf) is LabeledFrame for lf in labels],
        "frame_inds": [lf.frame_idx for lf in labels],
        "instances": [len(lf.instances) for lf in labels],
        "want_instances": want,
        "all_predicted": all(type(i) is PredictedInstance for i in insts),
        "node_names": [list(i.skeleton.node_names) for i in insts[:1]],
        "finite_points": sum(int(np.isfinite(i.numpy()[:, 0]).sum()) for i in insts),
        "n_videos": len(labels.videos),
        "provenance": labels.provenance.get("predictor"),
    }
# Trained folders, weights read from their orbax checkpoints by the port.
runs = os.path.join(os.getcwd(), ".convergence_runs")
for key, paths in (
    ("trained_single", os.path.join(runs, "minimal_robot.UNet.single_instance")),
    ("trained_multiclass", [os.path.join(runs, "minimal_instance.UNet.centroid"),
                            os.path.join(runs, "min_tracks_2node.UNet.topdown_multiclass")]),
):
    pred = sleap_tpu_torch.load_model(paths, device="cpu", batch_size=2, peak_threshold=0.05)
    labels = pred.predict(frames)
    result[key] = {
        "predictor": type(pred).__name__,
        "labels": type(labels) is Labels,
        "n_frames": len(labels),
        "tracks": [t.name for t in labels.tracks],
    }
# Flow-shift tracking, on the CPU: the top-down folders, then the trained
# single-instance folder.
import sleap_tpu_torch.tracking as tracking

for key, paths, params in (
    ("tracked_topdown", [centroid, instance], {centroid: c_params, instance: i_params}),
    ("tracked_single", os.path.join(runs, "minimal_robot.UNet.single_instance"), None),
):
    pred = sleap_tpu_torch.load_model(paths, device="cpu", params=params, batch_size=2,
                                      max_instances=3, peak_threshold=0.05, tracker="flow")
    labels = pred.predict(frames)
    insts = [i for lf in labels for i in lf.instances]
    result[key] = {
        "tracker": type(pred.tracker.candidate_maker).__name__,
        "device": str(pred.tracker.candidate_maker.device),
        "instances": len(insts),
        "all_tracked": all(i.track is not None for i in insts),
        "tracks": [t.name for t in labels.tracks],
        "exports": sorted(tracking.__all__),
    }
# Training: a tiny centroid model, one epoch, then loaded from its
# best_model.pt and predicted with the seeded instance folder.
from sleap_tpu_torch.core.instance import Instance
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.training.trainer import Trainer

video = Video.from_numpy(frames)
train_labels = Labels([LabeledFrame(video, i, [Instance(skeleton, rng.uniform(20, 76, (13, 2)))
                                               for _ in range(2)]) for i in range(3)])
cfg = TrainingJobConfig(
    data=DataConfig(preprocessing=PreprocessingConfig(input_scaling=0.5, pad_to_stride=16)),
    model=ModelConfig(backbone=BackboneConfig(unet=unet),
                      heads=HeadsConfig(centroid=CentroidsHeadConfig(output_stride=4))),
)
cfg.optimization.batch_size = 2
cfg.optimization.batches_per_epoch = 2
cfg.optimization.val_batches_per_epoch = 1
cfg.optimization.epochs = 1
cfg.outputs.runs_folder = tmp
cfg.outputs.run_name = "trained_centroid"
trainer = Trainer.from_config(cfg, training_labels=train_labels, validation_labels=train_labels,
                              device="cpu")
trainer.train()
trained = os.path.join(tmp, "trained_centroid")
pred = sleap_tpu_torch.load_model([trained, instance], device="cpu", batch_size=2,
                                  peak_threshold=0.0, params={instance: i_params})
examples = pred.predict(frames, make_labels=False)
result["trained_here"] = {
    "trainer": type(trainer).__name__,
    "files": sorted(os.listdir(trained)),
    "epochs": len(trainer.log_rows),
    "predictor": type(pred).__name__,
    "n_valid": sum(ex["n_valid"] for ex in examples),
    "centroid_shapes": [list(np.shape(ex["centroids"])) for ex in examples],
    "labels": type(pred.predict(frames)).__name__,
}
# sleap-track as ``python -m`` runs it, on the training package with PNG
# frames: read, predict with the trained top-down pair, write .slp.
import runpy

from sleap_tpu_torch.io.slp import read_labels

cli_out = os.path.join(tmp, "cli_out.slp")
argv = sys.argv
sys.argv = ["track", os.path.join("tests", "torch_data", "pkg.slp"),
            "-m", os.path.join(runs, "minimal_instance.UNet.centroid"),
            "-m", os.path.join(runs, "minimal_instance.UNet.centered_instance"),
            "--cpu", "--verbosity", "none", "--peak_threshold", "0.05", "-o", cli_out]
runpy.run_module("sleap_tpu_torch.cli.track", run_name="__main__")
sys.argv = argv
cli = read_labels(cli_out)
result["cli"] = {
    "path": cli_out,
    "predictor": cli.provenance.get("predictor"),
    "frames": [lf.frame_idx for lf in cli],
    "points": [[inst.numpy().tolist() for inst in lf.instances] for lf in cli],
}
# sleap-train as ``python -m`` runs it, on a project of two videos of
# different sizes (so frames are size-matched without cv2): a shipped
# profile at filters 4 for one epoch, scored after training; then
# sleap-inspect on the run folder and on the project.
import contextlib
import io

from sleap_tpu_torch.core.instance import Instance
from sleap_tpu_torch.info import labels as info
from sleap_tpu_torch.io.slp import write_labels
from sleap_tpu_torch.io.video import Video

two_sizes = []
for size, n in ((96, 4), (72, 3)):
    video = Video.from_numpy(np.ascontiguousarray(
        np.clip(rng.uniform(0, 255, (n, size, size, 1)), 0, 255).astype(np.uint8)))
    for i in range(n):
        pts = rng.uniform(16, size - 16, (1, 2)) + rng.uniform(-5, 5, (13, 2))
        two_sizes.append(LabeledFrame(video, i, [Instance(skeleton, pts)]))
project = os.path.join(tmp, "two_sizes.slp")
write_labels(project, Labels(two_sizes))
profile = json.load(open(os.path.join("sleap_tpu_torch", "training_profiles",
                                      "baseline_medium_rf.topdown.json")))
profile["model"]["backbone"]["unet"]["filters"] = 4
profile["optimization"].update(epochs=1, batches_per_epoch=2, val_batches_per_epoch=1)
profile["outputs"]["runs_folder"] = tmp
profile_path = os.path.join(tmp, "tiny_profile.json")
json.dump(profile, open(profile_path, "w"))
sys.argv = ["train", profile_path, project, "--cpu", "--run_name", "cli_trained"]
runpy.run_module("sleap_tpu_torch.cli.train", run_name="__main__")
sys.argv = argv
trained_cli = os.path.join(tmp, "cli_trained")
inspected = {}
for key, path in (("folder", trained_cli), ("project", project)):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        info.main([path])
    inspected[key] = out.getvalue()
result["cli_train"] = {
    "files": sorted(os.listdir(trained_cli)),
    "metrics": {split: sorted(sleap_tpu_torch.load_metrics(trained_cli, split=split))
                for split in ("train", "val")},
    "sizes": sorted({tuple(v.shape[1:3]) for v in read_labels(project).videos}),
    "inspect": inspected,
}
# Frames in and out of users' files on the CPU routes: a PNG training
# package, an ImgStore, and the JPEG stills against cv2's recorded decode.
import hashlib

from sleap_tpu_torch.io import jpeg

pkg_path = os.path.join(tmp, "frames.pkg.slp")
Labels(two_sizes).save(pkg_path, with_images=True)
pkg_videos = read_labels(pkg_path, device="cpu").videos
store = Video.from_numpy(frames).to_imgstore(os.path.join(tmp, "store"), frame_numbers=[0, 2],
                                            device="cpu")
stills = json.load(open(os.path.join("tests", "torch_data", "jpeg", "decoded.json")))["stills"]
decoded = {}
for name, want in stills.items():
    if "sha256" in want and "1024" not in name:
        data = open(os.path.join("tests", "torch_data", "jpeg", name + ".jpg"), "rb").read()
        img = jpeg.imdecode(data, device="cpu")
        decoded[name] = hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
# A JPEG package, rendered by sleap-render: with cv2 blocked (and imageio
# unable to write an AVI), a Motion-JPEG AVI.
from sleap_tpu_torch.io import avi, visuals

jpg_path = os.path.join(tmp, "frames.jpg.pkg.slp")
Labels(two_sizes).save(jpg_path, with_images=True, image_format="jpg", device="cpu")
jpg_video = read_labels(jpg_path, device="cpu").videos[0]
rendered = os.path.join(tmp, "rendered.avi")
visuals.main([jpg_path, "--cpu", "-o", rendered])
chunks = avi.read_frames(rendered)
# BMP and TIFF: the committed stills against cv2's recorded decode, and a
# TIFF package and BMP and TIFF ImgStores written and read back.
from sleap_tpu_torch.io import stills as still_codecs

still_record = json.load(open(os.path.join("tests", "torch_data", "stills", "decoded.json")))["stills"]
bmp_tiff = {}
for name, want in still_record.items():
    if "sha256" in want and "1024" not in name:
        data = open(os.path.join("tests", "torch_data", "stills", name), "rb").read()
        img = still_codecs.imdecode(data, "cpu")
        bmp_tiff[name] = hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]
tif_path = os.path.join(tmp, "frames.tif.pkg.slp")
Labels(two_sizes).save(tif_path, with_images=True, image_format="tif", device="cpu")
tif_videos = read_labels(tif_path, device="cpu").videos
written = {"package": [bool(np.array_equal(v[:], lf.video[:]))
                       for v, lf in zip(tif_videos, [two_sizes[0], two_sizes[-1]])]}
for fmt in ("bmp", "tif"):
    kept = Video.from_numpy(frames).to_imgstore(os.path.join(tmp, "store_" + fmt), frame_numbers=[0, 2],
                                               format=fmt, device="cpu")
    written[fmt] = bool(np.array_equal(kept.get_frames([0, 2]), frames[[0, 2]]))
result["bmp_tiff"] = {"stills": bmp_tiff, "written": written}
result["frames_io"] = {
    "package": [bool(np.array_equal(v[:], lf.video[:]))
                for v, lf in zip(pkg_videos, [two_sizes[0], two_sizes[-1]])],
    "package_backends": [type(v.backend).__name__ for v in pkg_videos],
    "imgstore": bool(np.array_equal(store.get_frames([0, 2]), frames[[0, 2]])),
    "jpeg": decoded,
    "render": {"chunks": len(chunks), "want": len(jpg_video.backend.embedded_frame_inds),
               "shape": list(jpeg.imdecode(chunks[0], "cpu").shape),
               "want_shape": [jpg_video.height, jpg_video.width, 3]},
}
# The data model, sleap-convert and a DeepLabCut import.
from sleap_tpu_torch.core.instance import Track
from sleap_tpu_torch.io import convert, formats, png
from sleap_tpu_torch.io.hdf5 import File as H5File

dm_skel = Skeleton("pair")
dm_skel.add_nodes(["a", "b"])
dm_skel.add_edge("a", "b")
dm_tracks = [Track(0, "t0"), Track(0, "t1")]
dm_video = Video.from_numpy(np.zeros((6, 8, 8, 1), np.uint8))
dm_rng = np.random.default_rng(0)
dm = Labels([LabeledFrame(dm_video, i, [PredictedInstance.from_arrays(dm_rng.uniform(0, 8, (2, 2)), np.ones(2),
                                                                      0.5, dm_skel, track=t) for t in dm_tracks])
             for i in range(0, 6, 2)])
tracks_before = dm.numpy()
first_points = np.stack([[i.numpy() for i in lf.instances] for lf in dm.labeled_frames]).astype("f4")
cleared = dm.copy()
cleared.remove_predictions()
dm.track_swap(dm_video, dm_tracks[1], dm_tracks[0], (0, 3))
other = Labels([LabeledFrame(dm_video, 5, [PredictedInstance.from_arrays(np.ones((2, 2)), np.ones(2), 0.5,
                                                                         dm_skel, track=dm_tracks[0])])])
dm.merge(other)
described = io.StringIO()
with contextlib.redirect_stdout(described):
    dm.describe()
dm_path = os.path.join(tmp, "dm.slp")
dm.save(dm_path)
with contextlib.redirect_stdout(io.StringIO()):
    convert.main([dm_path, "--format", "analysis", "-o", os.path.join(tmp, "dm.h5")], device="cpu")
    convert.main([dm_path, "--format", "analysis.csv", "-o", os.path.join(tmp, "dm.csv")], device="cpu")
analysis = formats.read(os.path.join(tmp, "dm.h5"), device="cpu")
with H5File(os.path.join(tmp, "dm.h5")) as f:
    h5_keys = sorted(f.keys())
dlc_dir = os.path.join(tmp, "dlc", "labeled-data", "clip")
os.makedirs(dlc_dir)
with open(os.path.join(tmp, "dlc", "config.yaml"), "w") as fh:
    fh.write("Task: t\nscorer: me\nmultianimalproject: false\nbodyparts:\n- a\n- b\nskeleton:\n- - a\n  - b\n")
rows = ["scorer,me,me,me,me", "bodyparts,a,a,b,b", "coords,x,y,x,y"]
for i in range(3):
    with open(os.path.join(dlc_dir, f"img{i:04d}.png"), "wb") as fh:
        fh.write(png.encode(np.full((8, 8, 1), 40 * i, np.uint8)))
    rows.append(f"labeled-data/clip/img{i:04d}.png,{i}.5,2.0,3.0,{i + 4}.0")
with open(os.path.join(dlc_dir, "CollectedData_me.csv"), "w") as fh:
    fh.write("\n".join(rows) + "\n")
dlc = Labels.load_deeplabcut(os.path.join(tmp, "dlc", "config.yaml"), device="cpu")
result["data_model"] = {
    "numpy_shape": list(tracks_before.shape),
    "numpy_equal": bool(np.array_equal(tracks_before[[0, 2, 4]], first_points)),
    "cleared": [len(cleared), len(dm.labeled_frames) > 0],
    "swapped": [[i.track.name for i in lf.instances] for lf in dm.labeled_frames],
    "described": described.getvalue().splitlines()[2:4],
    "h5_keys": h5_keys,
    "analysis_equal": bool(np.array_equal(analysis.numpy(all_frames=False), dm.numpy(all_frames=False),
                                          equal_nan=True)),
    "csv_lines": len(open(os.path.join(tmp, "dm.csv")).read().splitlines()),
    "dlc": [len(dlc), dlc.skeleton.node_names, dlc.labeled_frames[1].instances[0].numpy().tolist(),
            int(dlc.video.get_frame(2)[0, 0, 0])],
}
# The pipeline blocks, the example-stream blocks and MoveNet.
from sleap_tpu_torch.data import dataset_ops as dso
from sleap_tpu_torch.data import inference as dinf
from sleap_tpu_torch.data.providers import LabelsReader
from sleap_tpu_torch.inference.movenet import MoveNetPredictor
from sleap_tpu_torch.ops.utils import match_points

chain = dso.Unbatcher().transform_dataset(dso.Prefetcher(buffer_size=2).transform_dataset(
    dso.Batcher(batch_size=2).transform_dataset(dso.Shuffler(seed=0, buffer_size=2).transform_dataset(
        LabelsReader(labels=dm)))))
blocks_td = sleap_tpu_torch.load_model([centroid, instance], device="cpu", params={centroid: c_params, instance: i_params})
stream = [{"image": frames}]
for block in (dinf.ModelPredictor(model=blocks_td.centroid_model, model_input_keys="image",
                                  model_output_keys="cms", device="cpu"),
              dinf.LocalPeakFinder(confmaps_key="cms", confmaps_stride=4, device="cpu")):
    stream = block.transform_dataset(stream)
(peaks,) = list(stream)
movenet_labels = MoveNetPredictor.from_trained_models(
    "lightning", model_path=lambda img: np.full((1, 1, 17, 3), 0.5, np.float32), device="cpu").predict(frames)
result["slice"] = {
    "chain_frames": sorted(int(ex["frame_ind"]) for ex in chain),
    "frames": [lf.frame_idx for lf in dm.labeled_frames],
    "peaks": [len(peaks["predicted_centroids"]), peaks["cms"].shape[-1]],
    "movenet": [len(movenet_labels), movenet_labels[0].instances[0].numpy()[0].tolist()],
    "match": [a.tolist() for a in match_points(np.array([[0.0, 0.0], [9.0, 9.0]]), np.array([[9.0, 8.0]]))],
}

# The optional packages' gates, and what needs none of them.
from sleap_tpu_torch import diagnostic, message, nn_viz, prefs, util
from sleap_tpu_torch.inference.movenet import load_local_movenet
from sleap_tpu_torch.training.callbacks import ProgressReporterZMQ
from sleap_tpu_torch.info.feature_suggestions import FeatureSuggestionPipeline
from sleap_tpu_torch.io.hdf5 import Writer as H5Writer

prefs.Preferences._filename = os.path.join(tmp, "prefs", "preferences.yaml")  # never the real home
gates = {}
for name, call in (
    ("nwb", lambda: dm.export_nwb(os.path.join(tmp, "dm.nwb"))),
    ("load_nwb", lambda: Labels.load_nwb(os.path.join(tmp, "dm.nwb"), device="cpu")),
    ("nix", lambda: dm.export_nix(os.path.join(tmp, "dm.nix"))),
    ("suggestions", lambda: FeatureSuggestionPipeline(per_video=3, n_clusters=2).get_suggestion_frames([dm_video])),
    ("zmq", lambda: message.PairedSender("tcp://127.0.0.1:1").setup()),
    ("prefs_save", lambda: prefs.Preferences().save()),
    ("viz", lambda: nn_viz.generate_skeleton_preview_image(np.zeros((2, 2)))),
    ("movenet_saved_model", lambda: load_local_movenet(os.path.join(tmp, "movenet"))),
    ("zmq_progress", lambda: ProgressReporterZMQ("tcp://127.0.0.1:1")),
):
    try:
        call()
        gates[name] = "ran"
    except ImportError as e:
        gates[name] = str(e)
with H5Writer(os.path.join(tmp, "dict.h5")) as w:
    util.save_dict_to_hdf5(w, "d", {"a": np.arange(3), "b": {"c": ["x", "y"]}})
result["gates"] = {
    **gates,
    "prefs_read": prefs.Preferences()["marker size"],
    "hdf5": sorted(util.read_hdf5_group(os.path.join(tmp, "dict.h5"), "d")),
    "summary": diagnostic.system_summary().splitlines()[0],
}
result["blocked_loaded"] = sorted(m for m, mod in sys.modules.items()
                                  if mod is not None and m.split(".")[0] in BLOCKED)
print(json.dumps(result))
"""


@pytest.fixture(scope="module")
def standalone(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run_folders")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, ",".join(BLOCKED), str(tmp)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_with_the_jax_side_blocked(standalone):
    modules = standalone["modules"]
    for name in ("config", "core.skeleton", "core.labels", "core.instance", "io.video",
                 "io.keras_h5", "io.zstd", "io.ocdbt", "io.orbax", "data.providers",
                 "data.prefetch", "models.heads", "inference.predictors",
                 "inference.bottomup", "inference.multiclass", "ops.identity",
                 "ops.cuda_peaks", "ops.optical_flow", "tracking", "tracking.components",
                 "tracking.kalman", "tracking.tracker", "training.trainer",
                 "training.losses", "training.optimizers", "data.augmentation",
                 "ops.confmaps", "ops.edge_maps", "io.hdf5", "io.png", "io.jpeg",
                 "io.dirimgstore", "io.slp", "inference.export", "cli.export", "io.pathutils",
                 "info.align", "info.metrics", "info.suggestions", "info.summary",
                 "info.trackcleaner", "io.formats.ndx_pose", "io.formats.nix",
                 "info.feature_suggestions", "util", "system", "prefs", "message", "diagnostic",
                 "data.inference", "data.pipelines", "data.dataset_ops", "data.utils", "ops.utils",
                 "inference.movenet", "training.callbacks", "nn_viz", "parallel", "parallel.mesh",
                 "parallel.distributed", "io.avi", "io.mjpeg", "io.mp4", "io.mkv", "io.nvdec",
                 "io.yuv"):
        assert f"sleap_tpu_torch.{name}" in modules
    assert standalone["blocked_loaded"] == []


@pytest.mark.parametrize("gate,package", [("nwb", "pynwb"), ("load_nwb", "pynwb"), ("nix", "nixio"),
                                          ("suggestions", "scikit-learn"), ("zmq", "pyzmq"),
                                          ("viz", "matplotlib"), ("movenet_saved_model", "tensorflow"),
                                          ("zmq_progress", "pyzmq"),
                                          ("prefs_save", "PyYAML")])
def test_optional_packages_are_named_with_the_jax_side_blocked(standalone, gate, package):
    gates = standalone["gates"]
    assert package in gates[gate]
    assert gates["prefs_read"] == 4
    assert gates["hdf5"] == ["d/a", "d/b/c"]
    assert gates["summary"].startswith("sleap-tpu-torch version: ")


@pytest.mark.parametrize("path", ["topdown", "bottomup"])
def test_load_model_and_predict_labels_with_the_jax_side_blocked(standalone, path):
    res = standalone[path]
    assert res["predictor"] == {"topdown": "TopDownPredictor", "bottomup": "BottomUpPredictor"}[path]
    assert res["labels"] and res["frames"] == [True] * 3
    assert res["frame_inds"] == [0, 1, 2]
    assert res["instances"] == res["want_instances"]
    assert sum(res["instances"]) >= 2 and res["all_predicted"]
    assert res["node_names"] == [[f"n{i}" for i in range(13)]]
    assert res["finite_points"] >= 4
    assert res["n_videos"] == 1 and res["provenance"] == res["predictor"]


@pytest.mark.parametrize("path,predictor,tracks", [
    ("trained_single", "SingleInstancePredictor", []),
    ("trained_multiclass", "TopDownMultiClassPredictor", ["female", "male"]),
])
def test_trained_folders_load_without_params_with_the_jax_side_blocked(
        standalone, path, predictor, tracks):
    res = standalone[path]
    assert res["predictor"] == predictor
    assert res["labels"] and res["n_frames"] == 3
    assert res["tracks"] == tracks


@pytest.mark.parametrize("path", ["tracked_topdown", "tracked_single"])
def test_flow_tracking_with_the_jax_side_blocked(standalone, path):
    res = standalone[path]
    assert res["tracker"] == "FlowCandidateMaker" and res["device"] == "cpu"
    assert res["instances"] >= 3 and res["all_tracked"]
    assert res["tracks"] and res["tracks"][0] == "track_0"
    assert res["exports"] == ["Tracker", "retrack", "run_tracker"]


def test_train_then_predict_with_the_jax_side_blocked(standalone):
    res = standalone["trained_here"]
    assert res["trainer"] == "CentroidTrainer" and res["epochs"] == 1
    assert {"best_model.pt", "training_config.json", "initial_config.json",
            "training_log.csv"} <= set(res["files"])
    assert res["predictor"] == "TopDownPredictor"
    assert res["n_valid"] == 3 and res["labels"] == "Labels"
    assert [shape[-1] for shape in res["centroid_shapes"]] == [2, 2]


_EXPORT_SCRIPT = """
import contextlib, io, json, os, sys

# torch.export's own imports come first: its partitioner imports networkx,
# a dependency of torch, not of the port. Those stay; the rest is blocked.
import torch.export._trace

BLOCKED = set(sys.argv[1].split(",")) - {m.split(".")[0] for m in sys.modules}
for name in BLOCKED:
    sys.modules[name] = None

import numpy as np
import torch

from sleap_tpu_torch.cli import export as export_cli
from sleap_tpu_torch.inference.export import load_exported_model

torch.set_num_threads(1)
exported = os.path.join(sys.argv[2], "exported")
with contextlib.redirect_stdout(io.StringIO()):
    export_cli.main(["-m", os.path.join(".convergence_runs", "minimal_robot.UNet.single_instance"),
                     "-e", exported, "--cpu", "--batch_size", "1", "--image_size", "64"])
out = load_exported_model(exported)(np.zeros((1, 64, 64, 3), np.uint8))
print(json.dumps({
    "files": sorted(os.listdir(exported)),
    "outputs": {k: list(v.shape) for k, v in out.items()},
    "blocked": sorted(BLOCKED),
    "blocked_loaded": sorted(m for m, mod in sys.modules.items()
                             if mod is not None and m.split(".")[0] in BLOCKED),
}))
"""


def test_export_with_the_jax_side_blocked(tmp_path):
    """``sleap-export`` on the CPU in a fresh interpreter with the JAX side
    blocked (all but what torch.export itself imports first), and the
    program loaded back and run."""
    out = subprocess.run(
        [sys.executable, "-c", _EXPORT_SCRIPT, ",".join(BLOCKED), str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["files"] == ["info.json", "model.pt2"]
    assert res["outputs"] == {"instance_peaks": [1, 2, 2], "instance_peak_vals": [1, 2]}
    assert {"sleap_tpu", "jax", "h5py", "cv2"} <= set(res["blocked"])
    assert res["blocked_loaded"] == []


def test_cli_writes_slp_with_the_jax_side_blocked(standalone):
    import h5py
    import numpy as np

    from sleap_tpu.io.slp import read_labels

    res = standalone["cli"]
    assert res["predictor"] == "TopDownPredictor" and res["frames"] == list(range(8))
    assert sum(len(points) for points in res["points"]) >= 8
    ref = read_labels(res["path"])
    assert [lf.frame_idx for lf in ref] == res["frames"]
    for lf, points in zip(ref, res["points"]):
        got = np.array(points).reshape(-1, 2, 2)
        want = np.array([i.numpy() for i in lf.instances]).reshape(-1, 2, 2)
        np.testing.assert_array_equal(got, want)
    with h5py.File(res["path"], "r") as f:
        assert len(f["frames"]) == 8 and len(f["pred_points"]) == 2 * len(f["instances"])


def test_cli_trains_scores_and_inspects_two_sizes_with_the_jax_side_blocked(standalone):
    res = standalone["cli_train"]
    assert res["sizes"] == [[72, 72], [96, 96]]
    assert {"best_model.pt", "training_config.json", "training_log.csv", "labels_gt.train.slp",
            "labels_gt.val.slp", "labels_pr.train.slp", "labels_pr.val.slp",
            "metrics.train.npz", "metrics.val.npz"} <= set(res["files"])
    for keys in res["metrics"].values():
        assert {"oks.mOKS", "oks_voc.mAP", "dist.avg", "pck.mPCK", "vis.tp"} <= set(keys)
    folder, project = res["inspect"]["folder"], res["inspect"]["project"]
    assert "  head: centered_instance" in folder and "  epochs trained: 1" in folder
    assert project.startswith("Labeled frames: 7\nTracks: 0\nVideo files: 2\n")


def test_frames_in_and_out_with_the_jax_side_blocked(standalone):
    res = standalone["frames_io"]
    assert res["package"] == [True, True]
    assert res["package_backends"] == ["HDF5Video", "HDF5Video"]
    assert res["imgstore"]
    stills = json.loads((REPO / "tests" / "torch_data" / "jpeg" / "decoded.json").read_text())
    small = [n for n, want in stills["stills"].items() if "sha256" in want and "1024" not in n]
    assert sorted(res["jpeg"]) == sorted(small) and all(res["jpeg"].values())
    render = res["render"]
    assert render["chunks"] == render["want"] > 0 and render["shape"] == render["want_shape"]


def test_bmp_and_tiff_in_and_out_with_the_jax_side_blocked(standalone):
    """With cv2 blocked: the committed BMP and TIFF stills decode to cv2's
    recorded frames on the CPU routes, and a TIFF training package and BMP
    and TIFF ImgStores are written and read back bitwise."""
    res = standalone["bmp_tiff"]
    record = json.loads((REPO / "tests" / "torch_data" / "stills" / "decoded.json").read_text())
    small = [n for n, want in record["stills"].items() if "sha256" in want and "1024" not in n]
    assert sorted(res["stills"]) == sorted(small) and all(res["stills"].values())
    assert res["written"] == {"package": [True, True], "bmp": True, "tif": True}


def test_slice_modules_run_with_the_jax_side_blocked(standalone):
    res = standalone["slice"]
    assert res["chain_frames"] == sorted(res["frames"])
    assert res["peaks"][0] >= 2 and res["peaks"][1] == 1
    assert res["movenet"] == [3, [48.0, 48.0]]
    assert res["match"] == [[1], [0]]


def test_data_model_convert_and_dlc_with_the_jax_side_blocked(standalone):
    res = standalone["data_model"]
    assert res["numpy_shape"] == [6, 2, 2, 2] and res["numpy_equal"]
    assert res["cleared"] == [0, True]
    assert res["swapped"] == [["t1", "t0"], ["t1", "t0"], ["t0", "t1"], ["t0"]]
    assert res["described"] == ["Frames (user/predicted): 0/4", "Instances (user/predicted): 0/7"]
    assert res["h5_keys"] == sorted(["edge_inds", "edge_names", "instance_scores", "labels_path", "node_names",
                                     "point_scores", "provenance", "track_names", "track_occupancy", "tracks",
                                     "tracking_scores", "video_ind", "video_path"])
    assert res["analysis_equal"] and res["csv_lines"] == 8
    assert res["dlc"] == [3, ["a", "b"], [[1.5, 2.0], [3.0, 5.0]], 80]


def test_entry_points_default_to_the_card():
    for fn in (tp.load_model, tp.load_trained_model, tp.Predictor.from_model_paths,
               tracker.Tracker.make_tracker_by_name):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert tracker.FlowCandidateMaker().device == "cuda"
    for cls in (tp.SingleInstancePredictor, tp.TopDownPredictor, tb.BottomUpPredictor,
                tm.BottomUpMultiClassPredictor, tm.TopDownMultiClassPredictor, MoveNetPredictor):
        device = next(f for f in cls.__dataclass_fields__.values() if f.name == "device")
        assert device.default_factory() == torch.device("cuda"), cls


def test_entry_points_without_a_card_raise_instead_of_falling_back():
    if torch.cuda.is_available():
        return  # the card is there, and the default is the right device
    folder = str(REPO / ".convergence_runs" / "minimal_robot.UNet.single_instance")
    config = TrainingJobConfig.load_json(folder)
    model = Model.from_config(config.model, skeleton=config.data.labels.skeletons[0])
    params = {folder: flax_from_state_dict(model.make_module(1))}
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tp.load_model(folder, params=params)


@pytest.mark.parametrize("path", ["clip.slp", "clip.mp4"])
def test_slp_and_media_paths_are_not_read_yet(path, tmp_path, monkeypatch):
    """What needs a package that is not installed raises, naming it: a
    ``.slp`` whose video is an ImgStore of video-file chunks (loopbio's
    imgstore reads those; a directory store of images is read without
    it), and a media file on a machine without cv2."""
    if path.endswith(".slp"):
        import h5py

        store = tmp_path / "store"
        store.mkdir()
        (store / "metadata.yaml").write_text(
            "__store:\n  chunksize: 100\n  class: VideoImgStore\n  format: mjpeg/avi\n")
        shutil.copy(REPO / "tests" / "torch_data" / "raw.slp", tmp_path / path)
        with h5py.File(tmp_path / path, "r+") as f:
            del f["videos_json"]
            f["videos_json"] = [json.dumps({"backend": {"type": "ImgStoreVideo",
                                                        "filename": str(store)}}).encode()]
        monkeypatch.setitem(sys.modules, "imgstore", None)
        with pytest.raises(ImportError, match="VideoImgStore.*imgstore package"):
            tp._make_provider(str(tmp_path / path), device="cpu")
        return
    (tmp_path / path).write_bytes(b"")
    monkeypatch.setitem(sys.modules, "cv2", None)
    provider = tp._make_provider(str(tmp_path / path), device="cpu")
    with pytest.raises(ImportError, match="clip.mp4 needs cv2"):
        next(iter(provider))


@pytest.mark.parametrize("path", ["clip.slp", "clip.mp4"])
def test_slp_and_media_paths_are_read(path, tmp_path):
    """Paths are read: a missing ``.slp`` raises, and a media file is
    opened (with cv2, imported then) only when a frame is read."""
    if path.endswith(".slp"):
        with pytest.raises(FileNotFoundError):
            tp._make_provider(str(tmp_path / path))
        return
    provider = tp._make_provider(str(tmp_path / path))
    assert type(provider.video.backend).__name__ == "MediaVideo"
    with pytest.raises(FileNotFoundError, match="clip.mp4"):
        next(iter(provider))
