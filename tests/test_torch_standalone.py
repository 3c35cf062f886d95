"""The port runs without the JAX side: in a fresh interpreter whose imports of
``sleap_tpu``, ``jax``, ``flax``, ``orbax``, ``networkx``, ``attr``, ``h5py``,
``cv2``, ``zstandard`` and ``tensorstore`` fail, every module of
``sleap_tpu_torch`` imports, a run folder written by the port's own config
code loads through ``load_model``, trained ``.convergence_runs`` folders load
from their orbax checkpoints with no ``params``, and ``predict`` returns the
port's ``Labels``, with tracks when ``load_model`` is given
``tracker="flow"``. Also: the entry points default to the card, and paths the
port cannot read yet raise.
"""

import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.inference import bottomup as tb
from sleap_tpu_torch.inference import multiclass as tm
from sleap_tpu_torch.inference import predictors as tp
from sleap_tpu_torch.models.model import Model
from sleap_tpu_torch.models.params import flax_from_state_dict
from sleap_tpu_torch.tracking import tracker

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("sleap_tpu", "jax", "jaxlib", "flax", "orbax", "networkx", "attr", "attrs", "h5py", "cv2",
           "zstandard", "tensorstore")

_SCRIPT = r"""
import importlib, importlib.abc, json, os, pkgutil, sys

BLOCKED = set(sys.argv[1].split(","))


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import: {name}")
        return None


sys.meta_path.insert(0, Blocker())

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
result["blocked_loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
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
                 "tracking.kalman", "tracking.tracker"):
        assert f"sleap_tpu_torch.{name}" in modules
    assert standalone["blocked_loaded"] == []


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


def test_entry_points_default_to_the_card():
    for fn in (tp.load_model, tp.load_trained_model, tp.Predictor.from_model_paths,
               tracker.Tracker.make_tracker_by_name):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert tracker.FlowCandidateMaker().device == "cuda"
    for cls in (tp.SingleInstancePredictor, tp.TopDownPredictor, tb.BottomUpPredictor,
                tm.BottomUpMultiClassPredictor, tm.TopDownMultiClassPredictor):
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
def test_slp_and_media_paths_are_not_read_yet(path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tp._make_provider(path)
