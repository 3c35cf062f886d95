"""An inventory of the JAX package's public API against the port's, read
from the source with ``ast`` (nothing is imported): every public
module-level function, class and assigned name, and every public method,
property, class attribute and ``self.<name>`` attribute of each class, of
every ``sleap_tpu`` module that has a ``sleap_tpu_torch`` module of the
same path (``config/__init__.py`` is ``config.py``). The port must have
each one, except the names listed in :data:`EXCLUDED`, each with its
reason; a JAX module with no port counterpart must be in
:data:`UNPORTED_MODULES` with the ROADMAP item that brings it. An
exclusion the port no longer needs fails the test too, so the lists stay
the count of what is missing."""

from __future__ import annotations

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "sleap_tpu")
PORT_ROOT = os.path.join(REPO, "sleap_tpu_torch")

TPU_ONLY = "a TPU-only form of the same math (ROADMAP.md North star: leave the TPU-only forms behind)"
FLAX = "a field of the flax module; the port's torch.nn.Module carries its weights through models/params"
ITEM_13 = "ROADMAP.md queue 1, item 13 (open): public names still missing from ported modules"

EXCLUDED = {
    "__init__.py": {
        "disable_preallocation": "JAX's device memory preallocation switch; torch allocates on demand",
        "use_cpu_only": "JAX's platform switch; the port's entry points take device=",
        "load_config": ITEM_13,
        "system_summary": "ROADMAP.md queue 1, item 13 (open): system.py",
    },
    "version.py": {"versions": "ROADMAP.md queue 1, item 13 (open): system.py"},
    "config/__init__.py": {
        "BackboneConfig.which_oneof": ITEM_13,
        "BackboneConfig.which_oneof_attrib_name": ITEM_13,
        "HeadsConfig.which_oneof": ITEM_13,
        "HeadsConfig.which_oneof_attrib_name": ITEM_13,
    },
    "data/augmentation.py": {"augment_example": "the JAX trainer's per-example augmentation; the port's "
                                                "trainer augments whole batches (training/trainer.py)"},
    "data/normalization.py": {n: ITEM_13 for n in ("convert_rgb_to_bgr", "ensure_int", "ensure_min_image_rank",
                                                   "scale_image_range")},
    "data/providers.py": {n: ITEM_13 for n in ("LabelsReader.from_user_instances",
                                               "LabelsReader.is_from_multi_size_videos",
                                               "LabelsReader.user_instances_only")},
    "data/resizing.py": {n: ITEM_13 for n in (
        "PointsRescaler", "PointsRescaler.input_keys", "PointsRescaler.invert", "PointsRescaler.output_keys",
        "PointsRescaler.points_key", "PointsRescaler.scale_key", "PointsRescaler.transform_dataset",
        "resize_and_pad_to_target")},
    "inference/bottomup.py": {
        "CHANNELS_FIRST_CONFMAPS": TPU_ONLY,
        **{f"BottomUpPredictor.{n}": ITEM_13 for n in (
            "batch_size", "bottomup_config", "from_trained_models", "integral_patch_size",
            "integral_refinement", "peak_threshold", "tracker")},
    },
    "inference/multiclass.py": {
        **{f"BottomUpMultiClassPredictor.{n}": ITEM_13 for n in (
            "batch_size", "classes", "config", "from_trained_models", "integral_patch_size",
            "integral_refinement", "peak_threshold", "tracker")},
        **{f"TopDownMultiClassPredictor.{n}": ITEM_13 for n in (
            "batch_size", "centroid_config", "classes", "confmap_config", "confmap_model",
            "from_trained_models", "integral_patch_size", "integral_refinement", "max_instances",
            "peak_threshold", "tracker")},
    },
    "inference/predictors.py": {
        "Predictor.report_rate": ITEM_13,
        **{f"{c}.{n}": ITEM_13 for c, names in (
            ("SingleInstancePredictor", ("batch_size", "confmap_config", "from_trained_models",
                                         "integral_patch_size", "integral_refinement", "peak_threshold",
                                         "tracker")),
            ("TopDownPredictor", ("batch_size", "centroid_config", "confmap_config", "from_trained_models",
                                  "integral_patch_size", "integral_refinement", "peak_threshold", "tracker")),
            ("TrainedModel", ("config", "input_channels", "model", "variables")),
        ) for n in names},
        **{n: "ROADMAP.md queue 1, item 13 (open): VisualPredictor" for n in (
            "VisualPredictor", "VisualPredictor.batch_size", "VisualPredictor.config",
            "VisualPredictor.from_trained_models", "VisualPredictor.head_specific_output_keys",
            "VisualPredictor.model", "VisualPredictor.predict")},
    },
    "io/keras_h5.py": {"load_keras_weights_into_variables": "fills flax variables; the port loads Keras "
                                                           "weights into a state_dict (models/params)"},
    "models/encoder_decoder.py": {
        **{n: TPU_ONLY for n in ("FOLD_S2D_STEM", "FUSED_UP_MAX", "FUSED_UP_MIN", "conv_over_s2d",
                                 "fold_s2d_kernel", "fused_up2_conv", "EncoderDecoderNet.fold_s2d_stem")},
        "EncoderDecoderNet.compute_dtype": FLAX,
    },
    "models/heads.py": {f"{c}.{n}": ITEM_13 for c, names in (
        ("CenteredInstanceConfmapsHead", ("anchor_part", "loss_weight", "output_stride", "sigma")),
        ("CentroidConfmapsHead", ("anchor_part", "loss_weight", "output_stride", "sigma")),
        ("ClassMapsHead", ("loss_weight", "output_stride", "sigma")),
        ("ClassVectorsHead", ("loss_weight", "output_stride")),
        ("MultiInstanceConfmapsHead", ("loss_weight", "output_stride", "sigma")),
        ("OffsetRefinementHead", ("loss_weight", "output_stride", "sigma_threshold")),
        ("PartAffinityFieldsHead", ("loss_weight", "output_stride", "sigma")),
        ("SingleInstanceConfmapsHead", ("loss_weight", "output_stride", "sigma")),
    ) for n in names},
    "models/hrnet.py": {"HigherHRNetModule.compute_dtype": FLAX},
    "models/leap.py": {"LeapCNN.stem_stride": FLAX},
    "models/model.py": {
        **{n: FLAX for n in (
            "BackboneWithHeads.backbone_module", "BackboneWithHeads.backbone_output_stride",
            "BackboneWithHeads.compute_dtype", "BackboneWithHeads.head_specs", "Model.make_flax_module",
            "PoseNet.backbone_output_stride", "PoseNet.decoder_blocks", "PoseNet.encoder_blocks",
            "PoseNet.stem_blocks", "apply_heads")},
        **{n: TPU_ONLY for n in ("BackboneWithHeads.channels_first_heads", "PoseNet.channels_first_heads",
                                 "PoseNet.fold_s2d_stem")},
        "Model.head_names": ITEM_13,
    },
    "models/pretrained_encoder.py": {n: FLAX for n in (
        "UnetPretrainedEncoder.down_blocks", "UnetPretrainedEncoder.up_blocks",
        "UnetPretrainedEncoderModule.compute_dtype")},
    "models/resnet.py": {"ResNetV1Module.compute_dtype": FLAX},
    "models/unet.py": {"UNet.fold_s2d_stem": TPU_ONLY, "UNet.stem_stride": FLAX},
    "ops/lap.py": {"batched_solve_lap": ITEM_13},
    "ops/paf_grouping.py": {n: ITEM_13 for n in ("PAFScorer.group_sample", "PAFScorer.predict",
                                                 "assign_connections_to_instances", "make_predicted_instances")},
    "ops/peak_finding.py": {
        "FORCE_XLA_PEAKS": TPU_ONLY,
        **{n: ITEM_13 for n in ("crop_bboxes", "flatten_local_peaks", "integral_regression",
                                "make_gaussian_kernel", "smooth_imgs")},
    },
    "tracking/components.py": {"FrameMatches.has_only_first_choice_matches": ITEM_13},
    "tracking/kalman.py": {n: ITEM_13 for n in ("BareKalmanTracker.has_stale_filters", "BareKalmanTracker.initialize",
                                                "BareKalmanTracker.reset_gap_size", "KalmanTracker.is_valid")},
    "tracking/tracker.py": {n: ITEM_13 for n in ("Tracker.is_valid", "Tracker.unique_tracks_in_queue",
                                                 "logger")},
    "training/trainer.py": {
        "Trainer.keras_model": "the JAX trainer's Keras export; the port writes best_model.pt",
        "Trainer.variables": FLAX,
        "Trainer.n_devices": "ROADMAP.md queue 1, item 12 (open): parallel",
        "Trainer.spatial_sharding": "ROADMAP.md queue 1, item 12 (open): parallel",
        "Trainer.head_config": ITEM_13,
    },
}

UNPORTED_MODULES = {
    "io/formats/ndx_pose.py": "ROADMAP.md queue 1, item 3f (NWB on the port's HDF5 writer)",
    "io/formats/nix.py": "ROADMAP.md queue 1, item 3f (NIX on the port's HDF5 writer)",
    "info/feature_suggestions.py": "ROADMAP.md queue 1, item 13b (open): image-feature suggestions",
    "util.py": ITEM_13,
    "system.py": ITEM_13,
    "prefs.py": ITEM_13,
    "message.py": ITEM_13,
    "diagnostic.py": ITEM_13,
    "io/videowriter.py": "ROADMAP.md queue 1, item 13 (open): needs a video encoder on the card",
    "io/visuals.py": "ROADMAP.md queue 1, item 13 (open): needs a video encoder on the card",
    "nn_viz.py": "ROADMAP.md queue 1, item 13 (open): needs matplotlib",
    "inference/movenet.py": "ROADMAP.md queue 1, item 10 (open): MoveNet",
    "data/inference.py": "ROADMAP.md queue 1, items 7 and 8 (open): pipeline blocks",
    "data/pipelines.py": "ROADMAP.md queue 1, items 7 and 8 (open): pipeline blocks",
    "data/dataset_ops.py": "ROADMAP.md queue 1, items 7 and 8 (open): pipeline blocks",
    "data/utils.py": "ROADMAP.md queue 1, items 7 and 8 (open): pipeline blocks",
    "ops/utils.py": "ROADMAP.md queue 1, items 7 and 8 (open): pipeline blocks",
    "training/callbacks.py": "ROADMAP.md queue 1, item 9 (open): training callbacks",
    "parallel/__init__.py": "ROADMAP.md queue 1, item 12 (open): parallel",
    "parallel/mesh.py": "ROADMAP.md queue 1, item 12 (open): parallel",
    "parallel/distributed.py": "ROADMAP.md queue 1, item 12 (open): parallel",
    "ops/pallas_peaks.py": "the Pallas kernels; their Hopper forms are csrc/peaks.cu behind ops/cuda_peaks.py",
    "ops/pallas_crops.py": "the Pallas kernel; its Hopper form is csrc/crops.cu behind ops/cuda_crops.py",
}

# This slice's modules: nothing of theirs may be excluded.
SLICE = ("core/", "io/video.py", "io/slp.py", "info/write_tracking_h5.py", "io/convert.py", "io/formats/")


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def _assigned(target) -> list:
    return [t.id for t in ast.walk(target) if isinstance(t, ast.Name)]


def inventory(path: str) -> set:
    """Public module-level names (functions, classes, assignments,
    ``Class.attr = ...``) and class members (methods, properties, class
    attributes, nested classes, ``self.<name>`` assignments), no imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()

    def members(cls: ast.ClassDef, prefix: str) -> None:
        for node in cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(f"{prefix}.{node.name}")
                for sub in ast.walk(node):
                    targets = sub.targets if isinstance(sub, ast.Assign) else \
                        [sub.target] if isinstance(sub, ast.AnnAssign) else []
                    for target in targets:
                        for t in ast.walk(target):
                            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                names.add(f"{prefix}.{t.attr}")
            elif isinstance(node, ast.ClassDef):
                names.add(f"{prefix}.{node.name}")
                members(node, f"{prefix}.{node.name}")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                    names.update(f"{prefix}.{n}" for n in _assigned(target))

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members(node, node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name):
                    names.add(f"{target.value.id}.{target.attr}")
                else:
                    names.update(_assigned(target))
    return {n for n in names if _public(n)}


def _jax_modules() -> list:
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT).replace(os.sep, "/"))
    return sorted(out)


def _port_path(rel: str) -> str:
    return os.path.join(PORT_ROOT, "config.py" if rel == "config/__init__.py" else rel)


PORTED = [rel for rel in _jax_modules() if os.path.exists(_port_path(rel))]


@pytest.mark.parametrize("rel", PORTED)
def test_port_has_the_public_api_of_the_jax_module(rel):
    missing = inventory(os.path.join(JAX_ROOT, rel)) - inventory(_port_path(rel))
    excluded = EXCLUDED.get(rel, {})
    assert sorted(missing - set(excluded)) == [], f"{rel}: names the port lacks"
    assert sorted(set(excluded) - missing) == [], f"{rel}: exclusions the port no longer needs"


def test_every_jax_module_is_ported_or_listed():
    unported = sorted(set(_jax_modules()) - set(PORTED))
    assert unported == sorted(UNPORTED_MODULES)


def test_exclusions_have_reasons_and_spare_this_slice():
    for rel, names in EXCLUDED.items():
        assert rel in PORTED, rel
        assert not rel.startswith(SLICE), f"{rel} is this slice's: nothing of it may be excluded"
        for name, reason in names.items():
            assert reason and len(reason) > 20, name
    for rel, reason in UNPORTED_MODULES.items():
        assert not rel.startswith(SLICE[:1]) and reason, rel
    slice_modules = [rel for rel in PORTED if rel.startswith(SLICE)]
    assert len(slice_modules) == 17, slice_modules


def test_the_inventory_sees_classes_members_and_attributes():
    names = inventory(os.path.join(JAX_ROOT, "core", "labels.py"))
    assert {"Labels", "Labels.numpy", "Labels.merge", "Labels.export_csv", "Labels.labeled_frames",
            "SuggestionFrame.frame_idx", "load_file"} <= names
    assert not any(n.startswith("_") or "._" in n for n in names)
