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
USE_CPU_ONLY = "JAX's platform switch; the port's entry points take device="
PREALLOCATION = "JAX's device memory preallocation switch; torch allocates on demand"
TRAINER_ONLY_IN_JAX = {
    "keras_model": "the JAX trainer's Keras export; the port writes best_model.pt",
    "variables": FLAX,
}
TRAINERS = ("Trainer", "SingleInstanceTrainer", "CentroidTrainer", "TopdownConfmapsTrainer", "BottomUpTrainer",
            "BottomUpMultiClassTrainer", "TopDownMultiClassTrainer")

EXCLUDED = {
    "__init__.py": {"disable_preallocation": PREALLOCATION, "use_cpu_only": USE_CPU_ONLY},
    "system.py": {"disable_preallocation": PREALLOCATION, "enable_gpu_memory_growth": PREALLOCATION,
                  "use_cpu_only": USE_CPU_ONLY},
    "diagnostic.py": {"use_cpu_only": USE_CPU_ONLY},
    "data/augmentation.py": {"augment_example": "the JAX trainer's per-example augmentation; the port's "
                                                "trainer augments whole batches (training/trainer.py)"},
    "inference/bottomup.py": {"CHANNELS_FIRST_CONFMAPS": TPU_ONLY},
    "io/keras_h5.py": {"load_keras_weights_into_variables": "fills flax variables; the port loads Keras "
                                                           "weights into a state_dict (models/params)"},
    "models/encoder_decoder.py": {
        **{n: TPU_ONLY for n in ("FOLD_S2D_STEM", "FUSED_UP_MAX", "FUSED_UP_MIN", "conv_over_s2d",
                                 "fold_s2d_kernel", "fused_up2_conv", "EncoderDecoderNet.fold_s2d_stem")},
        "EncoderDecoderNet.compute_dtype": FLAX,
    },
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
    },
    "models/pretrained_encoder.py": {n: FLAX for n in (
        "UnetPretrainedEncoder.down_blocks", "UnetPretrainedEncoder.up_blocks",
        "UnetPretrainedEncoderModule.compute_dtype")},
    "models/resnet.py": {"ResNetV1Module.compute_dtype": FLAX},
    "models/unet.py": {"UNet.fold_s2d_stem": TPU_ONLY, "UNet.stem_stride": FLAX},
    "ops/peak_finding.py": {"FORCE_XLA_PEAKS": TPU_ONLY},
    # Every trainer inherits these from the JAX Trainer.
    "training/trainer.py": {f"{c}.{n}": reason for c in TRAINERS for n, reason in TRAINER_ONLY_IN_JAX.items()},
}

UNPORTED_MODULES = {
    "ops/pallas_peaks.py": "the Pallas kernels; their Hopper forms are csrc/peaks.cu behind ops/cuda_peaks.py",
    "ops/pallas_crops.py": "the Pallas kernel; its Hopper form is csrc/crops.cu behind ops/cuda_crops.py",
}

# This slice's modules: nothing of theirs may be excluded.
SLICE = ("parallel/mesh.py", "parallel/distributed.py")
SLICE_SWITCHES: dict = {}


def _public(name: str) -> bool:
    return not any(part.startswith("_") for part in name.split("."))


def _assigned(target) -> list:
    return [t.id for t in ast.walk(target) if isinstance(t, ast.Name)]


_TREES: dict = {}


def _tree(path: str) -> ast.Module:
    if path not in _TREES:
        with open(path) as f:
            _TREES[path] = ast.parse(f.read())
    return _TREES[path]


def _package_root(path: str) -> str:
    """The outermost package folder that holds ``path``."""
    root = os.path.dirname(os.path.abspath(path))
    while os.path.exists(os.path.join(os.path.dirname(root), "__init__.py")):
        root = os.path.dirname(root)
    return root


def _module_file(root: str, dotted: str):
    """The file of module ``dotted`` of the package at ``root``, if any."""
    base = os.path.join(os.path.dirname(root), *dotted.split("."))
    for candidate in (os.path.join(base, "__init__.py"), base + ".py"):
        if os.path.exists(candidate):
            return candidate
    return None


def _bases(path: str, cls: ast.ClassDef) -> list:
    """(file, ClassDef) of each base of ``cls`` that is defined in its
    module or imported (``from <package>.x import Base``) from a module of
    the same package; other bases (the standard library's, torch's) are
    not followed."""
    tree = _tree(path)
    root = _package_root(path)
    local = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    imported = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module \
                and node.module.split(".")[0] == os.path.basename(root):
            for alias in node.names:
                imported[alias.asname or alias.name] = (node.module, alias.name)
    out = []
    for base in cls.bases:
        if not isinstance(base, ast.Name):
            continue
        if base.id in local:
            out.append((path, local[base.id]))
        elif base.id in imported:
            module, name = imported[base.id]
            other = _module_file(root, module)
            found = other and [n for n in _tree(other).body if isinstance(n, ast.ClassDef) and n.name == name]
            if found:
                out.append((other, found[0]))
    return out


def inventory(path: str) -> set:
    """Public module-level names (functions, classes, assignments,
    ``Class.attr = ...``, and the names ``__all__`` lists) and class members
    (methods, properties, class attributes, nested classes, ``self.<name>``
    assignments); other imports are not counted. A class has the members of
    its bases too, where a base is defined in the same module or imported
    from a module of the same package."""
    tree = _tree(path)
    names = set()

    def members(cls: ast.ClassDef, prefix: str, where: str, seen: frozenset = frozenset()) -> None:
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
                members(node, f"{prefix}.{node.name}", where)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                    names.update(f"{prefix}.{n}" for n in _assigned(target))
        for base_path, base in _bases(where, cls):
            key = (base_path, base.name)
            if key not in seen:
                members(base, prefix, base_path, seen | {key})

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members(node, node.name, path)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name):
                    names.add(f"{target.value.id}.{target.attr}")
                elif isinstance(target, ast.Name) and target.id == "__all__" \
                        and isinstance(node.value, (ast.List, ast.Tuple)):
                    # An imported name the module exports is its public API.
                    names.update(e.value for e in node.value.elts if isinstance(e, ast.Constant))
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
        if rel.startswith(SLICE):
            assert set(names) <= SLICE_SWITCHES.get(rel, set()), f"{rel} is this slice's: nothing of it may be excluded"
        for name, reason in names.items():
            assert reason and len(reason) > 20, name
    for rel, reason in UNPORTED_MODULES.items():
        assert not rel.startswith(SLICE) and reason, rel
    slice_modules = [rel for rel in PORTED if rel.startswith(SLICE)]
    assert len(slice_modules) == len(SLICE), slice_modules


def test_the_inventory_sees_classes_members_and_attributes():
    names = inventory(os.path.join(JAX_ROOT, "core", "labels.py"))
    assert {"Labels", "Labels.numpy", "Labels.merge", "Labels.export_csv", "Labels.labeled_frames",
            "SuggestionFrame.frame_idx", "load_file"} <= names
    assert not any(n.startswith("_") or "._" in n for n in names)


def test_the_inventory_sees_inherited_members(tmp_path):
    """A class has its bases' members, where the base is in the same module
    or imported from the same package; a name on neither still counts as
    missing."""
    predictors = inventory(_port_path("inference/predictors.py"))
    assert {"SingleInstancePredictor.batch_size", "SingleInstancePredictor.peak_threshold",
            "SingleInstancePredictor.tracker", "TopDownPredictor.report_rate"} <= predictors  # same module
    assert "SingleInstancePredictor.centroid_config" not in predictors
    bottomup = inventory(_port_path("inference/bottomup.py"))
    assert {"BottomUpPredictor.batch_size", "BottomUpPredictor.predict"} <= bottomup  # imported base
    heads = inventory(_port_path("models/heads.py"))
    assert {"CentroidConfmapsHead.output_stride", "CentroidConfmapsHead.loss_weight"} <= heads

    # A package of two modules: C gets x from Base (imported) and y from Mixin
    # (local); the reference's C.z is on neither, so it is missing.
    for pkg, body in (("pkg_a", "class C(Base, Mixin):\n    w = 0\n"),
                      ("pkg_b", "class C(Base, Mixin):\n    w = 0\n    z = 3\n")):
        root = tmp_path / pkg
        root.mkdir()
        (root / "__init__.py").write_text("")
        (root / "base.py").write_text("class Base:\n    x: int = 1\n\n    def _hidden(self):\n        pass\n")
        (root / "mod.py").write_text(f"from {pkg}.base import Base\n\n\nclass Mixin:\n    y = 2\n\n\n{body}")
    mine, ref = inventory(str(tmp_path / "pkg_a" / "mod.py")), inventory(str(tmp_path / "pkg_b" / "mod.py"))
    assert {"C.w", "C.x", "C.y"} <= mine and "C.z" not in mine
    assert ref - mine == {"C.z"}
