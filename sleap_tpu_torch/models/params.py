"""Weights carried across: flax variables trees and Keras weights -> ``state_dict``.

Both sources are numpy and keyed by layer name, and the torch module keys its
layers by the same names (``backbone.layers.<name>``, ``heads.<name>``), so the
mapping is by name. Every target is filled, every shape is checked, and any
source weight left unused raises: a loud failure beats silently mixed weights.

A flax tree is either a ``params`` tree or the variables
``{"params": ..., "batch_stats": ...}``; the backbone's layers sit under its
flax name (``backbone`` for block-stack backbones, ``backbone_module`` for
the ResNet, HRNet and pretrained-encoder modules) and each head at the top.

Layouts:
- Conv kernels are HWIO in flax and Keras, OIHW in torch. A grouped or
  depthwise kernel is HWIO with I = in / groups, and flax orders its output
  channels group-major as torch does, so it takes the same transpose.
- Flax ``ConvTranspose`` kernels are HWIO and used unflipped on the dilated
  input; ``ConvTransposeSame`` takes them flipped in both spatial axes, in
  (in, out, kh, kw) layout.
- Keras ``Conv2DTranspose`` kernels are (kh, kw, out, in) with gradient-of-
  conv semantics; flax's kernel is their transpose, flipped
  (``sleap_tpu.io.keras_h5``), so they arrive at torch's layout without a flip.
- Dense kernels (the class-vector head's ``pre_classification{i}_fc`` layers
  and its output layer) are (in, out) in flax and Keras, and
  ``Linear.weight`` is (out, in).
- Batch norm: flax params ``scale``/``bias`` (Keras ``gamma``/``beta``) are
  ``weight``/``bias``; flax ``batch_stats`` ``mean``/``var`` (Keras
  ``moving_mean``/``moving_variance``) are ``running_mean``/``running_var``
  of :class:`~sleap_tpu_torch.models.encoder_decoder.FlaxBatchNorm2d`, which
  keeps no batch count (flax has none).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import ConvTransposeSame, FlaxBatchNorm2d

_BACKBONE_KEYS = ("backbone", "backbone_module")

# torch parameter or buffer -> (collection, leaf name) per layer kind and source.
_FLAX = {
    "conv": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "bn": {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")},
}
_KERAS = {
    "conv": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "bn": {"weight": ("params", "gamma"), "bias": ("params", "beta"),
           "running_mean": ("params", "moving_mean"),
           "running_var": ("params", "moving_variance")},
}


def _torch_kernel(w: np.ndarray, transposed: bool, keras: bool) -> np.ndarray:
    if not transposed:
        return w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if keras:
        w = w.transpose(0, 1, 3, 2)[::-1, ::-1]  # Keras -> flax HWIO
    return w[::-1, ::-1].transpose(2, 3, 0, 1)  # flip, -> (in, out, kh, kw)


def _flax_kernel(w: np.ndarray, layer: nn.Module) -> np.ndarray:
    if isinstance(layer, nn.Linear):
        return w.T
    if isinstance(layer, ConvTransposeSame):
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _split(key: str) -> Tuple[str, str, str]:
    """``state_dict`` key -> (module path, layer name, parameter name)."""
    mod_path, _, pname = key.rpartition(".")
    return mod_path, mod_path.rsplit(".", 1)[-1], pname


def _state_dict_from_layers(
    module: nn.Module, layers: Mapping[str, Mapping[str, Mapping[str, Any]]], keras: bool
) -> Dict[str, torch.Tensor]:
    """``layers`` maps a collection (``params``, ``batch_stats``) to
    {layer name: {leaf name: array}}."""
    names = _KERAS if keras else _FLAX
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for key, target in module.state_dict().items():
        mod_path, lname, pname = _split(key)
        layer = module.get_submodule(mod_path)
        kind = "bn" if isinstance(layer, FlaxBatchNorm2d) else "conv"
        collection, src_name = names[kind][pname]
        group = layers.get(collection, {})
        if lname not in group or src_name not in group[lname]:
            raise KeyError(
                f"No source weight {collection}/{lname}/{src_name} for {key}."
            )
        w = np.asarray(group[lname][src_name], np.float32)
        if pname == "weight" and kind == "conv":
            if isinstance(layer, nn.Linear):
                w = w.T
            else:
                w = _torch_kernel(w, isinstance(layer, ConvTransposeSame), keras)
        if tuple(w.shape) != tuple(target.shape):
            raise ValueError(
                f"Shape mismatch at {key}: source {tuple(w.shape)} vs torch {tuple(target.shape)}."
            )
        out[key] = torch.from_numpy(np.array(w))  # a writable, contiguous copy
        used.add((collection, lname, src_name))
    leftover = sorted(
        (col, lname, wname) for col, group in layers.items()
        for lname, ws in group.items() for wname in ws
        if (col, lname, wname) not in used
    )
    if leftover:
        raise ValueError(f"Source weights not used by the module: {leftover}.")
    return out


def flax_layers(tree: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A flax collection tree -> {layer name: leaves}, the backbone's layers
    lifted from under its flax name beside the heads."""
    layers: Dict[str, Any] = {}
    for key in _BACKBONE_KEYS:
        layers.update(tree.get(key, {}))
    for name, ws in tree.items():
        if name in _BACKBONE_KEYS:
            continue
        if name in layers:
            raise ValueError(f"Layer {name!r} is both a backbone layer and a head.")
        layers[name] = ws
    return layers


def is_variables(tree: Mapping[str, Any]) -> bool:
    """Whether ``tree`` is flax variables (``params`` and maybe
    ``batch_stats``) rather than a bare ``params`` tree."""
    return "params" in tree and set(tree) <= {"params", "batch_stats"}


def state_dict_from_flax(module: nn.Module, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax tree (numpy leaves) -> ``state_dict``: the variables
    ``{"params", "batch_stats"}``, or a bare ``params`` tree for a module
    without batch norm."""
    if not is_variables(tree):
        tree = {"params": tree}
    layers = {col: flax_layers(sub) for col, sub in tree.items()}
    return _state_dict_from_layers(module, layers, keras=False)


def flax_variables_from_state_dict(module: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_flax`: a module's weights as
    flax variables ``{"params": ..., "batch_stats": ...}`` of float32 numpy
    arrays (``batch_stats`` empty without batch norm), the form
    ``load_model(params=...)`` takes.

    Conv kernels go OIHW -> HWIO; ``ConvTransposeSame`` kernels
    (in, out, kh, kw) go back to flax's HWIO, flipped in both spatial axes;
    dense kernels go (out, in) -> (in, out). Backbone layers sit under the
    backbone's flax name, each head at the top level.
    """
    backbone = getattr(module, "backbone", None)
    bname = getattr(backbone, "flax_name", "backbone")
    tree: Dict[str, Dict[str, Any]] = {"params": {bname: {}}, "batch_stats": {}}
    for key, value in module.state_dict().items():
        mod_path, lname, pname = _split(key)
        layer = module.get_submodule(mod_path)
        kind = "bn" if isinstance(layer, FlaxBatchNorm2d) else "conv"
        collection, leaf = _FLAX[kind][pname]
        w = value.detach().float().cpu().numpy()
        if kind == "conv" and pname == "weight":
            w = _flax_kernel(w, layer)
        group = tree[collection]
        if mod_path.startswith("backbone."):
            group = group.setdefault(bname, {})
        group.setdefault(lname, {})[leaf] = np.ascontiguousarray(w)
    return tree


def flax_from_state_dict(module: nn.Module) -> Dict[str, Any]:
    """A module's weights as a flax ``params`` tree (see
    :func:`flax_variables_from_state_dict`); enough for a module without
    batch norm."""
    return flax_variables_from_state_dict(module)["params"]


def state_dict_from_keras(
    module: nn.Module, weights: Mapping[str, Mapping[str, np.ndarray]]
) -> Dict[str, torch.Tensor]:
    """``sleap_tpu.io.keras_h5.read_keras_weights`` output -> ``state_dict``."""
    return _state_dict_from_layers(module, {"params": weights}, keras=True)
