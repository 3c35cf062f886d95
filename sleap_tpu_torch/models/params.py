"""Weights carried across: flax params trees and Keras weights -> ``state_dict``.

Both sources are numpy and keyed by layer name, and the torch module keys its
layers by the same names (``backbone.layers.<name>``, ``heads.<name>``), so the
mapping is by name. Every target is filled, every shape is checked, and any
source weight left unused raises: a loud failure beats silently mixed weights.

Layouts:
- Conv kernels are HWIO in flax and Keras, OIHW in torch.
- Flax ``ConvTranspose`` kernels are HWIO and used unflipped on the dilated
  input; ``ConvTransposeSame`` takes them flipped in both spatial axes, in
  (in, out, kh, kw) layout.
- Keras ``Conv2DTranspose`` kernels are (kh, kw, out, in) with gradient-of-
  conv semantics; flax's kernel is their transpose, flipped
  (``sleap_tpu.io.keras_h5``), so they arrive at torch's layout without a flip.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from sleap_tpu_torch.models.encoder_decoder import ConvTransposeSame


def _torch_kernel(w: np.ndarray, transposed: bool, keras: bool) -> np.ndarray:
    if not transposed:
        return w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if keras:
        w = w.transpose(0, 1, 3, 2)[::-1, ::-1]  # Keras -> flax HWIO
    return w[::-1, ::-1].transpose(2, 3, 0, 1)  # flip, -> (in, out, kh, kw)


def _state_dict_from_layers(
    module: nn.Module, layers: Mapping[str, Mapping[str, Any]], keras: bool
) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for key, target in module.state_dict().items():
        mod_path, _, pname = key.rpartition(".")
        lname = mod_path.rsplit(".", 1)[-1]
        src_name = {"weight": "kernel", "bias": "bias"}[pname]
        if lname not in layers or src_name not in layers[lname]:
            raise KeyError(f"No source weight {src_name!r} for layer {lname!r} ({key}).")
        w = np.asarray(layers[lname][src_name], np.float32)
        if pname == "weight":
            transposed = isinstance(module.get_submodule(mod_path), ConvTransposeSame)
            w = _torch_kernel(w, transposed, keras)
        if tuple(w.shape) != tuple(target.shape):
            raise ValueError(
                f"Shape mismatch at {key}: source {tuple(w.shape)} vs torch {tuple(target.shape)}."
            )
        out[key] = torch.from_numpy(np.array(w))  # a writable, contiguous copy
        used.add((lname, src_name))
    leftover = sorted(
        (lname, wname) for lname, ws in layers.items() for wname in ws
        if (lname, wname) not in used
    )
    if leftover:
        raise ValueError(f"Source weights not used by the module: {leftover}.")
    return out


def state_dict_from_flax(module: nn.Module, params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``variables["params"]`` tree (numpy leaves) -> ``state_dict``.

    The tree holds the backbone's layers under ``"backbone"`` and each head's
    conv at the top level.
    """
    layers = dict(params.get("backbone", {}))
    for name, ws in params.items():
        if name == "backbone":
            continue
        if name in layers:
            raise ValueError(f"Layer {name!r} is both a backbone layer and a head.")
        layers[name] = ws
    return _state_dict_from_layers(module, layers, keras=False)


def state_dict_from_keras(
    module: nn.Module, weights: Mapping[str, Mapping[str, np.ndarray]]
) -> Dict[str, torch.Tensor]:
    """``sleap_tpu.io.keras_h5.read_keras_weights`` output -> ``state_dict``."""
    return _state_dict_from_layers(module, weights, keras=True)
