"""Read Keras ``.h5`` weights (``best_model.h5`` of a reference run folder).

A copy of :func:`sleap_tpu.io.keras_h5.read_keras_weights`: layer names are
normalized to the port's (and flax's) layer names, modulo three cosmetic
differences of the Keras models:

- decoder blocks carry a ``_s{in}_to_s{out}`` stride infix;
- UNet middle blocks carry ``_middle_expand`` / ``_middle_contract`` infixes;
- head layers get a Keras uniquing suffix (``CentroidConfmapsHead_0``).

The file is read with the port's own HDF5 reader (:mod:`sleap_tpu_torch.io.hdf5`),
so no ``h5py`` is needed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from sleap_tpu_torch.io import hdf5

_STRIDE_INFIX = re.compile(r"_s\d+_to_s\d+")
_MIDDLE_INFIX = re.compile(r"_middle_(expand|contract)")
_HEAD_SUFFIX = re.compile(r"^(?P<head>[A-Za-z]+Head)_\d+$")


def _canonical(layer_name: str) -> str:
    """A Keras layer name as the port's layer name."""
    name = _STRIDE_INFIX.sub("", layer_name)
    name = _MIDDLE_INFIX.sub("", name)
    m = _HEAD_SUFFIX.match(name)
    if m:
        name = m.group("head")
    return name


def read_keras_weights(h5_path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """``{layer name: {weight name: array}}`` from a Keras ``.h5`` file."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with hdf5.File(h5_path) as f:
        grp = f["model_weights"] if "model_weights" in f else f
        layer_names = [
            n.decode() if isinstance(n, bytes) else n for n in grp.attrs.get("layer_names", [])
        ]
        if not layer_names:
            layer_names = list(grp.keys())
        for lname in layer_names:
            if lname not in grp:
                continue
            weights: Dict[str, np.ndarray] = {}

            def visit(name, obj, weights=weights):
                if isinstance(obj, hdf5.Dataset):
                    weights[name.split("/")[-1].split(":")[0]] = obj[:]

            grp[lname].visititems(visit)
            if weights:
                out[_canonical(lname)] = weights
    return out
