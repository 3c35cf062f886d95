"""Read orbax checkpoints (``best_model.ckpt``) as numpy trees, without JAX.

A checkpoint that orbax's ``StandardCheckpointHandler`` wrote holds:

- ``_CHECKPOINT_METADATA``: JSON naming the handler;
- ``_METADATA``: JSON whose ``tree_metadata`` lists every leaf by its key
  path (``key_metadata``);
- an OCDBT key-value store (:mod:`sleap_tpu_torch.io.ocdbt`) holding one
  zarr v2 array per leaf, under the key path joined by dots: its
  ``.zarray`` JSON (dtype, shape, chunks, order, fill value, compressor,
  dimension separator) and its chunks, each a zstd frame
  (:mod:`sleap_tpu_torch.io.zstd`) or raw bytes.

:func:`read_params` returns the ``params`` subtree with the JAX tree's
nesting and names, and :func:`read_variables` the flax variables
``{"params", "batch_stats"}`` (the JAX trainer saves both; ``batch_stats``
holds the batch-norm running statistics, empty for a UNet): the forms
:func:`~sleap_tpu_torch.models.params.state_dict_from_flax` takes.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict

import numpy as np

from sleap_tpu_torch.io.ocdbt import OcdbtReader
from sleap_tpu_torch.io.zstd import decompress

__all__ = ["read_params", "read_variables"]

_HANDLER = "StandardCheckpointHandler"


def _check_handler(ckpt_dir: str) -> None:
    with open(os.path.join(ckpt_dir, "_CHECKPOINT_METADATA")) as f:
        handler = json.load(f).get("item_handlers")
    if not isinstance(handler, str) or handler.rsplit(".", 1)[-1] != _HANDLER:
        raise ValueError(
            f"{ckpt_dir} was written by {handler!r}; only orbax's {_HANDLER} "
            "checkpoints are read."
        )


def _read_array(store: OcdbtReader, name: str) -> np.ndarray:
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, only 2 is read.")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not supported.")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor.get('id')!r}; only zstd is read.")
    dtype = np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype=dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        if key not in store:
            continue  # a chunk never written holds the fill value
        raw = store.read(key)
        if compressor is not None:
            raw = decompress(raw)
        chunk = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _read_tree(ckpt_dir: str) -> Dict[str, Any]:
    ckpt_dir = os.fspath(ckpt_dir)
    _check_handler(ckpt_dir)
    with open(os.path.join(ckpt_dir, "_METADATA")) as f:
        leaves = json.load(f)["tree_metadata"]
    store = OcdbtReader(ckpt_dir)
    tree: Dict[str, Any] = {}
    for entry in leaves.values():
        path = [str(k["key"]) for k in entry["key_metadata"]]
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _read_array(store, ".".join(path))
    if "params" not in tree:
        raise KeyError(f"{ckpt_dir} holds no 'params' tree (top-level keys: {sorted(tree)}).")
    return tree


def read_params(ckpt_dir: str) -> Dict[str, Any]:
    """The ``params`` tree of a model checkpoint (``best_model.ckpt``):
    nested dicts of numpy arrays, keyed as the tree that was saved."""
    return _read_tree(ckpt_dir)["params"]


def read_variables(ckpt_dir: str) -> Dict[str, Any]:
    """The flax variables of a model checkpoint: ``{"params": ...,
    "batch_stats": ...}``, ``batch_stats`` empty when none was saved."""
    tree = _read_tree(ckpt_dir)
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
