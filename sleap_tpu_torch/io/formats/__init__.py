"""Reading labels from other tools' formats: :mod:`sleap_tpu.io.formats`
on the port's own readers (no ``h5py``, ``yaml`` or ``pandas``).

:func:`read` takes a format name or sniffs it (:func:`sniff_format`):
``slp``, ``analysis`` (``.analysis.h5``), ``labels_json`` (plain, gzip or
zip), ``dlc`` (a DeepLabCut ``CollectedData`` CSV or project
``config.yaml``), ``coco``, ``alphatracker`` and ``leap`` (``.mat``);
:func:`sleap_tpu_torch.io.formats.deepposekit.read_labels` takes its three
paths. ``nwb`` reads through ``pynwb`` and ``ndx_pose``
(:mod:`~sleap_tpu_torch.io.formats.ndx_pose`, imported when called); NIX is
write-only, as in the JAX package. Videos made from the files decode on
``device`` (the card by default).
"""

from __future__ import annotations

import json
from typing import Optional

from sleap_tpu_torch.core.labels import Labels


def read(filename: str, for_object: str = "labels", as_format: Optional[str] = None, **kwargs) -> Labels:
    """Labels from ``filename`` in ``as_format``, or in the format
    :func:`sniff_format` finds."""
    fmt = as_format or sniff_format(filename)
    if fmt == "slp":
        from sleap_tpu_torch.io import slp

        return slp.read_labels(filename, **kwargs)
    if fmt in ("dlc", "deeplabcut", "csv_dlc"):
        from sleap_tpu_torch.io.formats import dlc

        if filename.lower().endswith((".yaml", ".yml")):
            return dlc.read_config(filename, **kwargs)
        return dlc.read_labels(filename, **kwargs)
    if fmt == "dlc_config":
        from sleap_tpu_torch.io.formats import dlc

        return dlc.read_config(filename, **kwargs)
    if fmt == "coco":
        from sleap_tpu_torch.io.formats import coco

        return coco.read_labels(filename, **kwargs)
    if fmt == "alphatracker":
        from sleap_tpu_torch.io.formats import alphatracker

        return alphatracker.read_labels(filename, **kwargs)
    if fmt in ("leap", "mat"):
        from sleap_tpu_torch.io.formats import leap_matlab

        return leap_matlab.read_labels(filename, **kwargs)
    if fmt == "analysis":
        from sleap_tpu_torch.io.formats import sleap_analysis

        return sleap_analysis.read_labels(filename, **kwargs)
    if fmt in ("labels_json", "json"):
        from sleap_tpu_torch.io.formats import labels_json

        return labels_json.read_labels(filename, **kwargs)
    if fmt == "nwb":
        from sleap_tpu_torch.io.formats import ndx_pose

        return ndx_pose.read_labels(filename, **kwargs)
    if fmt == "nix":
        raise ValueError("The NIX format is write-only; use Labels.export_nix() to write it.")
    if fmt == "genericjson":
        return read_json(filename)
    if fmt in ("text", "txt"):
        return read_text(filename)
    raise ValueError(f"Cannot detect format for {filename!r} (got {fmt!r}).")


def read_json(filename: str) -> dict:
    with open(filename) as f:
        return json.load(f)


def write_json(filename: str, source_object) -> None:
    with open(filename, "w") as f:
        json.dump(source_object, f, separators=(",", ":"))


def read_text(filename: str) -> str:
    with open(filename) as f:
        return f.read()


def write_text(filename: str, source_object: str) -> None:
    with open(filename, "w") as f:
        f.write(source_object)


def sniff_format(filename: str) -> str:
    """The format of ``filename`` by its extension, and for ``.h5``,
    ``.csv``, ``.json`` and ``.yaml`` by its content."""
    low = filename.lower()
    if low.endswith(".slp") or low.endswith(".pkg.slp"):
        return "slp"
    if low.endswith(".analysis.h5"):
        return "analysis"
    if low.endswith((".h5", ".hdf5")):
        from sleap_tpu_torch.io import hdf5

        with hdf5.File(filename) as f:
            if "metadata" in f and "frames" in f:
                return "slp"
            if "track_occupancy" in f:
                return "analysis"
        return "slp"
    if low.endswith(".mat"):
        return "leap"
    if low.endswith(".csv"):
        with open(filename) as f:
            first = f.readline()
        return "dlc" if first.startswith("scorer") else "csv"
    if low.endswith(".json"):
        with open(filename) as f:
            head = f.read(4096)
        if '"categories"' in head or '"annotations"' in head and '"images"' in head:
            return "coco"
        if '"class"' in head and '"annotations"' in head:
            return "alphatracker"
        if '"labels"' in head or '"skeletons"' in head:
            return "labels_json"
        return "genericjson"
    if low.endswith(".nwb"):
        return "nwb"
    if low.endswith(".nix"):
        return "nix"
    if low.endswith((".txt", ".log")):
        return "text"
    if low.endswith((".yaml", ".yml")):
        with open(filename) as f:
            head = f.read(8192)
        if "bodyparts" in head or "multianimalproject" in head:
            return "dlc_config"
    raise ValueError(f"Unknown file format: {filename}")
