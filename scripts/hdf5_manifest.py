"""The manifest of an HDF5 file, as one reader reads it: for every object
reached from the root (soft and external links followed, members in
``keys()`` order) its kind, its attributes in order (name, value type,
sha256 of the value), a group's member names, a named datatype's dtype, and
a dataset's dtype, shape, chunks, maximum shape and the sha256 of its
values. ``scripts/make_torch_hdf5_fixtures.py`` writes it from h5py into
``tests/torch_data/hdf5/manifest.json``; the tests and ``chip_smoke.py``
phase 20a build it again from ``sleap_tpu_torch.io.hdf5`` and compare.
Imports only numpy, and works on either reader's objects (the card's
machine has no h5py).
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _is_reference(value: Any) -> bool:
    return type(value).__name__ == "Reference"


def _is_empty(value: Any) -> bool:
    return value is None or type(value).__name__ == "Empty"


def kind(obj: Any) -> str:
    name = type(obj).__name__
    if name in ("File", "Group"):
        return "group"
    return "datatype" if name == "Datatype" else "dataset"


def dtype_name(dtype: Any) -> str:
    """A dataset's type: numpy's name, or what h5py's object dtypes and the
    port's marker types stand for."""
    name = type(dtype).__name__
    if name == "VlenStr" or "vlen" in (getattr(dtype, "metadata", None) or {}):
        return "variable-length string"
    if name == "RefType" or "ref" in (getattr(dtype, "metadata", None) or {}):
        return "object reference"
    return str(dtype)


def value_type(value: Any) -> str:
    if _is_empty(value):
        return "empty"
    if _is_reference(value):
        return "reference"
    if isinstance(value, (bytes, str)):
        return type(value).__name__
    arr = np.asarray(value)
    if arr.dtype == object:
        first = arr.flat[0] if arr.size else None
        return f"object {list(arr.shape)} of {value_type(first) if arr.size else 'nothing'}"
    return f"{arr.dtype} {list(arr.shape)}"


def digest(value: Any, deref: Callable[[Any], str]) -> str:
    """sha256 of a value: a numeric array's bytes; strings and bytes with
    their lengths; a reference as its target's path."""
    h = hashlib.sha256()

    def add(v):
        if _is_reference(v):
            h.update(b"R" + (deref(v) if v else "").encode() + b"\0")
        elif isinstance(v, bytes):
            h.update(b"B%d:" % len(v) + v)
        elif isinstance(v, str):
            encoded = v.encode()
            h.update(b"S%d:" % len(encoded) + encoded)
        else:
            h.update(np.ascontiguousarray(v).tobytes())

    if _is_empty(value):
        h.update(b"N")
    elif isinstance(value, np.ndarray) and value.dtype == object:
        for v in value.flat:
            add(v)
    else:
        add(value)
    return h.hexdigest()


def refusal(group: Any, key: str, feature: str) -> str:
    """What opening and reading ``group[key]`` gives: ``feature`` where it
    raises ``UnsupportedFeature`` naming it, else what happened."""
    try:
        obj = group[key]
        obj[()]
    except Exception as e:  # the refusal's class is the reader's own
        if type(e).__name__ == "UnsupportedFeature" and feature in str(e):
            return feature
        return f"{type(e).__name__}: {e}"
    return "read without a refusal"


def manifest(root: Any, refused: Optional[Dict[str, str]] = None, probe: bool = False) -> List[dict]:
    """The entries of the file open as ``root``. ``refused`` maps paths to
    the feature their reader must refuse: recorded as given, or, with
    ``probe``, as :func:`refusal` finds it."""
    refused = refused or {}
    out: List[dict] = []

    def deref(ref) -> str:
        return root[ref].name

    def visit(path: str, obj: Any) -> None:
        entry = {"path": path, "kind": kind(obj),
                 "attrs": [[k, value_type(v), digest(v, deref)] for k, v in obj.attrs.items()]}
        if entry["kind"] == "group":
            entry["keys"] = list(obj.keys())
        elif entry["kind"] == "datatype":
            entry["dtype"] = dtype_name(obj.dtype)
        else:
            value = obj[()]
            entry.update(dtype=dtype_name(obj.dtype), shape=list(obj.shape),
                         chunks=None if obj.chunks is None else list(obj.chunks),
                         maxshape=None if obj.maxshape is None else list(obj.maxshape),
                         value_type=value_type(value), sha256=digest(value, deref))
        out.append(entry)
        if entry["kind"] == "group":
            for key in obj.keys():
                full = path.rstrip("/") + "/" + key
                if full in refused:
                    feature = refusal(obj, key, refused[full]) if probe else refused[full]
                    out.append({"path": full, "refused": feature})
                else:
                    visit(full, obj[key])

    visit("/", root)
    return out


def differences(want: List[dict], got: List[dict]) -> List[str]:
    """Where two manifests of one file differ (empty when they agree)."""
    diffs = []
    if [e["path"] for e in want] != [e["path"] for e in got]:
        diffs.append(f"paths {[e['path'] for e in want]} != {[e['path'] for e in got]}")
    for a, b in zip(want, got):
        for key in sorted(set(a) | set(b)):
            if a.get(key) != b.get(key):
                diffs.append(f"{a['path']} {key}: {a.get(key)!r} != {b.get(key)!r}")
    return diffs
