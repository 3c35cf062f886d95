"""Small helpers: :mod:`sleap_tpu.util` for the port.

JSON helpers, structured dtypes of the data model's dataclasses, dicts saved
to and read from HDF5 through the port's own writer and reader
(:mod:`sleap_tpu_torch.io.hdf5`, never ``h5py``), filename matching, the
user's configuration directory (``~/.sleap_tpu/``, the JAX package's) and
frame-list parsing.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Hashable, Iterable, List, Optional

import numpy as np

from sleap_tpu_torch.io import hdf5

# h5py's variable-length UTF-8 string dtype (``h5py.string_dtype()``).
STRING_DTYPE = np.dtype("O", metadata={"vlen": str})


def json_loads(json_str: str) -> Dict:
    return json.loads(json_str)


def json_dumps(d: Dict, filename: Optional[str] = None) -> Optional[str]:
    out = json.dumps(d, separators=(",", ":"))
    if filename:
        with open(filename, "w") as f:
            f.write(out)
        return None
    return out


def attr_to_dtype(instance: Any) -> np.dtype:
    """A structured numpy dtype of a dataclass's ``str``, ``int``, ``float``
    and ``bool`` fields, in order (strings as variable-length UTF-8)."""
    dtype_list = []
    for field in dataclasses.fields(type(instance)):
        if field.type in (str, "str"):
            dtype_list.append((field.name, STRING_DTYPE))
        elif field.type in (int, "int"):
            dtype_list.append((field.name, int))
        elif field.type in (float, "float"):
            dtype_list.append((field.name, float))
        elif field.type in (bool, "bool"):
            dtype_list.append((field.name, bool))
    return np.dtype(dtype_list)


def save_dict_to_hdf5(h5file: hdf5.WritableGroup, path: str, dic: dict) -> None:
    """Save a dict into a group of a :class:`~sleap_tpu_torch.io.hdf5.Writer`,
    a sub-dict as a subgroup and each other value as a dataset (a list of
    strings as variable-length strings); ``None`` values are skipped and an
    existing dataset of the same name is replaced."""
    for key, item in list(dic.items()):
        if item is None:
            continue
        name = f"{path}/{key}"
        if isinstance(item, dict):
            save_dict_to_hdf5(h5file, name, item)
            continue
        parent, leaf = h5file._parent_of(name)
        parent.children.pop(leaf, None)
        if isinstance(item, (list, tuple)) and item and isinstance(item[0], str):
            item = np.array(item, dtype=object)
        h5file.create_dataset(name, data=item, compression=None)


def read_hdf5_dataset(filename: str, dataset: str) -> np.ndarray:
    with hdf5.File(filename) as f:
        return f[dataset][()]


def read_hdf5_group(filename: str, group: str = "/") -> Dict[str, np.ndarray]:
    """Every dataset below ``group``, keyed by its path from ``group``."""
    data = {}
    with hdf5.File(filename) as f:
        def visit(name, obj):
            if isinstance(obj, hdf5.Dataset):
                data[f"{group.rstrip('/')}/{name}"] = obj[()]
        f[group].visititems(visit)
    return data


def weak_filename_match(filename_a: str, filename_b: str) -> bool:
    """True if two paths probably refer to the same file (same base name,
    case and slashes aside)."""
    filename_a = filename_a.replace("\\", "/").lower()
    filename_b = filename_b.replace("\\", "/").lower()
    return filename_a.split("/")[-1] == filename_b.split("/")[-1]


def dict_cut(d: Dict, a: int, b: int) -> Dict:
    """The items of ``d`` with keys in [a, b)."""
    return {k: v for k, v in d.items() if a <= k < b}


def get_package_file(filename: str) -> str:
    """The path of a file inside the ``sleap_tpu_torch`` package."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), filename)


def get_config_file(shortname: str, ignore_file_not_found: bool = False, get_defaults: bool = False) -> str:
    """A configuration file from the user's ``~/.sleap_tpu/`` (unless
    ``get_defaults``), else the package's ``config/`` folder."""
    user_path = os.path.expanduser(f"~/.sleap_tpu/{shortname}")
    if not get_defaults and os.path.exists(user_path):
        return user_path
    pkg_path = get_package_file(f"config/{shortname}")
    if os.path.exists(pkg_path):
        return pkg_path
    if ignore_file_not_found:
        return user_path
    raise FileNotFoundError(f"Cannot find config file: {shortname}")


def make_scoped_dictionary(flat_dict: Dict[str, Any], exclude_nones: bool = True) -> Dict[str, Dict[str, Any]]:
    """``{"scope.key": value}`` -> ``{scope: {key: value}}``; keys without a
    scope are dropped."""
    scoped: Dict[str, Dict[str, Any]] = {}
    for key, val in flat_dict.items():
        if "." in key and (not exclude_nones or val is not None):
            scope, subkey = key.split(".", 1)
            scoped.setdefault(scope, {})[subkey] = val
    return scoped


def find(f, seq: Iterable, first: bool = False):
    """The items of ``seq`` for which ``f`` is true (or only the first)."""
    results = [x for x in seq if f(x)]
    if first:
        return results[0] if results else None
    return results


def uniquify(seq: Iterable[Hashable]) -> List:
    """The items of ``seq`` without repeats, in order."""
    return list(dict.fromkeys(seq))


def frame_list(frame_str: str) -> Optional[List[int]]:
    """``"1-10"`` or ``"1,2,3"`` (or both) as frame indices; None if empty."""
    frame_str = frame_str.strip()
    if not frame_str:
        return None
    out: List[int] = []
    for part in frame_str.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out
