"""Locating moved files that saved projects refer to.

Port of :mod:`sleap_tpu.io.pathutils`: find missing video files and repair
their paths by swapping a common path prefix; a learned substitution is kept
in the user's config folder (``~/.sleap_tpu/path_prefixes.yaml``, the JAX
package's file), so later loads repair themselves. The file is read and
written with the port's YAML subset (:mod:`~sleap_tpu_torch.io.yamlsubset`),
as ``yaml.safe_load`` and ``yaml.safe_dump`` would.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from sleap_tpu_torch.io.yamlsubset import yaml_dump, yaml_load

_PREFIX_STORE = os.path.expanduser("~/.sleap_tpu/path_prefixes.yaml")


def list_file_missing(filenames: List[str]) -> List[bool]:
    """Per file: True where the file does NOT exist."""
    return [not os.path.exists(f) for f in filenames]


def fix_path_separator(path: str) -> str:
    """Windows backslash separators to forward slashes."""
    return path.replace("\\", "/")


def find_changed_subpath(old_path: str, new_path: str) -> Tuple[str, str]:
    """The smallest initial pieces that differ between two paths.

    Walks both paths backwards while their trailing characters agree
    (either separator equals the other) and returns the initial pieces that
    were replaced: ``(old_initial, new_initial)``.
    """
    seps = ("/", "\\")
    j = len(new_path)
    i = len(old_path)
    while i > 1 and j > 0:
        a, b = old_path[i - 1], new_path[j - 1]
        if a == b or (a in seps and b in seps):
            i -= 1
            j -= 1
        else:
            break
    return old_path[:i], new_path[:j]


def _load_prefix_map() -> Dict[str, str]:
    try:
        with open(_PREFIX_STORE) as f:
            return yaml_load(f.read()) or {}
    except Exception:
        return {}


def save_path_prefix_replacement(old_prefix: str, new_prefix: str) -> None:
    """Keep a prefix substitution for later loads."""
    data = _load_prefix_map()
    data[old_prefix] = new_prefix
    try:
        os.makedirs(os.path.dirname(_PREFIX_STORE), exist_ok=True)
        with open(_PREFIX_STORE, "w") as f:
            f.write(yaml_dump(data))
    except OSError:
        pass


def filenames_prefix_change(
    filenames: List[str],
    old_prefix: str,
    new_prefix: str,
    missing: Optional[List[bool]] = None,
    confirm_callback: Optional[Callable[[], bool]] = None,
) -> None:
    """Repair missing files in place by swapping ``old_prefix`` for
    ``new_prefix``.

    Changes ``filenames`` (and ``missing`` when given). The first repair
    asks ``confirm_callback``, if given, once before the change is applied
    to the rest, and keeps the substitution
    (:func:`save_path_prefix_replacement`).
    """
    if not filenames or not old_prefix or not new_prefix:
        return

    need_to_ask = callable(confirm_callback)
    check = missing if missing else [True] * len(filenames)
    if len(check) < len(filenames):
        check.extend([True] * (len(filenames) - len(check)))

    for i, filename in enumerate(filenames):
        if not check[i] or not filename.startswith(old_prefix):
            continue
        candidate = fix_path_separator(filename.replace(old_prefix, new_prefix))
        if not os.path.exists(candidate):
            continue
        if need_to_ask and not confirm_callback():
            return
        need_to_ask = False
        filenames[i] = candidate
        check[i] = False
        save_path_prefix_replacement(old_prefix, new_prefix)


def fix_paths_with_saved_prefix(
    filenames: List[str],
    missing: Optional[List[bool]] = None,
    path_prefix_conversions: Optional[Dict[str, str]] = None,
) -> None:
    """Repair missing files in place with the substitutions kept before."""
    if path_prefix_conversions is None:
        path_prefix_conversions = _load_prefix_map()
    if not path_prefix_conversions:
        return

    for i, filename in enumerate(filenames):
        if missing is not None:
            if not missing[i]:
                continue
        elif os.path.exists(filename):
            continue

        for old_prefix, new_prefix in path_prefix_conversions.items():
            if not filename.startswith(old_prefix):
                continue
            candidate = fix_path_separator(filename.replace(old_prefix, new_prefix))
            if os.path.exists(candidate):
                filenames[i] = candidate
                if missing is not None:
                    missing[i] = False
                break
