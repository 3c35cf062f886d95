"""Small data helpers (port of :mod:`sleap_tpu.data.utils`).

``ensure_list``, ``expand_to_rank`` on numpy arrays and torch tensors, and
``describe_tensors``, which prints a torch tensor's ``device``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


def ensure_list(x: Any) -> List[Any]:
    """Wrap ``x`` in a list if it isn't one already."""
    return x if isinstance(x, list) else [x]


def expand_to_rank(x, target_rank: int, prepend: bool = True):
    """Add singleton axes to a numpy array or torch tensor until it has
    ``target_rank`` axes, at the front (``prepend``) or the back; an array
    of that rank or more is returned unchanged."""
    n_new = int(target_rank) - x.ndim
    if n_new <= 0:
        return x
    shape = tuple(x.shape)
    return x.reshape((1,) * n_new + shape if prepend else shape + (1,) * n_new)


def describe_tensors(example: Dict[str, Any], return_description: bool = False) -> Optional[str]:
    """Print (or return) one line per key of an example dict: type, shape,
    dtype and device (a torch tensor's ``device``; "N/A" for numpy)."""
    key_length = max(len(k) for k in example)
    lines = []
    for key, val in example.items():
        dtype = getattr(val, "dtype", type(val).__name__)
        dtype = str(dtype) if isinstance(dtype, np.dtype) else repr(dtype)
        shape = getattr(val, "shape", "N/A")
        device = getattr(val, "device", "N/A")
        lines.append(f"{key.rjust(key_length)}: type={type(val).__name__}, "
                     f"shape={shape}, dtype={dtype}, device={device}")
    desc = "\n".join(lines)
    if return_description:
        return desc
    print(desc)
    return None
