"""Device meshes (port of :mod:`sleap_tpu.parallel.mesh`).

A :class:`Mesh` is a ``(data, spatial)`` grid of explicit ``torch.device``
objects. A batch is split along its leading axis into equal row blocks, one
per data index, and a module's weights are copied to each data index's
device (:mod:`sleap_tpu_torch.parallel.distributed` runs inference and
training on it); a sharding that names the spatial axis also splits an
axis (frame height) into equal parts across a data index's devices, as
JAX's ``NamedSharding`` does (a training step's bands are aligned to the
backbone's strides instead: :mod:`sleap_tpu_torch.parallel.spatial`).

Where the JAX package differs:

- :func:`make_mesh` with no ``devices`` takes the visible cards and raises
  when there is none; there is no CPU default. ``devices`` may name one
  device several times (the CPU in tests, one card for two ranks);
- asking for more devices than there are raises, where the JAX
  ``make_mesh`` silently builds a smaller mesh (ROADMAP.md, queue 3,
  item 5).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

def _device(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a device with an index where it is a card."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"The mesh names {d}, but CUDA is not available.")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Mesh:
    """Devices on a ``(data, spatial)`` grid: ``devices[i][j]`` is data
    index ``i``, spatial index ``j``."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("data", "spatial")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "spatial": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data index (its first spatial device)."""
        return [row[0] for row in self.devices]


def make_mesh(
    n_devices: Optional[int] = None,
    spatial: int = 1,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
) -> Mesh:
    """A (data, spatial) mesh over ``devices`` (by default the visible
    cards), of the first ``n_devices`` of them."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("No CUDA device is visible: make_mesh defaults to the cards "
                               "(name other devices with devices=, e.g. ['cpu'] * n).")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} available.")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("A mesh needs at least one device.")
    if n % spatial != 0:
        raise ValueError(f"{n} devices not divisible by spatial={spatial}.")
    return Mesh(tuple(tuple(devices[i:i + spatial]) for i in range(0, n, spatial)))


@dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: ``spec`` names the mesh axis of each
    leading dimension (``("data",)``: rows split over the data axis;
    ``()``: replicated), as a ``PartitionSpec`` does."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def shard(self, x: Any) -> List[torch.Tensor]:
        """``x`` as one tensor per data index, on that index's device; with
        the spatial axis in ``spec``, one per device of the mesh in its
        order (``devices[i][j]``: data index ``i``'s rows, the ``j``-th
        equal part of the spatial axis), as JAX's ``addressable_shards``."""
        x = torch.as_tensor(x)
        devices = self.mesh.data_devices
        if self.spec[:1] != ("data",):
            return [x.to(d) for d in devices]
        blocks = split_rows(x, len(devices))
        if "spatial" not in self.spec:
            return [rows.to(d) for rows, d in zip(blocks, devices)]
        axis, s = self.spec.index("spatial"), self.mesh.shape["spatial"]
        if x.shape[axis] % s:
            raise ValueError(f"A spatial axis of {s} devices splits dimension {axis} of "
                             f"{tuple(x.shape)} into equal parts only where it divides "
                             f"{x.shape[axis]}.")
        return [part.to(d) for rows, row_devices in zip(blocks, self.mesh.devices)
                for part, d in zip(rows.chunk(s, axis), row_devices)]


def batch_sharding(mesh: Mesh, spatial_axis: Optional[int] = None) -> Sharding:
    """Sharding for (B, H, W, C) batches: B on data, optionally H on spatial."""
    if spatial_axis is None:
        return Sharding(mesh, ("data",))
    spec = [None, None, None, None]
    spec[0] = "data"
    spec[spatial_axis] = "spatial"
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def split_rows(x: Any, n: int) -> list:
    """``x`` (a tensor, array or list) as ``n`` equal blocks of rows."""
    if len(x) % n:
        raise ValueError(f"A batch of {len(x)} does not split into {n} equal row blocks.")
    b = len(x) // n
    return [x[i * b:(i + 1) * b] for i in range(n)]


def shard_pytree_batch(batch: Dict[str, Any], mesh: Mesh) -> List[Dict[str, torch.Tensor]]:
    """A host batch as one dict per data index: each array's rows of that
    index, on its device."""
    shards = {k: batch_sharding(mesh).shard(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in shards.items()} for i in range(mesh.shape["data"])]


def replicate_pytree(tree: Any, mesh: Mesh) -> List[Any]:
    """A copy of ``tree`` (a module, tensors, arrays, or dicts, lists and
    tuples of them) on each data index's device."""

    def to(x, d):
        if isinstance(x, torch.nn.Module):
            return copy.deepcopy(x).to(d)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            return torch.as_tensor(x).to(d)
        if isinstance(x, dict):
            return {k: to(v, d) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to(v, d) for v in x)
        return x

    return [to(tree, d) for d in mesh.data_devices]
