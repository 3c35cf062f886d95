"""Spatial (frame-height) sharding of a training step: bands, halo
exchanges and the reductions over a band's group.

The JAX package shards frame height by placing image-like batch leaves on
``P("data", "spatial")`` (``sleap_tpu/parallel/distributed.py``,
``_batch_placer``) and leaving the rest to XLA's SPMD partitioner, which
inserts the halo exchanges of every convolution, pool and resize and the
reductions of batch norm and the losses. PyTorch has no partitioner; this
module is its counterpart for the port's backbones. The ranks that share a
data index form a :class:`SpatialGroup`; each holds one horizontal band of
every image and ground-truth map of its rows. Inside a spatially sharded
step :func:`current_bands` tells the shared primitives of
:mod:`sleap_tpu_torch.models.encoder_decoder` where their input's band lies,
and they exchange the rows they need across band edges with
:func:`halos`:

- a convolution or pool reads the input rows its band's outputs reach, with
  SAME padding (computed from the frame's global height) only at the
  frame's top and bottom edges; a stride-1 convolution runs on its band as
  it is and recomputes only its edge rows from thin strips, so that it
  keeps no padded copy of its input for the backward;
- a transposed convolution reads the input rows whose outputs reach into its
  band, then crops as the unsharded op does;
- half-pixel bilinear upsampling reads one row each side (edge rows
  replicated at the frame's edges); nearest upsampling and space-to-depth
  need nothing;
- batch norm sums over every rank (data and spatial), a per-sample mean over
  the frame (:func:`frame_mean`) over the band's group, and a flattening head
  gathers the whole frame in row order (:func:`gather_frame`).

Bands. The trainer puts interior band edges at multiples of the backbone's
maximum stride (:meth:`SpatialGroup.bands`): every pool, strided conv,
space-to-depth stem and output-stride map then splits without fractional
rows, and a band at stride ``f`` is the stride-1 band divided by ``f``. The
blocks of maximum-stride rows are dealt as ``numpy.array_split`` deals them
(the first bands take one more where they do not divide), so a height of 48
at maximum stride 16 on two ranks gives bands of 32 and 16; a band that
would be empty raises. :mod:`sleap_tpu_torch.parallel.mesh` splits height
as JAX's ``NamedSharding`` does instead (equal parts, the height divisible
by the spatial size), which is what placement means there; XLA handles a
band edge inside a pooling window by exchanging partial results, which the
port does not, hence the aligned bands of a training step.

The exchange is one ``all_reduce`` over the band's group of a buffer that
holds, for every rank, the rows it asks of the others (each owner writes
its rows, zeros elsewhere): gloo runs ``all_reduce`` on card tensors but
neither ``send``/``recv`` nor ``all_gather``, and one reduction serves a
halo taller than a neighbour's band too. Its backward is the same exchange
read the other way: the gradient of each halo row is summed back onto the
rank that owns the row.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sleap_tpu_torch.parallel.distributed import _AllReduceSum


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """The ranks that share this rank's data index: ``size`` ranks, this
    one the ``index``-th band, ``group`` their process group."""

    index: int
    size: int
    group: Any = None

    @classmethod
    def of(cls, data) -> "SpatialGroup":
        """This rank's spatial group on the ``(data.size // data.spatial,
        data.spatial)`` grid of ``data`` (a ``DataGroup``): global rank ``r``
        is data index ``r // spatial``, spatial index ``r % spatial``. Every
        rank of ``data`` calls this, in the same order (it opens a process
        group per data index)."""
        s = data.spatial
        if data.size % s:
            raise ValueError(f"{data.size} ranks not divisible by spatial={s}.")
        groups = [dist.new_group(list(range(i * s, (i + 1) * s))) for i in range(data.size // s)]
        return cls(data.rank % s, s, groups[data.rank // s])

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, differentiable."""
        return _AllReduceSum.apply(t, self.group)

    def bands(self, height: int, width: int, max_stride: int) -> "Bands":
        """The bands of a ``height`` x ``width`` frame: interior edges at
        multiples of ``max_stride``; raises where a band would be empty."""
        blocks = -(-height // max_stride)
        if blocks < self.size:
            raise ValueError(
                f"spatial_sharding={self.size} needs at least {self.size} bands of whole "
                f"maximum-stride blocks, but a padded height of {height} at maximum stride "
                f"{max_stride} has {blocks}.")
        counts = [len(part) for part in np.array_split(np.arange(blocks), self.size)]
        edges = [0]
        for c in counts:
            edges.append(min(edges[-1] + c * max_stride, height))
        return Bands(tuple(edges), width, max_stride, self.index, self)


@dataclasses.dataclass(frozen=True)
class Level:
    """A band's geometry at one resolution: the frame's height ``n`` there
    and every band's ``(first row, end row)``, this rank's the ``index``-th."""

    n: int
    rows: Tuple[Tuple[int, int], ...]
    index: int

    @property
    def band(self) -> Tuple[int, int]:
        return self.rows[self.index]


@dataclasses.dataclass(frozen=True)
class Bands:
    """The bands of one frame size at stride 1: ``edges`` (first row of
    each band, then the height), the frame's ``width``, the backbone's
    ``max_stride``; this rank's band is the ``index``-th of ``group``."""

    edges: Tuple[int, ...]
    width: int
    max_stride: int
    index: int
    group: SpatialGroup

    @property
    def height(self) -> int:
        return self.edges[-1]

    def at_stride(self, f: int) -> Level:
        """Every band at stride ``f`` (a divisor of the maximum stride)."""
        n = -(-self.height // f)
        ends = [e // f for e in self.edges[1:-1]] + [n]
        return Level(n, tuple(zip([e // f for e in self.edges[:-1]], ends)), self.index)

    def level(self, x: torch.Tensor) -> Level:
        """The resolution of ``x`` (NCHW, this rank's band), found from its
        band height and width: the smallest stride that gives both."""
        h, w = x.shape[-2], x.shape[-1]
        for f in range(1, self.max_stride + 1):
            if self.max_stride % f or -(-self.width // f) != w:
                continue
            level = self.at_stride(f)
            r0, r1 = level.band
            if r1 - r0 == h:
                return level
        raise ValueError(f"A {h} x {w} band is at no stride of a {self.height} x {self.width} "
                         f"frame banded at {self.edges}.")

    def rows_of(self, t: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's band of a whole-frame tensor ``t`` whose ``axis`` is
        the height at a stride dividing the frame's (NHWC images and maps)."""
        f = self.height // t.shape[axis]
        r0, r1 = self.at_stride(f).band
        return t.narrow(axis, r0, r1 - r0)


_BANDS: Optional[Bands] = None


def current_bands() -> Optional[Bands]:
    """The bands of the forward being run, or None outside a spatially
    sharded step (every primitive then runs unsharded)."""
    return _BANDS


@contextlib.contextmanager
def banded(bands: Optional[Bands]):
    """Run the enclosed forward on this rank's band of ``bands``."""
    global _BANDS
    previous, _BANDS = _BANDS, bands
    try:
        yield bands
    finally:
        _BANDS = previous


_SPATIAL: Optional[SpatialGroup] = None


def current_spatial_group() -> Optional[SpatialGroup]:
    """The spatial group of the step being run, or None outside one."""
    return _SPATIAL


@contextlib.contextmanager
def spatially_sharded(spatial: Optional[SpatialGroup]):
    """Run the enclosed steps as band ``spatial.index`` of ``spatial``."""
    global _SPATIAL
    previous, _SPATIAL = _SPATIAL, spatial
    try:
        yield spatial
    finally:
        _SPATIAL = previous


# --------------------------------------------------------------------------- #
# The exchange
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class _Plan:
    """How rank ``index`` assembles its rows ``[a, b)`` in one exchange:
    the buffer's height ``total``; this rank's own rows ``own`` (local
    start, end); its halo slots ``above`` and ``below`` (buffer start,
    length); and what it writes for the others (local start, end, buffer
    start)."""

    total: int
    own: Tuple[int, int]
    above: Tuple[int, int]
    below: Tuple[int, int]
    sends: Tuple[Tuple[int, int, int], ...]


def _plan(level: Level, wants: Sequence[Tuple[int, int]]) -> _Plan:
    slots, total = [], 0
    for (r0, r1), (a, b) in zip(level.rows, wants):
        above = (a, min(r0, b)) if a < r0 else (r0, r0)
        below = (max(r1, a), b) if b > r1 else (r1, r1)
        slots.append(((total, above), (total + above[1] - above[0], below)))
        total += above[1] - above[0] + below[1] - below[0]
    r0, r1 = level.band
    sends = []
    for j, segments in enumerate(slots):
        if j == level.index:
            continue
        for start, (lo, hi) in segments:
            s, e = max(lo, r0), min(hi, r1)
            if s < e:
                sends.append((s - r0, e - r0, start + s - lo))
    a, b = wants[level.index]
    (start_a, (lo_a, hi_a)), (start_b, (lo_b, hi_b)) = slots[level.index]
    return _Plan(total, (max(a, r0) - r0, min(b, r1) - r0), (start_a, hi_a - lo_a),
                 (start_b, hi_b - lo_b), tuple(sends))


def _buffer(x: torch.Tensor, rows: int) -> torch.Tensor:
    n, c, _, w = x.shape
    return x.new_zeros((n, c, rows, w))


class _Halos(torch.autograd.Function):
    """The rows above and below this rank's band that ``plan`` asks of the
    others (see :func:`halos`); the backward sends each halo row's
    gradient to its owner, to be added to its band's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: _Plan, group: Any):
        ctx.plan, ctx.group, ctx.shape = plan, group, x.shape
        buf = _buffer(x, plan.total)
        for lo, hi, start in plan.sends:
            buf[:, :, start:start + hi - lo] = x[:, :, lo:hi]
        dist.all_reduce(buf, group=group)
        (sa, na), (sb, nb) = plan.above, plan.below
        return buf[:, :, sa:sa + na].clone(), buf[:, :, sb:sb + nb].clone()

    @staticmethod
    def backward(ctx, grad_above: torch.Tensor, grad_below: torch.Tensor):
        plan = ctx.plan
        (sa, na), (sb, nb) = plan.above, plan.below
        buf = _buffer(grad_above, plan.total)
        buf[:, :, sa:sa + na] = grad_above
        buf[:, :, sb:sb + nb] = grad_below
        dist.all_reduce(buf, group=ctx.group)
        out = grad_above.new_zeros(ctx.shape)
        for lo, hi, start in plan.sends:
            out[:, :, lo:hi] += buf[:, :, start:start + hi - lo]
        return out, None, None


def halos(x: torch.Tensor, bands: Bands, wants):
    """The rows a band's op reads beyond it: ``wants(r0, r1, n)`` gives
    ``[a, b)`` for a band ``[r0, r1)`` of a frame of height ``n`` (every
    rank's request is known to all, so all agree on the exchange). Returns
    the rows ``[a, r0)`` and ``[r1, b)`` inside the frame, fetched from the
    bands that hold them (differentiably), the local rows of ``x`` within
    ``[a, b)``, and how many rows above and below the frame the caller
    pads."""
    level = bands.level(x)
    asked = [wants(r0, r1, level.n) for r0, r1 in level.rows]
    a, b = asked[level.index]
    plan = _plan(level, [(max(a, 0), min(b, level.n)) for a, b in asked])
    if plan.total:
        above, below = _Halos.apply(x, plan, bands.group.group)
    else:
        above = below = _buffer(x, 0)
    return above, below, plan.own, max(-a, 0), max(b - level.n, 0)


def halo_rows(x: torch.Tensor, bands: Bands, wants) -> Tuple[torch.Tensor, int, int]:
    """``x`` (this rank's band, NCHW) grown to the rows ``[a, b)`` of the
    frame that ``wants`` asks (see :func:`halos`) within the frame, and how
    many rows above and below the frame the caller pads."""
    above, below, (lo, hi), pad_above, pad_below = halos(x, bands, wants)
    # The exchange's outputs stay in the graph on every rank, empty or not:
    # every rank joins the all-reduce of its backward.
    if above.shape[2] or below.shape[2] or above.requires_grad:
        x = torch.cat([above, x[:, :, lo:hi], below], dim=2)
    elif (lo, hi) != (0, x.shape[2]):
        x = x[:, :, lo:hi]
    return x, pad_above, pad_below


# --------------------------------------------------------------------------- #
# Reductions over the frame
# --------------------------------------------------------------------------- #


def frame_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of NCHW ``x`` over its height and width, keeping both axes:
    over the whole frame when ``x`` is a band of it."""
    bands = current_bands()
    if bands is None:
        return x.mean(dim=(2, 3), keepdim=True)
    level = bands.level(x)
    total = bands.group.all_reduce(x.sum(dim=(2, 3), keepdim=True))
    return total / (level.n * x.shape[3])


def gather_frame(x: torch.Tensor) -> torch.Tensor:
    """The whole frame of NCHW ``x``, in row order, on every rank of the
    group when ``x`` is a band of it (else ``x``). Differentiable: the
    gradient of each band is summed over the ranks that read it."""
    bands = current_bands()
    if bands is None:
        return x
    level = bands.level(x)
    r0, r1 = level.band
    whole = _buffer(x, level.n)
    whole = torch.cat([whole[:, :, :r0], x, whole[:, :, r1:]], dim=2)
    return bands.group.all_reduce(whole)

