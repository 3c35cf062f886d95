"""Data-parallel inference and training across cards, and the multi-host
helpers (port of :mod:`sleap_tpu.parallel.distributed`).

Inference runs on the ``data`` axis of a mesh
(:mod:`sleap_tpu_torch.parallel.mesh`), as the JAX package's does; training
on both axes, ``data`` and ``spatial`` (frame height,
:mod:`sleap_tpu_torch.parallel.spatial`).

Inference: one process, one replica per data index.
:func:`make_sharded_predictor` multiplies a predictor's ``batch_size`` by
the data-axis size, so each device keeps its batch, and wraps its
per-batch ``_infer`` with :func:`sharded_infer_fn`: the global batch is
split into equal row blocks, each block goes through the unchanged
``_infer`` of a replica on its data index's device (top-down: the UNet,
kernel 2's local peaks, kernel 3's crops, the instance UNet and kernel 1's
global peaks; bottom-up: kernel 4), and the outputs are concatenated in
sample order on the first device. The kernels launch on the device of
their input (``ops/_build.launch`` takes the input's device index), so
they run on every replica. Post-processing, tracking and ``Labels`` then
run unchanged on the whole batch, and a tracker sees frames in order. The
replicas are driven one after another from one host thread: launches are
asynchronous, so replicas on distinct cards overlap as far as a replica's
work does not wait on the host. A replica on the predictor's own device is
the predictor itself; elsewhere it is a copy with its modules moved there.

Training: one process per device of the mesh, over ``torch.distributed``:
rank ``r`` is data index ``r // s`` and spatial index ``r % s`` of an
``(n/s, s)`` mesh (``spatial_sharding=s``, 1 by default).
``Trainer(n_devices=n).train()`` outside a process group spawns its
``n - 1`` peers itself (the spawn start method, a rendezvous file in a
temporary folder, :func:`_peer_main` as the entry point), after building
the kernel library once, so that ranks do not race to build it; the peers
start up (imports, CUDA context) while the caller decodes the examples and
builds the module, then load that trainer from a file, so that they do not
decode again; the caller is rank 0 and ends holding the best weights. The spawn start method imports the caller's main module in
each rank, so a script that trains this way guards its entry point with
``if __name__ == "__main__":``. Under ``torchrun`` (``WORLD_SIZE`` set), or in a group the
caller opened (:func:`initialize_multihost`), each process's trainer joins
that group instead. The backend is chosen from the mesh up front and
logged: NCCL between distinct cards, gloo on the CPU and where ranks share
a card (NCCL refuses two ranks on one GPU).

A sharded step computes the JAX package's sharded jit step on the
global batch, which is where PyTorch's usual idiom (DDP, per-rank batch
norm) would compute another function:

a. every rank draws the same indices from ``np.random.default_rng(0)``
   and builds the same global batch, whose size is rounded up to a
   multiple of the data-axis size; data index i keeps rows
   ``[i*b, (i+1)*b)``;
b. every rank augments and builds the ground truth of the whole global
   batch from the same ``torch.Generator`` (seeded 42), so the draws are
   the single-device run's, then keeps its rows, and with a spatial axis
   its band of the image and of every map (the map's band is the image's
   divided by its stride; class vectors are whole);
c. batch norm (``models/encoder_decoder.FlaxBatchNorm2d``) all-reduces
   its per-channel sums of x and x^2 and its count across every rank,
   differentiably, before flax's variance rule, so the statistics, the
   normalisation and the running statistics are the global batch's and
   equal on every rank (``SyncBatchNorm`` uses Welford's variance, another
   function);
d. each rank's loss is its share of the global loss: its sums of squared
   errors and cross-entropies over the global batch's counts, so the
   shares sum to the global loss whatever the rows' or bands' sizes (a
   mean of per-shard means is another function where shards differ);
   hard keypoint mining picks hard channels from the per-channel losses
   of the whole batch, summed across ranks differentiably, and every rank
   takes a 1/n share of that term;
e. gradients are summed across ranks before ``optimizer.step()`` (each
   rank's being its share's), and the all-reduces of c and d, and the
   halo exchanges of the spatial axis, sum their gradients in their
   backward; the weights are broadcast from rank 0 before the first step,
   after the initialization and any ``base_checkpoint``;
f. the reported losses are the shares summed across ranks, so the
   learning-rate schedule, early stopping and the best-model choice take
   the same branch on every rank; the ZMQ ``stop`` and ``set_lr`` requests
   are read on rank 0 and broadcast each batch;
g. rank 0 alone writes the run folder, checkpoints, CSV log, TensorBoard
   logs, visualizations and ZMQ reports, and evaluates the model;
h. every process group has a timeout (``Trainer.group_timeout`` seconds);
   the caller joins its peers within it and kills them after it, and a
   rank that raises makes ``train()`` raise in the caller, with the
   rank's traceback. Over gloo a peer that dies ends the collectives at
   once; over NCCL the group's timeout ends them.

i. with a spatial axis the ranks of a data index hold bands of each frame,
   and the backbones' convolutions, pools, resizes and per-sample frame
   reductions exchange rows across band edges
   (:mod:`sleap_tpu_torch.parallel.spatial`); the losses and the reported
   loss are as in d and f.

The collectives are ``all_reduce`` and ``broadcast``, which gloo runs on
card tensors too.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import logging
import os
import pickle
import shutil
import tempfile
import traceback
from datetime import timedelta
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sleap_tpu_torch.parallel.mesh import Mesh, make_mesh, split_rows

if TYPE_CHECKING:
    from sleap_tpu_torch.parallel.spatial import SpatialGroup

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------- #
# Multi-host helpers
# --------------------------------------------------------------------------- #


def backend_for(devices: Sequence[torch.device]) -> str:
    """The process-group backend for ranks on ``devices``: NCCL between
    distinct cards, gloo on the CPU or where ranks share a card."""
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return "gloo"
    if types == {"cuda"}:
        indices = [d.index for d in devices]
        return "nccl" if len(set(indices)) == len(indices) else "gloo"
    raise ValueError(f"A data axis of {sorted(types)} devices has no backend.")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
    timeout: float = 600.0,
) -> None:
    """Open the default process group across hosts: at
    ``tcp://<coordinator_address>`` with ``num_processes`` ranks, this one
    ``process_id``; with no address, from ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). NCCL for
    ``device="cuda"``, gloo for ``"cpu"``; ``timeout`` in seconds."""
    backend = {"cuda": "nccl", "cpu": "gloo"}[torch.device(device).type]
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {"timeout": timedelta(seconds=timeout)}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, **kwargs)


def host_frame_range(n_frames: int) -> range:
    """This process's contiguous share of a video's frames, split by
    ceiling over the processes of the default group (all of them without
    one)."""
    if dist.is_available() and dist.is_initialized():
        pid, n = dist.get_rank(), dist.get_world_size()
    else:
        pid, n = 0, 1
    per = -(-n_frames // n)
    return range(pid * per, min((pid + 1) * per, n_frames))


# --------------------------------------------------------------------------- #
# Inference
# --------------------------------------------------------------------------- #


def _same_device(a: torch.device, b: torch.device) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (b.index if b.index is not None
                                                             else current)


def replicate_predictor(predictor, device: torch.device):
    """``predictor`` on ``device``: itself where it already runs there,
    else a copy whose trained models' modules are moved there (no
    tracker)."""
    from sleap_tpu_torch.inference.predictors import TrainedModel

    if _same_device(predictor.device, device):
        return predictor
    changes = {"device": torch.device(device), "tracker": None}
    for f in dataclasses.fields(predictor):
        value = getattr(predictor, f.name)
        if f.init and isinstance(value, TrainedModel):
            changes[f.name] = dataclasses.replace(
                value, module=copy.deepcopy(value.module).to(device))
    return dataclasses.replace(predictor, **changes)


def _replica(fn: Callable, device: torch.device) -> Callable:
    """``fn`` to run on ``device``: a module is copied there, a predictor's
    bound method becomes its replica's; another function runs as it is."""
    if isinstance(fn, torch.nn.Module):
        param = next(fn.parameters(), None)
        if param is not None and not _same_device(param.device, device):
            return copy.deepcopy(fn).to(device)
        return fn
    owner = getattr(fn, "__self__", None)
    if owner is not None and dataclasses.is_dataclass(owner) and hasattr(owner, "device"):
        replica = replicate_predictor(owner, device)
        return fn if replica is owner else getattr(replica, fn.__name__)
    return fn


def _split(x: Any, n: int, rows: int) -> list:
    """``x`` as ``n`` row blocks where it has ``rows`` rows (tensors,
    arrays, lists, and dicts of them); else ``n`` references to it."""
    if isinstance(x, dict):
        parts = {k: _split(v, n, rows) for k, v in x.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    if isinstance(x, (torch.Tensor, np.ndarray, list)) and len(x) == rows:
        return split_rows(x, n)
    return [x] * n


def _to(x: Any, device: torch.device) -> Any:
    """Tensors (also inside dicts) moved to ``device``; host data stays."""
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _concat(outs: list, device: torch.device) -> Any:
    """Per-replica outputs joined along their rows on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(parts), device) for parts in zip(*outs))
    raise TypeError(f"Cannot concatenate outputs of type {type(first).__name__}.")


def sharded_infer_fn(infer_fn: Callable, mesh: Optional[Mesh] = None) -> Callable:
    """Wrap a per-batch function for data-parallel execution.

    The arguments' rows (the first argument's row count; tensors, arrays,
    lists and dicts of them) are split into one equal block per data
    index; each block runs through a replica of ``infer_fn`` on its index's
    device (a module is copied there, a predictor's bound method runs on the
    predictor's replica, another function runs as given on tensors moved
    there) and the outputs are concatenated in sample order on the first
    device. The global batch must split evenly.
    """
    if mesh is None:
        mesh = make_mesh()
    devices = mesh.data_devices
    replicas = [_replica(infer_fn, d) for d in devices]

    def wrapped(*args):
        n, rows = len(devices), len(args[0])
        parts = [_split(a, n, rows) for a in args]
        outs = [replica(*[_to(p[i], d) for p in parts])
                for i, (replica, d) in enumerate(zip(replicas, devices))]
        return _concat(outs, devices[0])

    return wrapped


def make_sharded_predictor(predictor, mesh: Optional[Mesh] = None):
    """Replace a predictor's per-batch ``_infer`` with the data-parallel
    version; ``batch_size`` is scaled by the data-axis size so each device
    keeps its original batch."""
    if mesh is None:
        mesh = make_mesh()
    predictor._infer = sharded_infer_fn(predictor._infer, mesh)
    predictor.batch_size = predictor.batch_size * mesh.shape["data"]
    return predictor


# --------------------------------------------------------------------------- #
# Training: the data group of a step
# --------------------------------------------------------------------------- #


def _flat_collective(tensors: List[torch.Tensor], collective: Callable) -> None:
    """Run ``collective`` in place on the tensors flattened into one buffer
    per dtype, and copy the results back (whatever the tensors' memory
    layout)."""
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        collective(flat)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view(t.shape))


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the sum of the gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place on a training mesh: its rank among ``size``
    ranks, its device, the process group (None: the default one), and the
    mesh's ``spatial`` size (ranks ``spatial * i`` to ``spatial * (i + 1) - 1``
    hold data index ``i``)."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    spatial: int = 1

    @classmethod
    def of_world(cls, device: torch.device, spatial: int = 1) -> "DataGroup":
        return cls(dist.get_rank(), dist.get_world_size(), torch.device(device), spatial=spatial)

    @property
    def n_data(self) -> int:
        """The size of the data axis."""
        return self.size // self.spatial

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's data index's block of the global batch ``x``."""
        return split_rows(x, self.n_data)[self.rank // self.spatial]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable (its backward
        sums the gradients over the ranks)."""
        return _AllReduceSum.apply(t, self.group)

    def sum_gradients(self, module: torch.nn.Module) -> None:
        """Each parameter's gradient replaced by its sum over the ranks."""
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        _flat_collective(grads, lambda flat: dist.all_reduce(flat, group=self.group))

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank."""
        with torch.no_grad():
            _flat_collective([*module.parameters(), *module.buffers()],
                             lambda flat: dist.broadcast(flat, 0, group=self.group))

    def share_control(self, stop: bool, lr: Optional[float]):
        """Rank 0's ``(stop, learning rate or None)`` on every rank."""
        t = torch.tensor([float(stop), np.nan if lr is None else lr], dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, 0, group=self.group)
        stop, lr = t.tolist()
        return bool(stop), (None if np.isnan(lr) else lr)


_DATA_GROUP: Optional[DataGroup] = None


def current_data_group() -> Optional[DataGroup]:
    """The data group of the step being run, or None outside one."""
    return _DATA_GROUP


@contextlib.contextmanager
def data_parallel(data: DataGroup):
    """Run the enclosed steps as rank ``data.rank`` of ``data``."""
    global _DATA_GROUP
    previous, _DATA_GROUP = _DATA_GROUP, data
    try:
        yield data
    finally:
        _DATA_GROUP = previous


def _step_wrapper(step: Callable, data: Optional[DataGroup],
                  spatial: Optional[SpatialGroup]) -> Callable:
    from sleap_tpu_torch.parallel.spatial import spatially_sharded

    mesh_spatial = 1 if data is None else data.spatial
    if (1 if spatial is None else spatial.size) != mesh_spatial:
        raise ValueError(f"A spatial group of {1 if spatial is None else spatial.size} on a mesh "
                         f"of spatial size {mesh_spatial}.")

    def wrapped(batch, generator):
        with data_parallel(data or DataGroup.of_world(batch["image"].device)), \
                spatially_sharded(spatial):
            return step(batch, generator)

    return wrapped


def sharded_train_step(train_step: Callable, data: Optional[DataGroup] = None,
                       spatial: Optional[SpatialGroup] = None) -> Callable:
    """A trainer's ``train_step(batch, generator)`` run as a rank of
    ``data`` (the default group's ranks if None): the batch is the global
    batch; the step keeps this rank's rows, and with ``spatial`` (the
    :class:`~sleap_tpu_torch.parallel.spatial.SpatialGroup` of ``data``'s
    mesh, needed where ``data.spatial > 1``) its band of the frames;
    batch norm and hard keypoint mining read the whole batch, each rank's
    loss is its share of the global loss, the gradients are summed, and the
    loss returned is the global loss."""
    return _step_wrapper(train_step, data, spatial)


def sharded_val_step(val_step: Callable, data: Optional[DataGroup] = None,
                     spatial: Optional[SpatialGroup] = None) -> Callable:
    """A trainer's ``val_step(batch, generator)`` as a rank of ``data``:
    this rank's rows (and band, with ``spatial``), the loss of the global
    batch."""
    return _step_wrapper(val_step, data, spatial)


def in_process_group() -> bool:
    """Whether this process is a rank of a group already (opened, or about
    to be joined under ``torchrun``)."""
    return (dist.is_available() and dist.is_initialized()) or "WORLD_SIZE" in os.environ


def join_data_group(trainer) -> DataGroup:
    """The trainer's rank in the caller's group, opened from ``torchrun``'s
    environment if not yet open; its world size must be ``n_devices``, and
    ``spatial_sharding`` consecutive ranks share a data index."""
    if not dist.is_initialized():
        backend = "nccl" if trainer.device.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(trainer.device)
        dist.init_process_group(backend, init_method="env://",
                                timeout=timedelta(seconds=trainer.group_timeout))
    if dist.get_world_size() != trainer.n_devices:
        raise ValueError(f"n_devices={trainer.n_devices}, but the process group has "
                         f"{dist.get_world_size()} ranks.")
    logger.info("Data-parallel training: rank %d of %d on %s (%s).", dist.get_rank(),
                dist.get_world_size(), trainer.device, dist.get_backend())
    return DataGroup.of_world(trainer.device, trainer.spatial_sharding)


def _peer_main(rank: int, world: int, device: torch.device, init_method: str, backend: str,
               timeout: float, payload: str, error_file: str, threads: int) -> None:
    """A spawned rank: start up while the caller sets up, join the group
    (the caller joins once it has written the payload), load the caller's
    trainer and train its share; on failure write the traceback for the
    caller and exit 1."""
    torch.set_num_threads(threads)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)  # the context
        # The optimizer imports this at its first step, which takes seconds.
        importlib.import_module("torch._dynamo")

        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        with open(payload, "rb") as f:
            trainer = pickle.load(f)
        trainer.device = device
        trainer.module.to(device)
        trainer.train_rank(DataGroup(rank, world, device, spatial=trainer.spatial_sharding))
    except BaseException:
        with open(error_file, "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _peer_payload(trainer) -> bytes:
    """The trainer as its peers start from it: decoded examples, the module
    on the CPU, nothing that writes or listens."""
    peer = copy.copy(trainer)
    peer.module = copy.deepcopy(trainer.module).cpu()
    peer.data_readers = None
    peer.run_path = None
    peer.optimizer = None
    peer._gt_fn = None
    peer._zmq_reporter = peer._zmq_controller = None
    return pickle.dumps(peer)


def train_data_parallel(trainer) -> None:
    """Train ``trainer`` over its mesh: spawn a rank per device after the
    first, in mesh order (they start up while this process sets up and
    writes their payload), train as rank 0 in this process, and join them.
    Raises if a rank failed, with its traceback."""
    devices = [d for row in trainer.mesh.devices for d in row]
    world = len(devices)
    backend = backend_for(devices)
    logger.info("Data-parallel training over %d ranks on %s (%s).", world,
                ", ".join(map(str, devices)), backend)
    if any(d.type == "cuda" for d in devices):
        from sleap_tpu_torch.ops import _build

        _build.build_library()
        torch.cuda.set_device(devices[0])
    tmp = tempfile.mkdtemp(prefix="sleap_dp_")
    payload = os.path.join(tmp, "trainer.pkl")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    errors = [os.path.join(tmp, f"rank{r}.err") for r in range(world)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_peer_main, daemon=True,
                         args=(r, world, devices[r], init_method, backend, trainer.group_timeout,
                               payload, errors[r], torch.get_num_threads()))
             for r in range(1, world)]
    failure = None
    try:
        for p in procs:
            p.start()
        if trainer.module is None:
            trainer.setup()
        # What the ground truth reads from the labels (a crop size), settled
        # here: the peers get no labels.
        trainer._gt_fn = trainer.build_gt_fn()
        with open(payload, "wb") as f:
            f.write(_peer_payload(trainer))
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=0,
                                timeout=timedelta(seconds=trainer.group_timeout))
        logger.info("All %d ranks joined the group.", world)
        trainer.train_rank(DataGroup(0, world, devices[0], spatial=trainer.spatial_sharding))
    except BaseException as e:
        failure = e
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        started = [p for p in procs if p.pid is not None]
        for p in started:
            p.join(trainer.group_timeout if failure is None else 5.0)
            if p.is_alive():
                p.kill()
                p.join()
        peers = {r: p.exitcode for r, p in enumerate(procs, 1) if p.pid is not None}
        logger.info("Ranks 1-%d ended with exit codes %s.", world - 1, list(peers.values()))
        tracebacks = {r: Path(errors[r]).read_text() for r in peers if os.path.exists(errors[r])}
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: code for r, code in peers.items() if code != 0}
    if failed:
        detail = "\n".join(f"rank {r}:\n{tb}" for r, tb in tracebacks.items())
        raise RuntimeError(f"Data-parallel training failed on ranks {sorted(failed)} (exit codes "
                           f"{failed}).\n{detail}") from failure
    if failure is not None:
        raise failure
