"""The ranks of ``tests/test_torch_spatial.py``: functions that the
processes spawned by ``torch_parallel_ranks.run_ranks`` run, importing the
port alone."""

from __future__ import annotations

import copy
import pickle

import torch
import torch.distributed as dist

from sleap_tpu_torch.models.encoder_decoder import (
    Conv2dSame,
    ConvTransposeSame,
    FlaxBatchNorm2d,
    avg_pool_same,
    max_pool_same,
    space_to_depth,
    upsample,
)
from sleap_tpu_torch.parallel.distributed import DataGroup, data_parallel, sharded_train_step
from sleap_tpu_torch.parallel.spatial import SpatialGroup, banded, frame_mean, gather_frame

N, C = 2, 4


class Fn(torch.nn.Module):
    """A function of one NCHW tensor as a module (no weights)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class FlattenHead(torch.nn.Module):
    """The class-vector head without global pooling: the whole frame,
    flattened in NHWC order, through a dense layer."""

    def __init__(self, features: int):
        super().__init__()
        self.fc = torch.nn.Linear(features, 3)

    def forward(self, x):
        return self.fc(gather_frame(x).permute(0, 2, 3, 1).flatten(1))


class MeanHead(torch.nn.Module):
    """The class-vector head with global pooling, and squeeze-excite's
    gate: a per-sample mean over the frame, through a 1x1 conv."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(C, C, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv(frame_mean(x)))


def primitive_cases(height: int, width: int):
    """(name, module, input stride, whether the output is whole on every
    rank) of every shared primitive, at strides where a frame of ``height``
    x ``width`` splits evenly."""
    cases = []
    for k, stride, dilation, groups, f in [
        (3, 1, 1, 1, 1), (1, 1, 1, 1, 1), (5, 1, 1, 1, 2), (7, 2, 1, 1, 1), (3, 2, 1, 1, 1),
        (3, 2, 1, 1, 4), (1, 2, 1, 1, 2), (3, 1, 2, 1, 2), (3, 1, 4, 1, 4), (3, 1, 8, 1, 8),
        (4, 1, 1, 1, 1), (2, 2, 1, 1, 1), (3, 2, 1, C, 2), (5, 2, 1, C, 1), (3, 1, 1, 2, 8),
    ]:
        cases.append((f"conv k{k} s{stride} d{dilation} g{groups} at {f}",
                      Conv2dSame(C, C * 2 if groups == 1 else C, k, stride, dilation, groups),
                      f, False))
    for k, f in [(3, 2), (4, 4), (2, 2), (3, 8)]:
        cases.append((f"transposed conv k{k} s2 at {f}", ConvTransposeSame(C, 3, k, 2), f, False))
    for window, stride, f in [(2, 2, 1), (3, 2, 2), (2, 2, 4), (3, 1, 2)]:
        cases.append((f"max pool {window}/{stride} at {f}",
                      Fn(lambda x, s=stride, w=window: max_pool_same(x, s, w)), f, False))
    for window, stride, f in [(2, 2, 1), (3, 2, 2)]:
        cases.append((f"avg pool {window}/{stride} at {f}",
                      Fn(lambda x, s=stride, w=window: avg_pool_same(x, s, w)), f, False))
    for method, stride, f in [("nearest", 2, 2), ("nearest", 4, 8), ("bilinear", 2, 2),
                              ("bilinear", 2, 8), ("bilinear", 4, 4)]:
        cases.append((f"upsample {method} x{stride} at {f}",
                      Fn(lambda x, s=stride, m=method: upsample(x, s, m)), f, False))
    cases.append(("space to depth 2 at 1", Fn(lambda x: space_to_depth(x, 2)), 1, False))
    cases.append(("batch norm at 2", FlaxBatchNorm2d(C, 1e-3, 0.9), 2, False))
    cases.append(("frame mean gate at 4", MeanHead(), 4, False))
    f = 8
    features = -(-height // f) * -(-width // f) * C
    cases.append(("flatten head at 8", FlattenHead(features), f, True))
    return cases


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype))
    return module


def _err(a, b):
    return float((a - b).detach().abs().max()) if a.numel() else 0.0


def check_primitives(rank: int, world: int, height: int, width: int, max_stride: int) -> dict:
    """Every case of :func:`primitive_cases` on this rank's band against the
    unsharded op on the whole frame (which every rank computes), float64:
    the largest difference of the band's output, of its input's gradient,
    of the weight gradients summed over the ranks, and of the running
    statistics, per case."""
    data = DataGroup(rank, world, torch.device("cpu"), spatial=world)
    bands = SpatialGroup.of(data).bands(height, width, max_stride)
    out = {"edges": bands.edges}
    for i, (name, module, f, whole) in enumerate(primitive_cases(height, width)):
        module = _seeded(module.double(), i)
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(N, C, -(-height // f), -(-width // f), generator=g, dtype=torch.float64)
        ref = copy.deepcopy(module).train()
        xr = x.clone().requires_grad_()
        y = ref(xr)
        r = torch.randn(y.shape, generator=g, dtype=torch.float64)
        (y * r).sum().backward()

        band = module.train()
        xb = bands.rows_of(x, axis=2).clone().requires_grad_()
        with data_parallel(data), banded(bands):
            yb = band(xb)
        want_y, rb = (y, r) if whole else (bands.rows_of(y, axis=2), bands.rows_of(r, axis=2))
        # A whole output is every rank's: each rank's loss is its share.
        ((yb * rb).sum() / (world if whole else 1)).backward()
        errs = {"y": _err(yb, want_y), "dx": _err(xb.grad, bands.rows_of(xr.grad, axis=2))}
        for (pname, p), (_, pr) in zip(band.named_parameters(), ref.named_parameters()):
            grad = p.grad.clone()
            dist.all_reduce(grad)
            errs[f"d{pname}"] = _err(grad, pr.grad)
        for (bname, b), (_, br) in zip(band.named_buffers(), ref.named_buffers()):
            errs[bname] = _err(b, br)
        out[name] = errs
    return out


def banded_train_forward(data, spatial_group, module, x, r, max_stride: int) -> tuple:
    """``module``'s train-mode forward on this rank's rows and band of the
    NHWC batch ``x``, and the backward of the sum of its outputs times
    ``r``'s (whole-batch maps by head): by head, the band's first row and
    its outputs; the weight gradients summed over the ranks; the running
    statistics."""
    bands = spatial_group.bands(x.shape[1], x.shape[2], max_stride)
    module.train()
    with data_parallel(data), banded(bands):
        out = module(bands.rows_of(data.rows(x)))
    total = sum((y * bands.rows_of(data.rows(r[k]))).sum() for k, y in out.items())
    total.backward()
    grads = {}
    for name, p in module.named_parameters():
        grads[name] = p.grad.clone()
        dist.all_reduce(grads[name])
    outputs = {k: (bands.at_stride(bands.height // r[k].shape[1]).band[0], y.detach())
               for k, y in out.items()}
    stats = {k: v.clone() for k, v in module.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return outputs, grads, stats


def spatial_steps(rank: int, world: int, spatial: int, payloads: dict, inds,
                  forwards: dict = None) -> dict:
    """One train step of each pickled trainer (an optimizer that leaves the
    weights alone) as rank ``rank`` of a ``(world // spatial, spatial)``
    mesh on the global batch of examples ``inds``: by name, the loss, every
    gradient and every running statistic. Then, by name, each pickled
    module of ``forwards`` (with its ``x``, ``r`` and maximum stride)
    through :func:`banded_train_forward`."""
    data = DataGroup(rank, world, torch.device("cpu"), spatial=spatial)
    spatial_group = SpatialGroup.of(data)
    out = {}
    for name, payload in payloads.items():
        trainer = pickle.loads(payload)
        trainer.optimizer = torch.optim.SGD(trainer.module.parameters(), lr=0.0)
        examples = [trainer._train_examples[i] for i in inds]
        batch = trainer.to_device(trainer.make_batch(examples, None))
        step = sharded_train_step(trainer.train_step, data, spatial_group)
        loss = float(step(batch, torch.Generator().manual_seed(0)))
        grads = {n: p.grad.clone() for n, p in trainer.module.named_parameters()}
        stats = {k: v.clone() for k, v in trainer.module.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        out[name] = (loss, grads, stats)
    for name, (payload, x, r, max_stride) in (forwards or {}).items():
        out[name] = banded_train_forward(data, spatial_group, pickle.loads(payload), x, r,
                                         max_stride)
    return out
