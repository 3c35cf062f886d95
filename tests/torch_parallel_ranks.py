"""The ranks of ``tests/test_torch_parallel.py``'s data-parallel checks:
functions that spawned processes run, importing the port alone (a spawned
rank imports this module, not the test module, which imports JAX)."""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from sleap_tpu_torch.parallel.distributed import DataGroup, current_data_group, sharded_train_step
from sleap_tpu_torch.training.trainer import CentroidTrainer

TIMEOUT_S = 60


def run_ranks(target, world: int, *args) -> list:
    """``target(rank, world, *args)`` in ``world`` spawned processes, joined
    over gloo on the CPU; their results in rank order. Raises with a rank's
    traceback if one failed, and kills any rank still running after
    ``TIMEOUT_S``."""
    tmp = tempfile.mkdtemp(prefix="torch_parallel_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, init, outs[r], args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(world):
            with open(outs[r], "rb") as f:
                ok, value = pickle.load(f)
            assert ok, f"rank {r} failed:\n{value}"
            results.append(value)
        assert not hung, f"ranks {hung} hung"
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(target, rank, world, init, out, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        result = (True, target(rank, world, *args))
    except BaseException:
        result = (False, traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def sharded_step(rank: int, world: int, payload: bytes, inds) -> tuple:
    """One train step of the pickled trainer (an optimizer that leaves the
    weights alone) as rank ``rank`` on the global batch of examples
    ``inds``: the loss, every gradient and every running statistic."""
    trainer = pickle.loads(payload)
    trainer.optimizer = torch.optim.SGD(trainer.module.parameters(), lr=0.0)
    batch = trainer.to_device(trainer.make_batch([trainer._train_examples[i] for i in inds], None))
    step = sharded_train_step(trainer.train_step, DataGroup(rank, world, torch.device("cpu")))
    loss = float(step(batch, torch.Generator().manual_seed(0)))
    grads = {n: p.grad.clone() for n, p in trainer.module.named_parameters()}
    stats = {k: v.clone() for k, v in trainer.module.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return loss, grads, stats


class FailingPeerTrainer(CentroidTrainer):
    """A centroid trainer whose rank 1 raises in its first train step."""

    def train_step(self, batch, generator):
        data = current_data_group()
        if data is not None and data.rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        return super().train_step(batch, generator)
