"""The port's multi-host helpers: two processes open a gloo group at
``127.0.0.1`` through ``initialize_multihost`` (as two hosts would, at the
coordinator's address) and claim their frames with ``host_frame_range``;
their ranges tile ``[0, 1001)`` and equal the JAX package's
``host_frame_range`` for the same process index and count (``jax.process_index``
and ``jax.process_count`` monkeypatched: no ``jax.distributed`` is
needed)."""

import json
import os
import socket
import subprocess
import sys

import jax

from sleap_tpu.parallel import distributed as jdist
from sleap_tpu_torch.parallel import distributed as tdist

_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from sleap_tpu_torch.parallel.distributed import host_frame_range, initialize_multihost

coordinator, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
initialize_multihost(coordinator_address=coordinator, num_processes=2, process_id=pid,
                     device="cpu", timeout=60)
assert dist.get_world_size() == 2 and dist.get_rank() == pid
r = host_frame_range(1001)
t = torch.tensor([r.stop - r.start])
dist.all_reduce(t)  # the group works: the shares add up
with open(out_path, "w") as f:
    json.dump({"pid": pid, "start": r.start, "stop": r.stop, "total": int(t)}, f)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_group_frame_ranges_match_jax(tmp_path, monkeypatch):
    coordinator = f"127.0.0.1:{_free_port()}"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = [tmp_path / f"out{pid}.json" for pid in range(2)]
    procs = [subprocess.Popen([sys.executable, str(worker), coordinator, str(pid), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid, out in enumerate(outs)]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    shards = sorted((json.loads(o.read_text()) for o in outs), key=lambda s: s["pid"])
    assert shards[0]["start"] == 0 and shards[0]["stop"] == shards[1]["start"]
    assert shards[1]["stop"] == 1001 and all(s["total"] == 1001 for s in shards)
    for s in shards:
        monkeypatch.setattr(jax, "process_index", lambda: s["pid"])
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        want = jdist.host_frame_range(1001)
        assert (s["start"], s["stop"]) == (want.start, want.stop)
    # Outside a group, one process has every frame.
    assert tdist.host_frame_range(1001) == range(0, 1001)
