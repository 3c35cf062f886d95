"""ZMQ training progress and control (``sleap_tpu_torch.training.callbacks``
and the port's trainer) against the JAX package's, on the CPU, on local
ports:

- the reporter's messages equal JAX's, key for key, for the same calls
  (``epoch_begin``, ``batch_end``, ``epoch_end``, ``train_end``);
- the controller takes ``stop``, a ``set_lr`` (kept until taken, once) and
  drops a malformed ``set_lr``, as JAX's does;
- a centroid model trained for 2 epochs at 64^2 by each package from the
  same initial weights (JAX's, carried over by ``state_dict_from_flax``)
  with ``publish_updates`` publishes the same kinds and counts of events in
  the same order, and the same losses within 1e-5 relative, the trainer's
  parity tolerance (``tests/test_torch_training.py``);
- a ``set_lr`` received mid-run shows in the log rows of both packages, and
  ``stop`` ends both runs after the epoch it arrives in.
"""

import csv
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest

zmq = pytest.importorskip("zmq")

from sleap_tpu.config import TrainingJobConfig as JaxConfig  # noqa: E402
from sleap_tpu.training import callbacks as jcallbacks  # noqa: E402
from sleap_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from sleap_tpu_torch.config import TrainingJobConfig  # noqa: E402
from sleap_tpu_torch.models.params import state_dict_from_flax  # noqa: E402
from sleap_tpu_torch.training import callbacks  # noqa: E402
from sleap_tpu_torch.training import trainer as tt  # noqa: E402
from test_torch_pipelines import labels_pair  # noqa: E402
from test_torch_training import CONFIGS  # noqa: E402

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Subscriber:
    """A SUB socket on a reporter's port, collecting its JSON messages."""

    def __init__(self, port):
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.SUB)
        self.socket.setsockopt_string(zmq.SUBSCRIBE, "")
        self.socket.connect(f"tcp://127.0.0.1:{port}")

    def join(self, reporter, timeout=10.0):
        """Send ``epoch_begin(-1)`` through ``reporter`` until one arrives:
        a SUB misses what a PUB sends before it has joined."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            reporter.epoch_begin(-1)
            if self.socket.poll(50, zmq.POLLIN):
                return
        raise TimeoutError("the SUB did not join")

    def drain(self, until="train_end", timeout=10.0):
        """The messages up to ``until``, without the joining ones."""
        got, deadline = [], time.time() + timeout
        while time.time() < deadline:
            if self.socket.poll(100, zmq.POLLIN):
                got.append(json.loads(self.socket.recv_string()))
                if got[-1]["what"] == until:
                    break
        self.socket.close()
        self.context.term()
        return [m for m in got if m.get("epoch") != -1]


class Commander:
    """A PUB socket bound to a controller's port, sending one command over
    and over from a thread until stopped (a SUB drops what comes before it
    joins)."""

    def __init__(self, port, message):
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PUB)
        self.socket.bind(f"tcp://127.0.0.1:{port}")
        self.message = json.dumps(message)
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.done.is_set():
            self.socket.send_string(self.message)
            time.sleep(0.01)

    def stop(self):
        self.done.set()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()
        self.socket.close()
        self.context.term()


def test_reporter_messages_match_jax():
    got = {}
    for name, module in (("torch", callbacks), ("jax", jcallbacks)):
        port = _free_port()
        reporter = module.ProgressReporterZMQ(f"tcp://127.0.0.1:{port}")
        sub = Subscriber(port)
        sub.join(reporter)
        reporter.epoch_begin(0)
        reporter.batch_end(0, 3, 0.5)
        reporter.batch_end(0, 4, 0.25)
        reporter.epoch_end(0, 0.375, 0.6)
        reporter.close()
        got[name] = sub.drain()
    assert got["torch"] == got["jax"]
    assert [m["what"] for m in got["torch"]] == ["epoch_begin", "batch_end", "batch_end", "epoch_end", "train_end"]
    assert got["torch"][1] == {"what": "batch_end", "epoch": 0, "batch": 3, "logs": {"loss": 0.5}}
    assert got["torch"][3]["logs"] == {"loss": 0.375, "val_loss": 0.6}


def _controller_run(module, messages):
    """Each message sent in turn to a controller of ``module``; the poll
    results and requested learning rates it ends up with."""
    port = _free_port()
    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind(f"tcp://127.0.0.1:{port}")
    controller = module.TrainingControllerZMQ(f"tcp://127.0.0.1:{port}", timeout=50)
    # Join: a PUB drops what it sends before the SUB has joined.
    deadline = time.time() + 10
    while controller.requested_lr != -1.0 and time.time() < deadline:
        pub.send_string(json.dumps({"command": "set_lr", "lr": -1}))
        controller.poll()
    assert controller.take_requested_lr() == -1.0
    while controller.socket.poll(100, zmq.POLLIN):  # the joining messages still in flight
        controller.poll()
    controller.take_requested_lr()
    out = []
    for msg in messages:
        pub.send_string(json.dumps(msg))
        polled = None
        for _ in range(10):
            polled = controller.poll()
            if polled is not None or controller.requested_lr is not None:
                break
        out.append((polled, controller.take_requested_lr(), controller.take_requested_lr()))
    controller.socket.close()
    pub.close()
    ctx.term()
    return out


def test_controller_matches_jax():
    messages = [{"command": "set_lr", "lr": "1e-5"}, {"command": "stop"},
                {"command": "set_lr", "lr": "not-a-number"}, {"command": "set_lr", "lr": 0.25},
                {"command": "set_lr"}, {"command": "unknown"}]
    got = _controller_run(callbacks, messages)
    assert got == _controller_run(jcallbacks, messages)
    assert got == [(None, 1e-5, None), ("stop", None, None), (None, None, None), (None, 0.25, None),
                   (None, None, None), (None, None, None)]


def test_controller_timeout_and_close():
    port = _free_port()
    controller = callbacks.TrainingControllerZMQ(f"tcp://127.0.0.1:{port}", timeout=30)
    assert controller.timeout == 30 and controller.requested_lr is None
    t0 = time.time()
    assert controller.poll() is None
    assert time.time() - t0 >= 0.02
    controller.close()


def _trainers(epochs=2, **zmq_cfg):
    """The centroid config of test_torch_training.py (anchor "a") in both
    packages on the same 64^2 labels, set up, the port holding JAX's
    initial weights."""
    (labels, jlabels), _ = labels_pair(n_frames=6, seed=2)
    cfg = json.loads(json.dumps(CONFIGS["centroid"]))
    cfg["model"]["heads"]["centroid"]["anchor_part"] = "a"
    cfg["optimization"] = {"batch_size": 2, "epochs": epochs, "batches_per_epoch": 3, "val_batches_per_epoch": 1}
    cfg["outputs"] = {"save_outputs": False, "zmq": zmq_cfg}
    text = json.dumps(cfg)
    port = tt.Trainer.from_config(TrainingJobConfig.from_json(text), training_labels=labels,
                                  validation_labels=labels, device="cpu")
    ref = JaxTrainer.from_config(JaxConfig.from_json(text), training_labels=jlabels, validation_labels=jlabels)
    return port, ref


def _setup(port, ref):
    ref.setup()
    port.setup()
    params = jax.tree_util.tree_map(np.asarray, ref.variables["params"])
    port.module.load_state_dict(state_dict_from_flax(port.module, params))


def test_training_publishes_the_same_events_as_jax():
    addresses = {name: _free_port() for name in ("torch", "jax")}
    port, ref = _trainers()
    port.config.outputs.zmq.publish_updates = ref.config.outputs.zmq.publish_updates = True
    port.config.outputs.zmq.publish_address = f"tcp://127.0.0.1:{addresses['torch']}"
    ref.config.outputs.zmq.publish_address = f"tcp://127.0.0.1:{addresses['jax']}"
    _setup(port, ref)
    events = {}
    for name, trainer in (("torch", port), ("jax", ref)):
        sub = Subscriber(addresses[name])
        sub.join(trainer._zmq_reporter)
        trainer.train()
        events[name] = sub.drain()
    kinds = [[m["what"] for m in events[n]] for n in ("torch", "jax")]
    assert kinds[0] == kinds[1]
    assert kinds[0] == (["epoch_begin"] + ["batch_end"] * 3 + ["epoch_end"]) * 2 + ["train_end"]
    for g, w in zip(events["torch"], events["jax"]):
        assert sorted(g) == sorted(w)
        for k in ("epoch", "batch"):
            assert g.get(k) == w.get(k)
        for k in w.get("logs", {}):
            np.testing.assert_allclose(g["logs"][k], w["logs"][k], rtol=LOSS_RTOL, err_msg=str(w))
    rows = port.log_rows
    epoch_ends = [m for m in events["torch"] if m["what"] == "epoch_end"]
    assert [m["logs"] for m in epoch_ends] == [{"loss": r["loss"], "val_loss": r["val_loss"]} for r in rows]


def test_reporting_changes_no_loss():
    """With or without the reporter (eager or deferred loss fetches), the
    port's losses are the same."""
    losses = []
    for publish in (False, True):
        port, _ = _trainers(publish_updates=publish, publish_address=f"tcp://127.0.0.1:{_free_port()}")
        port.train()
        losses.append([(r["loss"], r["val_loss"]) for r in port.log_rows])
    assert losses[0] == losses[1]


def _logged_lrs(trainer):
    with open(f"{trainer.run_path}/training_log.csv") as f:
        return [(int(r["epoch"]), float(r["lr"])) for r in csv.DictReader(f)]


@pytest.mark.parametrize("command", ["set_lr", "stop"])
def test_commands_act_mid_run_as_in_jax(tmp_path, monkeypatch, command):
    """The command is sent over and over from before the first batch: a
    ``set_lr`` of 1e-5 shows in every log row, a ``stop`` ends the run after
    its first epoch; the same in both packages."""
    rows = {}
    for name in ("torch", "jax"):
        address = _free_port()
        port, ref = _trainers(epochs=3, subscribe_to_controller=True,
                              controller_address=f"tcp://127.0.0.1:{address}", controller_polling_timeout=5)
        trainer = port if name == "torch" else ref
        out = trainer.config.outputs
        out.save_outputs, out.save_visualizations = True, False
        out.runs_folder, out.run_name = str(tmp_path / name), command
        monkeypatch.setattr(trainer, "evaluate", lambda: None)
        message = {"command": "set_lr", "lr": 1e-5} if command == "set_lr" else {"command": "stop"}
        commander = Commander(address, message)
        try:
            trainer.setup()
            # The trainer's SUB has joined once a command waits in it.
            assert trainer._zmq_controller.socket.poll(10000, zmq.POLLIN)
            trainer.train()
        finally:
            commander.stop()
            if name == "jax":  # the JAX trainer leaves its controller open
                trainer._zmq_controller.socket.close(linger=0)
                trainer._zmq_controller.context.term()
        rows[name] = _logged_lrs(trainer)
    assert rows["torch"] == rows["jax"]
    if command == "set_lr":
        assert rows["torch"] == [(0, 1e-5), (1, 1e-5), (2, 1e-5)]
    else:
        assert rows["torch"] == [(0, 1e-4)]
