"""Training progress and control over ZMQ (port of
:mod:`sleap_tpu.training.callbacks`).

A PUB socket broadcasts the trainer's events and a SUB socket takes
``stop`` and ``set_lr`` commands, with the JAX package's JSON messages key
for key: ``{"what": "epoch_begin", "epoch"}``, ``{"what": "batch_end",
"epoch", "batch", "logs": {"loss"}}``, ``{"what": "epoch_end", "epoch",
"logs": {"loss", "val_loss"}}``, ``{"what": "train_end"}``; and
``{"command": "stop"}``, ``{"command": "set_lr", "lr"}``. ``zmq`` (pyzmq)
is imported when a socket is made; without it, that raises naming pyzmq.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

logger = logging.getLogger(__name__)


def _zmq():
    try:
        import zmq
    except ImportError as e:
        raise ImportError("ZMQ training progress and control need pyzmq, which is not "
                          "installed.") from e
    return zmq


class ProgressReporterZMQ:
    """A PUB socket bound to ``address`` that sends training events."""

    def __init__(self, address: str = "tcp://127.0.0.1:9001"):
        zmq = _zmq()
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PUB)
        self.socket.bind(address)

    def _send(self, what: str, **kwargs) -> None:
        self.socket.send_string(json.dumps({"what": what, **kwargs}))

    def epoch_begin(self, epoch: int) -> None:
        self._send("epoch_begin", epoch=epoch)

    def batch_end(self, epoch: int, batch: int, loss: float) -> None:
        self._send("batch_end", epoch=epoch, batch=batch, logs={"loss": loss})

    def epoch_end(self, epoch: int, loss: float, val_loss: float) -> None:
        self._send("epoch_end", epoch=epoch, logs={"loss": loss, "val_loss": val_loss})

    def close(self) -> None:
        """Send ``train_end`` and close the socket."""
        self._send("train_end")
        self.socket.close()
        self.context.term()


class TrainingControllerZMQ:
    """A SUB socket connected to ``address``, polled for commands for up
    to ``timeout`` ms at a time."""

    def __init__(self, address: str = "tcp://127.0.0.1:9000", timeout: int = 10):
        zmq = _zmq()
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.SUB)
        self.socket.setsockopt_string(zmq.SUBSCRIBE, "")
        self.socket.connect(address)
        self.timeout = timeout
        #: The last learning rate asked for, until the trainer takes it.
        self.requested_lr: Optional[float] = None

    def poll(self) -> Optional[str]:
        """"stop" if a stop command arrived, else None; a ``set_lr`` is
        kept in :attr:`requested_lr` (a malformed one is logged and
        dropped)."""
        zmq = _zmq()
        if self.socket.poll(self.timeout, zmq.POLLIN):
            msg = json.loads(self.socket.recv_string())
            command = msg.get("command")
            if command == "stop":
                return "stop"
            if command == "set_lr":
                logger.info("Remote set_lr: %s", msg.get("lr"))
                try:
                    self.requested_lr = float(msg.get("lr"))
                except (TypeError, ValueError):
                    logger.warning("Ignoring malformed set_lr: %r", msg.get("lr"))
        return None

    def take_requested_lr(self) -> Optional[float]:
        """The requested learning rate, if any, which is then cleared."""
        lr, self.requested_lr = self.requested_lr, None
        return lr

    def close(self) -> None:
        self.socket.close()
        self.context.term()
