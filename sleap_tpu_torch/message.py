"""Paired ZMQ messaging with a handshake: :mod:`sleap_tpu.message` for the
port, wire-compatible with it.

A ``PairedSender`` binds a PAIR socket and a ``PairedReceiver`` connects to
it; messages are JSON strings, an array a JSON header (its ``dtype`` and
``shape``) then its bytes, and the sender's handshake (``"hello"``) is
answered ``"hello back"``. ``zmq`` (pyzmq) is imported in ``setup``, as the
JAX module does; where it is absent, ``setup`` raises ``ImportError``
naming pyzmq.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

HANDSHAKE_MESSAGE = "hello"
HANDSHAKE_RESPONSE = "hello back"


def _import_zmq():
    try:
        import zmq
    except ImportError as e:
        raise ImportError("Paired messaging needs pyzmq (pip install pyzmq).") from e
    return zmq


class BaseMessageParticipant:
    def __init__(self, address: str = "tcp://127.0.0.1:9001"):
        self.address = address
        self.context = None
        self.socket = None

    def setup(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        if self.socket is not None:
            self.socket.close()
        if self.context is not None:
            self.context.term()


class PairedSender(BaseMessageParticipant):
    """Sends messages; its handshake confirms that a receiver listens."""

    def setup(self) -> None:
        zmq = _import_zmq()
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PAIR)
        self.socket.bind(self.address)

    def send_dict(self, data: Dict[str, Any]) -> None:
        self.socket.send_string(json.dumps(data))

    def send_array(self, header: Dict[str, Any], array) -> None:
        import numpy as np

        zmq = _import_zmq()
        header = dict(header)
        header["dtype"] = str(array.dtype)
        header["shape"] = list(array.shape)
        self.socket.send_string(json.dumps(header), flags=zmq.SNDMORE)
        self.socket.send(np.ascontiguousarray(array).tobytes())

    def send_handshake(self, timeout: float = 2.0) -> bool:
        zmq = _import_zmq()
        self.send_dict({"message": HANDSHAKE_MESSAGE})
        t0 = time.time()
        while time.time() - t0 < timeout:
            if self.socket.poll(100, zmq.POLLIN):
                reply = json.loads(self.socket.recv_string())
                if reply.get("message") == HANDSHAKE_RESPONSE:
                    return True
        return False


class PairedReceiver(BaseMessageParticipant):
    """Receives messages and answers the sender's handshake."""

    def setup(self) -> None:
        zmq = _import_zmq()
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PAIR)
        self.socket.connect(self.address)

    def check_messages(self, timeout: float = 0.01) -> List[Dict[str, Any]]:
        import numpy as np

        zmq = _import_zmq()
        messages = []
        while self.socket.poll(int(timeout * 1000), zmq.POLLIN):
            msg = json.loads(self.socket.recv_string())
            if msg.get("message") == HANDSHAKE_MESSAGE:
                self.socket.send_string(json.dumps({"message": HANDSHAKE_RESPONSE}))
                continue
            if "dtype" in msg and "shape" in msg:
                msg["array"] = np.frombuffer(self.socket.recv(), dtype=msg["dtype"]).reshape(msg["shape"])
            messages.append(msg)
        return messages
