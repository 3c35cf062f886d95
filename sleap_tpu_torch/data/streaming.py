"""Host -> device staging for the inference loop (port of
:mod:`sleap_tpu.data.streaming`).

Batches arrive as uint8 frames; each is copied to the device from pinned host
memory with a non-blocking copy, ``depth`` batches ahead of the consumer, so
the copy engine runs while the device computes. Normalization is not done
here: it runs on the device so only 1 byte per pixel crosses the bus.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Tuple

import numpy as np
import torch


def stage_to_device(
    batches: Iterator[Tuple[dict, int]],
    device: torch.device,
    depth: int = 2,
) -> Iterator[Tuple[dict, int, torch.Tensor]]:
    """Yield ``(batch, n_valid, device_image)`` with copies kept in flight.

    ``device_image`` is the batch's ``image`` on (or on its way to) ``device``,
    ordered on the current stream, so work queued after it sees the data.
    Pinning applies to CUDA targets only; a CPU target gets the host tensor.
    """
    device = torch.device(device)
    in_flight: deque = deque()
    for batch, n_valid in batches:
        host = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        if device.type == "cuda":
            host = host.pin_memory()
        in_flight.append((batch, n_valid, host.to(device, non_blocking=True)))
        if len(in_flight) > depth:
            yield in_flight.popleft()
    while in_flight:
        yield in_flight.popleft()
