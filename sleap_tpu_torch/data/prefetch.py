"""Threaded host-side prefetching (a copy of :mod:`sleap_tpu.data.prefetch`).

A producer thread reads and batches the next frames while the device runs
the current batch: a bounded queue of ``buffer_size`` items, by default 2,
which is double buffering.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator


class ThreadedPrefetcher:
    """Wrap an iterator with a background producer thread; an exception in
    the producer is raised again in the consumer."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator[Any], buffer_size: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._error = None
        self._iterator = iterator
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        try:
            for item in self._iterator:
                self._queue.put(item)
        except BaseException as e:  # noqa: BLE001 - raised on the consumer side
            self._error = e
        finally:
            self._queue.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch(iterator: Iterator[Any], buffer_size: int = 2) -> Iterator[Any]:
    """``for batch in prefetch(batches): ...``"""
    return ThreadedPrefetcher(iterator, buffer_size=buffer_size)
