"""Example-stream transformers (port of :mod:`sleap_tpu.data.dataset_ops`).

Providers are plain iterables of example dicts, so each block is a small
host iterator adaptor with a ``transform_dataset(examples)`` method:
``Shuffler``, ``Batcher``, ``Unbatcher``, ``Repeater``, ``Prefetcher``,
``Preloader``, ``LambdaFilter``, ``KeyRenamer``, ``KeyFilter`` and
``LambdaMap``; and the labels split and example grouping helpers. The
blocks hold numpy values; the per-example math of training and inference
runs on the device in the trainer's and the predictors' batch functions.
``Shuffler`` and :func:`split_labels_train_val` draw from
``random.Random(seed)``, as the JAX package's do, so a seed gives the same
order in both packages.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from sleap_tpu_torch.data.prefetch import prefetch as _prefetch


@dataclass
class Shuffler:
    """Shuffle examples through a buffer of ``buffer_size``, then the rest
    at the end."""

    shuffle: bool = True
    buffer_size: int = 64
    seed: Optional[int] = None

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        if not self.shuffle:
            yield from examples
            return
        rng = random.Random(self.seed)
        buf: List[dict] = []
        for ex in examples:
            buf.append(ex)
            if len(buf) >= self.buffer_size:
                idx = rng.randrange(len(buf))
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
        rng.shuffle(buf)
        yield from buf


def _fill_value(dtype: np.dtype):
    """Padding of a key whose examples differ in shape: NaN for floats, -1
    for signed integers (0 is a real track index), 0 otherwise."""
    if np.issubdtype(dtype, np.floating):
        return np.nan
    if np.issubdtype(dtype, np.signedinteger):
        return -1
    return 0


@dataclass
class Batcher:
    """Collate example dicts into dense batches; a key whose examples
    differ in shape is padded to the largest (see :func:`_fill_value`)."""

    batch_size: int = 4
    drop_remainder: bool = False

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        buf: List[dict] = []
        for ex in examples:
            buf.append(ex)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._collate(buf)

    @staticmethod
    def _collate(buf: List[dict]) -> dict:
        out: Dict[str, Any] = {}
        for key in buf[0]:
            vals = [np.asarray(ex[key]) for ex in buf]
            if len({v.shape for v in vals}) == 1:
                out[key] = np.stack(vals)
                continue
            maxd = [max(v.shape[d] for v in vals) for d in range(vals[0].ndim)]
            out[key] = np.stack([
                np.pad(v, [(0, m - s) for s, m in zip(v.shape, maxd)],
                       constant_values=_fill_value(v.dtype))
                for v in vals
            ])
        return out


@dataclass
class Unbatcher:
    """Split batch dicts back into per-example dicts."""

    def transform_dataset(self, batches: Iterable[dict]) -> Iterator[dict]:
        for batch in batches:
            n = len(next(iter(batch.values())))
            for i in range(n):
                yield {k: v[i] for k, v in batch.items()}


@dataclass
class Repeater:
    """Repeat the stream ``epochs`` times (-1: forever). The source must be
    iterable again (a provider), not a generator."""

    repeat: bool = True
    epochs: int = -1

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        if not self.repeat:
            yield from examples
            return
        n = 0
        while self.epochs < 0 or n < self.epochs:
            yielded = False
            for ex in examples:
                yielded = True
                yield ex
            if not yielded:
                return
            n += 1


@dataclass
class Prefetcher:
    """A producer thread ``buffer_size`` examples ahead of the consumer
    (:func:`~sleap_tpu_torch.data.prefetch.prefetch`)."""

    prefetch: bool = True
    buffer_size: int = 1

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        if not self.prefetch:
            return iter(examples)
        return _prefetch(iter(examples), buffer_size=self.buffer_size)


@dataclass
class Preloader:
    """Read every example into memory."""

    def transform_dataset(self, examples: Iterable[dict]) -> List[dict]:
        return list(examples)


@dataclass
class LambdaFilter:
    """Keep the examples where ``filter_fn(example)`` is true."""

    filter_fn: Callable[[dict], bool] = lambda ex: True

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        return (ex for ex in examples if self.filter_fn(ex))


@dataclass
class KeyRenamer:
    """Rename (or, without ``drop_old``, copy) ``old_key_names`` to
    ``new_key_names`` pairwise."""

    old_key_names: Sequence[str] = ()
    new_key_names: Sequence[str] = ()
    drop_old: bool = True

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            ex = dict(ex)
            for old, new in zip(self.old_key_names, self.new_key_names):
                if old in ex:
                    ex[new] = ex[old]
                    if self.drop_old and new != old:
                        del ex[old]
            yield ex


@dataclass
class KeyFilter:
    """Keep only ``keep_keys`` (every key when it is empty)."""

    keep_keys: Sequence[str] = ()

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        keep = set(self.keep_keys)
        for ex in examples:
            yield {k: v for k, v in ex.items() if not keep or k in keep}


@dataclass
class LambdaMap:
    """Apply ``map_fn`` to each example."""

    map_fn: Callable[[dict], dict] = lambda ex: ex

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        return (self.map_fn(ex) for ex in examples)


def split_labels_train_val(labels, validation_fraction: float, seed: Optional[int] = None):
    """Split the frames with user instances (all frames if none has one)
    at random into ``(train_labels, val_labels)``, the port's ``Labels``;
    each side gets at least one frame when there are two or more."""
    from sleap_tpu_torch.core.labels import Labels

    lfs = [lf for lf in labels if len(lf.user_instances) > 0] or list(labels)
    idx = list(range(len(lfs)))
    random.Random(seed).shuffle(idx)
    n_val = (min(max(1, int(round(len(lfs) * validation_fraction))), len(lfs) - 1)
             if len(lfs) > 1 else 0)
    val_idx = set(idx[:n_val])
    train = Labels([lfs[i] for i in range(len(lfs)) if i not in val_idx])
    val = Labels([lfs[i] for i in sorted(val_idx)])
    return train, val


def _frame_key(example: dict) -> tuple:
    return (int(np.asarray(example["video_ind"]).squeeze()),
            int(np.asarray(example["frame_ind"]).squeeze()))


def group_examples(examples: Iterable[dict]) -> Dict[tuple, List[dict]]:
    """Group inference examples by ``(video_ind, frame_ind)``."""
    grouped: Dict[tuple, List[dict]] = {}
    for example in examples:
        grouped.setdefault(_frame_key(example), []).append(example)
    return grouped


def group_examples_iter(examples: Iterable[dict]):
    """Yield ``(key, [examples])`` for each run of consecutive examples of
    the same frame (the per-instance examples of a top-down stream come in
    frame order)."""
    last_key, batch = None, []
    for example in examples:
        key = _frame_key(example)
        if last_key != key:
            if batch:
                yield last_key, batch
            last_key, batch = key, [example]
        else:
            batch.append(example)
    if batch:
        yield last_key, batch
