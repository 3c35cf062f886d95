"""Shared model-building types (port of :mod:`sleap_tpu.models.common`)."""

from __future__ import annotations

from typing import Any, NamedTuple


class IntermediateFeature(NamedTuple):
    """An activation tensor tagged with its stride relative to the input."""

    tensor: Any
    stride: int
