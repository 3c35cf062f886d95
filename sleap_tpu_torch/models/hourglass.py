"""Stacked hourglass backbone description (JAX-free port of
:mod:`sleap_tpu.models.hourglass`).

The Associative Embedding variant: conv-only blocks, additive skips, batch
norm after every ReLU, and repeated stacks whose heads all predict
(intermediate supervision). Its blocks are the JAX package's descriptor
tuples, which :class:`~sleap_tpu_torch.models.encoder_decoder.EncoderDecoderNet`
runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from sleap_tpu_torch.models.encoder_decoder import (
    DownsamplingBlock,
    HourglassUpsamplingBlock,
    StemBlock,
)


@dataclass(frozen=True)
class Hourglass:
    down_blocks: int = 4
    up_blocks: int = 4
    stem_filters: int = 128
    stem_stride: int = 4
    filters: int = 256
    filter_increase: int = 128
    interp_method: str = "nearest"
    stacks: int = 3

    @property
    def maximum_stride(self) -> int:
        return self.stem_stride * (2**self.down_blocks)

    @property
    def output_stride(self) -> int:
        return self.maximum_stride // (2**self.up_blocks)

    def make_stem_blocks(self) -> tuple:
        return (
            StemBlock(
                pool=True,
                pooling_stride=self.stem_stride,
                filters=self.stem_filters,
                output_filters=self.filters,
            ),
        )

    def make_encoder_blocks(self) -> tuple:
        return tuple(
            DownsamplingBlock(filters=self.filters + i * self.filter_increase)
            for i in range(self.down_blocks)
        )

    def make_decoder_blocks(self) -> tuple:
        return tuple(
            HourglassUpsamplingBlock(
                filters=self.filters + (self.down_blocks - i - 1) * self.filter_increase,
                interp_method=self.interp_method,
            )
            for i in range(self.up_blocks)
        )

    @classmethod
    def from_config(cls, config) -> "Hourglass":
        """From a ``HourglassConfig`` (either package's, read by attribute)."""
        stem_blocks = int(math.log2(config.stem_stride))
        return cls(
            down_blocks=int(math.log2(config.max_stride)) - stem_blocks,
            up_blocks=int(math.log2(config.max_stride / config.output_stride)),
            stem_filters=config.stem_filters,
            stem_stride=config.stem_stride,
            filters=config.filters,
            filter_increase=config.filter_increase,
            interp_method="nearest",
            stacks=config.stacks,
        )
