"""LEAP CNN backbone description (JAX-free port of :mod:`sleap_tpu.models.leap`).

A plain encoder-decoder without skip connections or batch norm: its blocks
are the JAX package's descriptor tuples, which
:class:`~sleap_tpu_torch.models.encoder_decoder.EncoderDecoderNet` runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from sleap_tpu_torch.models.encoder_decoder import SimpleConvBlock, SimpleUpsamplingBlock


@dataclass(frozen=True)
class LeapCNN:
    filters: int = 64
    filters_rate: float = 2
    down_blocks: int = 3
    down_convs_per_block: int = 3
    up_blocks: int = 3
    up_interpolate: bool = False
    up_convs_per_block: int = 2
    stacks: int = 1
    kernel_size: int = 3

    @property
    def maximum_stride(self) -> int:
        return 2**self.down_blocks

    @property
    def output_stride(self) -> int:
        return 2 ** (self.down_blocks - self.up_blocks)

    def make_stem_blocks(self) -> tuple:
        return ()

    def make_encoder_blocks(self) -> tuple:
        return tuple(
            SimpleConvBlock(
                pool=True,
                pool_before_convs=False,
                pooling_stride=2,
                num_convs=self.down_convs_per_block,
                filters=int(self.filters * (self.filters_rate**i)),
                kernel_size=self.kernel_size,
                use_bias=True,
                batch_norm=False,
                activation="relu",
            )
            for i in range(self.down_blocks)
        )

    def make_decoder_blocks(self) -> tuple:
        blocks = []
        for i in range(self.up_blocks, 0, -1):
            block_filters = int(self.filters * (self.filters_rate**i))
            blocks.append(
                SimpleUpsamplingBlock(
                    upsampling_stride=2,
                    transposed_conv=(not self.up_interpolate),
                    transposed_conv_filters=block_filters,
                    transposed_conv_kernel_size=self.kernel_size,
                    transposed_conv_batch_norm=False,
                    transposed_conv_activation="relu",
                    interp_method="bilinear",
                    skip_connection=False,
                    refine_convs=self.up_convs_per_block,
                    refine_convs_filters=block_filters,
                    refine_convs_kernel_size=self.kernel_size,
                    refine_convs_batch_norm=False,
                    refine_convs_activation="relu",
                )
            )
        return tuple(blocks)

    @classmethod
    def from_config(cls, config) -> "LeapCNN":
        """From a ``LEAPConfig`` (either package's, read by attribute)."""
        return cls(
            filters=config.filters,
            filters_rate=config.filters_rate,
            down_blocks=int(math.log2(config.max_stride)),
            down_convs_per_block=3,
            up_blocks=int(math.log2(config.max_stride / config.output_stride)),
            up_interpolate=config.up_interpolate,
            up_convs_per_block=2,
            stacks=config.stacks,
        )
