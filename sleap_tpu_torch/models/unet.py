"""UNet backbone description (JAX-free port of :mod:`sleap_tpu.models.unet`).

Block and filter arithmetic is the JAX package's, so both packages build the
same descriptor tuples from one config (pinned by a test) and the layer
names of a flax or Keras checkpoint line up with the torch module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from sleap_tpu_torch.models.encoder_decoder import (
    PoolingBlock,
    SimpleConvBlock,
    SimpleUpsamplingBlock,
    SpaceToDepthBlock,
)


@dataclass(frozen=True)
class UNet:
    """UNet architecture description.

    ``space_to_depth``: pixel-shuffle the input by this factor before the
    first conv block (a lossless stem that counts toward ``maximum_stride``).
    """

    filters: int = 64
    filters_rate: float = 2
    kernel_size: int = 3
    stem_kernel_size: int = 3
    convs_per_block: int = 2
    stem_blocks: int = 0
    down_blocks: int = 4
    middle_block: bool = True
    up_blocks: int = 4
    up_interpolate: bool = False
    block_contraction: bool = False
    stacks: int = 1
    space_to_depth: int = 1

    @property
    def maximum_stride(self) -> int:
        return self.space_to_depth * 2 ** (self.stem_blocks + self.down_blocks)

    @property
    def output_stride(self) -> int:
        return self.maximum_stride // (2**self.up_blocks)

    def _block_filters(self, block: int) -> int:
        return int(self.filters * (self.filters_rate**block))

    def make_stem_blocks(self) -> tuple:
        s2d = (SpaceToDepthBlock(self.space_to_depth),) if self.space_to_depth > 1 else ()
        if self.stem_blocks == 0:
            return s2d
        blocks = list(s2d)
        for block in range(self.stem_blocks):
            blocks.append(
                SimpleConvBlock(
                    pool=(block > 0),
                    pool_before_convs=True,
                    pooling_stride=2,
                    num_convs=self.convs_per_block,
                    filters=self._block_filters(block),
                    kernel_size=self.stem_kernel_size,
                    use_bias=True,
                    batch_norm=False,
                    activation="relu",
                )
            )
        blocks.append(PoolingBlock(pool=True, pooling_stride=2))
        return tuple(blocks)

    def make_encoder_blocks(self) -> tuple:
        blocks = []
        for block in range(self.down_blocks):
            blocks.append(
                SimpleConvBlock(
                    pool=(block > 0),
                    pool_before_convs=True,
                    pooling_stride=2,
                    num_convs=self.convs_per_block,
                    filters=self._block_filters(block + self.stem_blocks),
                    kernel_size=self.kernel_size,
                    use_bias=True,
                    batch_norm=False,
                    activation="relu",
                )
            )
        blocks.append(PoolingBlock(pool=True, pooling_stride=2))

        if self.middle_block:
            deep = self.down_blocks + self.stem_blocks
            if self.convs_per_block > 1:
                blocks.append(
                    SimpleConvBlock(
                        pool=False,
                        num_convs=self.convs_per_block - 1,
                        filters=self._block_filters(deep),
                        kernel_size=self.kernel_size,
                        use_bias=True,
                        batch_norm=False,
                        activation="relu",
                    )
                )
            contract = deep - 1 if self.block_contraction else deep
            blocks.append(
                SimpleConvBlock(
                    pool=False,
                    num_convs=1,
                    filters=self._block_filters(contract),
                    kernel_size=self.kernel_size,
                    use_bias=True,
                    batch_norm=False,
                    activation="relu",
                )
            )
        return tuple(blocks)

    def make_decoder_blocks(self) -> tuple:
        blocks = []
        for block in range(self.up_blocks):
            depth = self.down_blocks + self.stem_blocks - 1 - block
            filters_in = self._block_filters(depth)
            filters_out = (
                self._block_filters(depth - 1) if self.block_contraction else filters_in
            )
            blocks.append(
                SimpleUpsamplingBlock(
                    upsampling_stride=2,
                    transposed_conv=(not self.up_interpolate),
                    transposed_conv_filters=filters_in,
                    transposed_conv_kernel_size=self.kernel_size,
                    transposed_conv_batch_norm=False,
                    interp_method="bilinear",
                    skip_connection=True,
                    skip_add=False,
                    refine_convs=self.convs_per_block,
                    refine_convs_first_filters=filters_in,
                    refine_convs_filters=filters_out,
                    refine_convs_kernel_size=self.kernel_size,
                    refine_convs_batch_norm=False,
                )
            )
        return tuple(blocks)

    @classmethod
    def from_config(cls, config) -> "UNet":
        """From a ``sleap_tpu.config.UNetConfig`` (read by attribute only)."""
        s2d = int(getattr(config, "space_to_depth", 1) or 1)
        stem_blocks = 0
        if config.stem_stride is not None:
            stem_blocks = int(math.log2(config.stem_stride))
        down_blocks = int(math.log2(config.max_stride)) - stem_blocks - int(math.log2(s2d))
        up_blocks = int(math.log2(config.max_stride / config.output_stride))
        return cls(
            filters=config.filters,
            filters_rate=config.filters_rate,
            kernel_size=3,
            stem_kernel_size=7,
            convs_per_block=2,
            stem_blocks=stem_blocks,
            down_blocks=down_blocks,
            middle_block=config.middle_block,
            up_blocks=up_blocks,
            up_interpolate=config.up_interpolate,
            stacks=config.stacks,
            space_to_depth=s2d,
        )
