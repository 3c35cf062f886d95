"""Generic encoder-decoder backbone (PyTorch).

Port of :mod:`sleap_tpu.models.encoder_decoder`. Architectures are described
by the same tagged plain tuples (the factories below are JAX-free copies of
the JAX package's, pinned equal by a test), and one
:class:`EncoderDecoderNet` executes any UNet-style stack of them with the
JAX module's wiring:

- encoder: a feature is recorded after every block that reaches a new
  stride; the deepest one is dropped (it is the encoder output itself);
- decoder: a feature is recorded *before* every block; each block's skip is
  the first feature, in stem + encoder order, whose stride is the one the
  block upsamples to. With a space-to-depth stem the stride-``f`` skip is
  the raw s2d map, not the first encoder block's output.

Only the plain math is ported. The JAX package's TPU layout forms of the same
functions (split convs over a virtual concat, the folded s2d stem, the fused
upsample+conv) compute ``conv(concat(...))`` up to float reassociation; here
that is written as concat -> conv. Layers live in one flat ``ModuleDict``
keyed by the flax layer names (``stack0_enc0_conv0`` ...), so a flax params
tree or a Keras weight file maps onto ``state_dict`` by name
(:mod:`sleap_tpu_torch.models.params`).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# --------------------------------------------------------------------------- #
# Block descriptor factories (tagged plain tuples, same fields as sleap_tpu)
# --------------------------------------------------------------------------- #


def SimpleConvBlock(
    pool: bool = True,
    pool_before_convs: bool = False,
    pooling_stride: int = 2,
    num_convs: int = 2,
    filters: int = 32,
    kernel_size: int = 3,
    use_bias: bool = True,
    batch_norm: bool = False,
    activation: str = "relu",
) -> tuple:
    """[pool] -> num_convs x (conv -> [BN] -> act) [-> pool]."""
    return (
        "simple_conv",
        pool,
        pool_before_convs,
        pooling_stride,
        num_convs,
        filters,
        kernel_size,
        use_bias,
        batch_norm,
        activation,
    )


def PoolingBlock(pool: bool = True, pooling_stride: int = 2) -> tuple:
    """Standalone max pool (UNet's trailing pool)."""
    return ("pooling", pool, pooling_stride)


def StemBlock(
    pool: bool = True,
    pooling_stride: int = 4,
    filters: int = 128,
    output_filters: int = 256,
) -> tuple:
    """Hourglass stem."""
    return ("hg_stem", pool, pooling_stride, filters, output_filters)


def DownsamplingBlock(filters: int = 256) -> tuple:
    """Hourglass encoder block: pool(s2) -> conv3x3+BN."""
    return ("hg_down", True, 2, filters)


def SpaceToDepthBlock(factor: int = 2) -> tuple:
    """Lossless pixel-shuffle stem: (H, W, C) -> (H/f, W/f, C*f*f)."""
    return ("s2d", True, factor)


def SimpleUpsamplingBlock(
    upsampling_stride: int = 2,
    transposed_conv: bool = False,
    transposed_conv_filters: int = 64,
    transposed_conv_kernel_size: int = 3,
    transposed_conv_use_bias: bool = True,
    transposed_conv_batch_norm: bool = True,
    transposed_conv_activation: str = "relu",
    interp_method: str = "bilinear",
    skip_connection: bool = False,
    skip_add: bool = False,
    refine_convs: int = 2,
    refine_convs_first_filters: Optional[int] = None,
    refine_convs_filters: int = 64,
    refine_convs_kernel_size: int = 3,
    refine_convs_use_bias: bool = True,
    refine_convs_batch_norm: bool = True,
    refine_convs_activation: str = "relu",
) -> tuple:
    """(transposed conv | interp) -> [skip concat/add] -> refine convs."""
    return (
        "simple_up",
        upsampling_stride,
        transposed_conv,
        transposed_conv_filters,
        transposed_conv_kernel_size,
        transposed_conv_use_bias,
        transposed_conv_batch_norm,
        transposed_conv_activation,
        interp_method,
        skip_connection,
        skip_add,
        refine_convs,
        refine_convs_first_filters,
        refine_convs_filters,
        refine_convs_kernel_size,
        refine_convs_use_bias,
        refine_convs_batch_norm,
        refine_convs_activation,
    )


def HourglassUpsamplingBlock(filters: int = 256, interp_method: str = "nearest") -> tuple:
    """Hourglass decoder block."""
    return ("hg_up", 2, filters, interp_method)


def block_pool(blk: tuple) -> bool:
    """Whether this encoder block downsamples."""
    kind = blk[0]
    if kind in ("simple_conv", "pooling", "hg_stem", "hg_down", "s2d"):
        return bool(blk[1])
    return False


def block_pooling_stride(blk: tuple) -> int:
    if blk[0] == "simple_conv":
        return int(blk[3])
    if blk[0] in ("pooling", "hg_stem", "hg_down", "s2d"):
        return int(blk[2])
    return 1


def block_upsampling_stride(blk: tuple) -> int:
    return int(blk[1])


def first_conv(stem_blocks: tuple, encoder_blocks: tuple) -> Tuple[str, int]:
    """(layer name, s2d channel fold) of the first conv the input reaches.

    The fold is the product of ``f * f`` over the s2d blocks in front of that
    conv, so a checkpoint's input channel count is ``kernel_in // fold``.
    """
    fold = 1
    for prefix, blocks in (("stem", stem_blocks), ("stack0_enc", encoder_blocks)):
        for i, blk in enumerate(blocks):
            if blk[0] == "s2d":
                fold *= int(blk[2]) ** 2
            elif blk[0] == "simple_conv" and blk[4] > 0:
                return f"{prefix}{i}_conv0", fold
    raise ValueError("Backbone has no input convolution.")


# --------------------------------------------------------------------------- #
# Functional pieces (NCHW)
# --------------------------------------------------------------------------- #


class IntermediateFeature(NamedTuple):
    """An activation tensor tagged with its stride relative to the input."""

    tensor: Any
    stride: int


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*f*f, H/f, W/f), channel ``(dy*f + dx)*C + c``.

    The JAX stem's channel order. ``F.pixel_unshuffle`` orders channels
    ``c*f*f + dy*f + dx``, which agrees only when C == 1.
    """
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (n, dy, dx, c, h/f, w/f)
    return x.reshape(n, factor * factor * c, h // factor, w // factor)


def max_pool_same(x: torch.Tensor, stride: int, pool_size: int = 2) -> torch.Tensor:
    """``flax.linen.max_pool(..., padding="SAME")``: -inf padding, split
    ``total // 2`` before and the rest after, as XLA's SAME rule."""

    def pads(n: int) -> Tuple[int, int]:
        out = -(-n // stride)
        total = max((out - 1) * stride + pool_size - n, 0)
        return total // 2, total - total // 2

    (top, bottom), (left, right) = pads(x.shape[-2]), pads(x.shape[-1])
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, pool_size, stride)


def upsample(x: torch.Tensor, stride: int, method: str) -> torch.Tensor:
    """UpSampling2D: nearest repeat or half-pixel bilinear (no antialias)."""
    if method == "nearest":
        return x.repeat_interleave(stride, dim=2).repeat_interleave(stride, dim=3)
    return F.interpolate(x, scale_factor=stride, mode="bilinear", align_corners=False)


def apply_activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """Activation by name; softmax runs over channels (axis 1 in NCHW)."""
    if name == "relu":
        return F.relu(x)
    if name == "linear":
        return x
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softmax":
        return torch.softmax(x, dim=1)
    raise ValueError(f"Unknown activation {name!r}.")


def _conv_transpose_pad_before(kernel_size: int, stride: int) -> int:
    """Leading pad of ``lax.conv_transpose(padding="SAME")`` on the dilated
    input (jax ``_conv_transpose_padding``)."""
    pad_len = kernel_size + stride - 2
    if stride > kernel_size - 1:
        return kernel_size - 1
    return -(-pad_len // 2)


class ConvTransposeSame(nn.ConvTranspose2d):
    """``flax.linen.ConvTranspose(strides=s, padding="SAME")`` on NCHW.

    Flax (``transpose_kernel=False``) correlates the zero-dilated input with
    its HWIO kernel ``K`` under SAME padding ``(pad_before, pad_after)``.
    ``F.conv_transpose2d`` with weight ``flip_hw(K)`` in (in, out, kh, kw)
    layout computes the same sum over the fully padded dilated input, so the
    flax output is the window of length ``s * H`` that starts at
    ``k - 1 - pad_before``. For k=3, s=2 that drops the last row and column.
    Keeping ``K`` unflipped with ``padding=1, output_padding=1`` is NOT
    equivalent. The flip is applied when weights are loaded
    (:mod:`sleap_tpu_torch.models.params`).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, bias=bias)
        self.offset = kernel_size - 1 - _conv_transpose_pad_before(kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight, self.bias, stride=self.stride)
        s = self.stride[0]
        h, w = x.shape[-2] * s, x.shape[-1] * s
        o = self.offset
        return y[..., o:o + h, o:o + w]


# --------------------------------------------------------------------------- #
# Executor module
# --------------------------------------------------------------------------- #


class EncoderDecoderNet(nn.Module):
    """Executes (stem, encoder, decoder) block-descriptor stacks on NCHW.

    ``forward`` returns ``(output, intermediates)``: the decoder output and
    the stride-tagged features recorded before each decoder block. Block
    kinds: ``simple_conv``, ``pooling``, ``s2d`` and ``simple_up`` with
    concatenated skips (the UNet's). Hourglass blocks, batch norm, additive
    skips and stacked nets are not ported yet and raise
    ``NotImplementedError`` (ROADMAP.md, queue 1, item 12).
    """

    def __init__(
        self,
        stem_blocks: tuple,
        encoder_blocks: tuple,
        decoder_blocks: tuple,
        in_channels: int,
        stacks: int = 1,
    ):
        super().__init__()
        if stacks != 1:
            raise NotImplementedError("Stacked encoder-decoders are not ported yet.")
        self.stem_blocks = tuple(stem_blocks)
        self.encoder_blocks = tuple(encoder_blocks)
        self.decoder_blocks = tuple(decoder_blocks)
        self.layers = nn.ModuleDict()

        # Skip sources: (stride, channels, key); key "stem" or an encoder
        # block index. Only the first source at each stride is ever used.
        c, stride = int(in_channels), 1
        for i, blk in enumerate(self.stem_blocks):
            c = self._add_encoder_layers(blk, f"stem{i}", c)
            stride *= block_pooling_stride(blk) if block_pool(blk) else 1
        sources: List[Tuple[int, int, Any]] = []
        if self.stem_blocks:
            sources.append((stride, c, "stem"))
        enc_sources: List[Tuple[int, int, Any]] = []
        for i, blk in enumerate(self.encoder_blocks):
            c = self._add_encoder_layers(blk, f"stack0_enc{i}", c)
            stride *= block_pooling_stride(blk) if block_pool(blk) else 1
            if stride not in [s for s, _, _ in enc_sources]:
                enc_sources.append((stride, c, i))
        sources += enc_sources[:-1]
        self._kept = {key for _, _, key in sources}
        self._encoder_stride = stride

        self._skips: List[Any] = []
        self.feature_channels = {}
        for i, blk in enumerate(self.decoder_blocks):
            self.feature_channels.setdefault(stride, c)
            stride //= block_upsampling_stride(blk)
            src = next(((ch, key) for s, ch, key in sources if s == stride), None)
            self._skips.append(None if src is None else src[1])
            c = self._add_decoder_layers(
                blk, f"stack0_dec{i}", c, None if src is None else src[0]
            )
        self.out_channels = c
        self.output_stride = stride

    # -- construction ---------------------------------------------------- #
    def _add_encoder_layers(self, blk: tuple, prefix: str, c: int) -> int:
        kind = blk[0]
        if kind == "simple_conv":
            (_, _, _, _, num_convs, filters, ksize, use_bias, batch_norm, _) = blk
            if batch_norm:
                raise NotImplementedError("Batch norm is not ported yet.")
            for i in range(num_convs):
                self.layers[f"{prefix}_conv{i}"] = nn.Conv2d(
                    c, int(filters), ksize, padding="same", bias=use_bias
                )
                c = int(filters)
            return c
        if kind == "pooling":
            return c
        if kind == "s2d":
            return c * int(blk[2]) ** 2
        raise NotImplementedError(f"Encoder block kind {kind!r} is not ported yet.")

    def _add_decoder_layers(
        self, blk: tuple, prefix: str, c: int, skip_c: Optional[int]
    ) -> int:
        if blk[0] != "simple_up":
            raise NotImplementedError(f"Decoder block kind {blk[0]!r} is not ported yet.")
        (_, up_stride, t_conv, t_filters, t_ksize, t_bias, t_bn, _, _, skip_conn,
         skip_add, n_refine, r_first, r_filters, r_ksize, r_bias, r_bn, _) = blk
        if (t_conv and t_bn) or (n_refine and r_bn):
            raise NotImplementedError("Batch norm is not ported yet.")
        if skip_conn and skip_add:
            raise NotImplementedError("Additive skip connections are not ported yet.")
        if t_conv:
            self.layers[f"{prefix}_trans_conv"] = ConvTransposeSame(
                c, int(t_filters), t_ksize, up_stride, bias=t_bias
            )
            c = int(t_filters)
        if skip_conn and skip_c is not None:
            c += skip_c
        for i in range(n_refine):
            filters = r_first if (i == 0 and r_first is not None) else r_filters
            self.layers[f"{prefix}_refine_conv{i}"] = nn.Conv2d(
                c, int(filters), r_ksize, padding="same", bias=r_bias
            )
            c = int(filters)
        return c

    # -- execution ------------------------------------------------------- #
    def _encoder_block(self, x: torch.Tensor, blk: tuple, prefix: str) -> torch.Tensor:
        kind = blk[0]
        if kind == "simple_conv":
            (_, pool, pool_before, pstride, num_convs, _, _, _, _, activation) = blk
            if pool and pool_before:
                x = max_pool_same(x, pstride)
            for i in range(num_convs):
                x = apply_activation(self.layers[f"{prefix}_conv{i}"](x), activation)
            if pool and not pool_before:
                x = max_pool_same(x, pstride)
            return x
        if kind == "pooling":
            return max_pool_same(x, blk[2]) if blk[1] else x
        return space_to_depth(x, int(blk[2]))  # "s2d"; others refused at init

    def _decoder_block(
        self, x: torch.Tensor, blk: tuple, skip: Optional[torch.Tensor], prefix: str
    ) -> torch.Tensor:
        (_, up_stride, t_conv, _, _, _, _, t_act, interp, skip_conn, _,
         n_refine, _, _, _, _, _, r_act) = blk
        if t_conv:
            x = apply_activation(self.layers[f"{prefix}_trans_conv"](x), t_act)
        else:
            x = upsample(x, up_stride, interp)
        if skip_conn and skip is not None:
            x = torch.cat([skip, x], dim=1)
        for i in range(n_refine):
            x = apply_activation(self.layers[f"{prefix}_refine_conv{i}"](x), r_act)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[IntermediateFeature]]:
        for i, blk in enumerate(self.stem_blocks):
            x = self._encoder_block(x, blk, f"stem{i}")
        feats = {"stem": x} if self.stem_blocks else {}
        for i, blk in enumerate(self.encoder_blocks):
            x = self._encoder_block(x, blk, f"stack0_enc{i}")
            if i in self._kept:
                feats[i] = x
        intermediates = []
        stride = self._encoder_stride
        for i, blk in enumerate(self.decoder_blocks):
            intermediates.append(IntermediateFeature(x, stride))
            key = self._skips[i]
            x = self._decoder_block(x, blk, None if key is None else feats[key], f"stack0_dec{i}")
            stride //= block_upsampling_stride(blk)
        return x, intermediates
