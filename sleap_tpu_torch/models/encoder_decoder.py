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

The module also holds what every backbone is built from: flax's SAME
padding (:func:`same_pads`, :class:`Conv2dSame`, the SAME pools), flax's
batch norm (:class:`FlaxBatchNorm2d`), and :class:`FlaxLayers`, the base of
the ResNet, HRNet and pretrained-encoder modules.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sleap_tpu_torch.models.common import IntermediateFeature

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
            elif blk[0] == "hg_stem":
                return f"{prefix}{i}_conv7x7", fold
    raise ValueError("Backbone has no input convolution.")


# --------------------------------------------------------------------------- #
# Functional pieces (NCHW); flax's SAME padding
# --------------------------------------------------------------------------- #


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C*f*f, H/f, W/f), channel ``(dy*f + dx)*C + c``.

    The JAX stem's channel order. ``F.pixel_unshuffle`` orders channels
    ``c*f*f + dy*f + dx``, which agrees only when C == 1.
    """
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 3, 5, 1, 2, 4)  # (n, dy, dx, c, h/f, w/f)
    return x.reshape(n, factor * factor * c, h // factor, w // factor)


def same_pads(n: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"`` on an axis of length ``n``: the total pad
    ``max((ceil(n/s) - 1)*s + window - n, 0)``, ``total // 2`` before and
    the rest after. With stride 2 on an even length it is asymmetric: a
    3x3/2 conv pads (0, 1) where torch's ``padding=1`` pads (1, 1), and a
    7x7/2 conv pads (2, 3)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, window: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad the last two axes of ``x`` as XLA's SAME rule does for a square
    ``window`` at ``stride``."""
    (top, bottom), (left, right) = (same_pads(x.shape[-2], window, stride),
                                    same_pads(x.shape[-1], window, stride))
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


class Conv2dSame(nn.Conv2d):
    """``flax.linen.Conv(padding="SAME")``, strided, dilated and grouped
    included. A stride-1 conv pads ``dilation*(k-1)`` in all, the same on
    every input size, so an odd window pads symmetrically inside cuDNN; a
    strided conv pads explicitly by :func:`same_pads` first."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1, bias: bool = True):
        window = dilation * (kernel_size - 1) + 1
        symmetric = stride == 1 and window % 2 == 1
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(window - 1) // 2 if symmetric else 0,
                         dilation=dilation, groups=groups, bias=bias)
        self.window = None if symmetric else window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.window is not None:
            x = pad_same(x, self.window, self.stride[0])
        return super().forward(x)


class FlaxBatchNorm2d(nn.Module):
    """``flax.linen.BatchNorm(momentum=m, epsilon=eps)`` over the channels of
    NCHW, in training and in inference.

    Weight, bias and running statistics stay float32 when the module is cast
    to a half-precision dtype (``_apply`` keeps at least float32), as flax
    keeps its BatchNorm's under a bf16 ``dtype``; batch norm computes in at
    least float32 and its output takes the input's dtype.

    ``eval()``: the running statistics normalise (``F.batch_norm``, which
    takes a bf16 input with float32 parameters).

    ``train()``: flax's training rule, op for op. The batch's mean and
    variance over (N, H, W) are computed from the input in float32, the
    variance by flax's fast rule ``max(0, E[x^2] - E[x]^2)`` (biased); they
    normalise the batch as flax's ``_normalize`` does, ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``, with autograd through both
    statistics; and the running statistics move once a forward, by flax's
    ``r = m*r + (1 - m)*batch``. A Welford or two-pass variance (cuDNN's)
    is not the same function where a channel's spread is small beside its
    mean: after a ReLU, a channel of few nonzero values.
    """

    def __init__(self, channels: int, epsilon: float, momentum: float):
        super().__init__()
        self.epsilon = float(epsilon)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def _apply(self, fn, recurse=True):
        def at_least_float32(t):
            out = fn(t)
            return t.to(out.device) if out.is_floating_point() and out.dtype.itemsize < 4 else out

        return super()._apply(at_least_float32, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.epsilon)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = torch.clamp_min(xf.square().mean((0, 2, 3)) - mean.square(), 0.0)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def max_pool_same(x: torch.Tensor, stride: int, pool_size: int = 2) -> torch.Tensor:
    """``flax.linen.max_pool(..., padding="SAME")``: -inf padding."""
    return F.max_pool2d(pad_same(x, pool_size, stride, float("-inf")), pool_size, stride)


def avg_pool_same(x: torch.Tensor, stride: int, pool_size: int = 2) -> torch.Tensor:
    """``flax.linen.avg_pool(..., padding="SAME")``: zero padding that
    counts in the mean (flax's ``count_include_pad=True``)."""
    return F.avg_pool2d(pad_same(x, pool_size, stride), pool_size, stride)


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

class FlaxLayers(nn.Module):
    """A backbone whose layers live in one flat ``ModuleDict`` keyed by the
    flax layer names, so a flax variables tree maps onto ``state_dict`` by
    name (:mod:`sleap_tpu_torch.models.params`).

    ``flax_name`` is the backbone's key in the flax params tree (``backbone``
    under ``PoseNet``, ``backbone_module`` under ``BackboneWithHeads``);
    ``bn_epsilon`` and ``bn_momentum`` are its flax ``BatchNorm``'s.
    Subclasses set ``out_channels``, ``output_stride`` and
    ``feature_channels`` (stride -> channels of the first intermediate
    feature at that stride), which size the heads.
    """

    flax_name = "backbone"
    bn_epsilon = 1e-3
    bn_momentum = 0.99

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleDict()

    def _conv(self, name: str, c_in: int, c_out: int, k: int, stride: int = 1,
              bias: bool = True, dilation: int = 1, groups: int = 1) -> int:
        self.layers[name] = Conv2dSame(int(c_in), int(c_out), k, stride=stride,
                                       dilation=dilation, groups=int(groups), bias=bias)
        return int(c_out)

    def _bn(self, name: str, c: int) -> None:
        self.layers[name] = FlaxBatchNorm2d(int(c), self.bn_epsilon, self.bn_momentum)

    def _run(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.layers[name](x)

    # A backbone whose layer widths follow from its graph builds and runs
    # with one walk of that graph: while ``_build`` is set, ``x`` is a
    # channel count and each op below adds its layer and returns the count
    # it would produce; otherwise ``x`` is a tensor and the op runs.
    _build = False

    def _width(self, x) -> int:
        return x if self._build else int(x.shape[1])

    def _conv_op(self, x, name: str, c_out: int, k: int, stride: int = 1, bias: bool = True,
                 dilation: int = 1, groups: int = 1):
        if self._build:
            return self._conv(name, x, c_out, k, stride, bias, dilation, groups)
        return self._run(name, x)

    def _conv_transpose_op(self, x, name: str, c_out: int, k: int, stride: int = 2,
                           bias: bool = True):
        if self._build:
            self.layers[name] = ConvTransposeSame(x, int(c_out), k, stride, bias=bias)
            return int(c_out)
        return self._run(name, x)

    def _bn_op(self, x, name: str):
        if self._build:
            self._bn(name, x)
            return x
        return self._run(name, x)

    def _map(self, fn, x, *others):
        """``fn(x, *others)`` for an op that keeps ``x``'s width."""
        return x if self._build else fn(x, *others)

    def _cat(self, parts):
        return sum(parts) if self._build else torch.cat(parts, dim=1)


class EncoderDecoderNet(FlaxLayers):
    """Executes (stem, encoder, decoder) block-descriptor stacks on NCHW.

    ``forward`` returns ``(outputs, intermediates)``: each stack's decoder
    output, and for each stack the stride-tagged features recorded before
    each of its decoder blocks. Block kinds: ``simple_conv`` (conv ->
    [BN] -> act), ``pooling``, ``s2d``, ``simple_up`` with concatenated or
    added skips (an added skip of other width goes through a 1x1 conv
    ``{prefix}_skip_conv1x1``), and the hourglass blocks ``hg_stem``,
    ``hg_down`` and ``hg_up``, whose order is conv -> ReLU -> BN.

    With ``stacks > 1`` each stack's decoder output is the next stack's
    encoder input; the skips of every stack still come from the one stem
    output and that stack's own encoder, as in the JAX module.
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
        self.stem_blocks = tuple(stem_blocks)
        self.encoder_blocks = tuple(encoder_blocks)
        self.decoder_blocks = tuple(decoder_blocks)
        self.stacks = int(stacks)
        if self.stacks > 1:
            enc = math.prod(block_pooling_stride(b) for b in self.encoder_blocks if block_pool(b))
            dec = math.prod(block_upsampling_stride(b) for b in self.decoder_blocks)
            if enc != dec:
                raise ValueError(
                    "If using a stacked configuration, the backbone must define "
                    "symmetric encoder and decoder. Create a stem for initial "
                    "downsampling if an output stride > 1 is desired."
                )

        # Skip sources: (stride, channels, key); key "stem" or an encoder
        # block index. Only the first source at each stride is ever used.
        c, stride = int(in_channels), 1
        for i, blk in enumerate(self.stem_blocks):
            c = self._add_encoder_layers(blk, f"stem{i}", c)
            stride *= block_pooling_stride(blk) if block_pool(blk) else 1
        stem = [(stride, c, "stem")] if self.stem_blocks else []
        stem_stride = stride
        self._kept = set()
        self._skips: List[Any] = []
        for s in range(self.stacks):
            stride = stem_stride
            enc_sources: List[Tuple[int, int, Any]] = []
            for i, blk in enumerate(self.encoder_blocks):
                c = self._add_encoder_layers(blk, f"stack{s}_enc{i}", c)
                stride *= block_pooling_stride(blk) if block_pool(blk) else 1
                if stride not in [t for t, _, _ in enc_sources]:
                    enc_sources.append((stride, c, i))
            sources = stem + enc_sources[:-1]
            self._kept |= {key for _, _, key in sources}
            self._encoder_stride = stride
            skips, feature_channels = [], {}
            for i, blk in enumerate(self.decoder_blocks):
                feature_channels.setdefault(stride, c)
                stride //= block_upsampling_stride(blk)
                src = next(((ch, key) for t, ch, key in sources if t == stride), None)
                skips.append(None if src is None else src[1])
                c = self._add_decoder_layers(
                    blk, f"stack{s}_dec{i}", c, None if src is None else src[0]
                )
            self._skips = skips
            if s == 0:
                self.feature_channels = feature_channels
        self.out_channels = c
        self.output_stride = stride

    # -- construction ---------------------------------------------------- #
    def _add_encoder_layers(self, blk: tuple, prefix: str, c: int) -> int:
        kind = blk[0]
        if kind == "simple_conv":
            (_, _, _, _, num_convs, filters, ksize, use_bias, bn, _) = blk
            for i in range(num_convs):
                c = self._conv(f"{prefix}_conv{i}", c, filters, ksize, bias=use_bias)
                if bn:
                    self._bn(f"{prefix}_bn{i}", c)
            return c
        if kind == "pooling":
            return c
        if kind == "s2d":
            return c * int(blk[2]) ** 2
        if kind == "hg_stem":
            (_, pool, pstride, filters, output_filters) = blk
            s1 = 2 if (pool and pstride == 4) else 1
            c = self._conv(f"{prefix}_conv7x7", c, filters, 7, stride=s1)
            self._bn(f"{prefix}_conv7x7_bn", c)
            c = self._conv(f"{prefix}_conv3x3", c, 2 * filters, 3)
            self._bn(f"{prefix}_conv3x3_bn", c)
            c = self._conv(f"{prefix}_conv3x3_out", c, output_filters, 3)
            self._bn(f"{prefix}_conv3x3_out_bn", c)
            return c
        if kind == "hg_down":
            c = self._conv(f"{prefix}_conv", c, blk[3], 3)
            self._bn(f"{prefix}_bn", c)
            return c
        raise TypeError(f"Unknown encoder block kind {kind!r}")

    def _add_decoder_layers(
        self, blk: tuple, prefix: str, c: int, skip_c: Optional[int]
    ) -> int:
        if blk[0] == "hg_up":
            filters = int(blk[2])
            if skip_c is None:
                raise ValueError(f"{prefix}: an hourglass block needs a skip at its stride.")
            self._conv(f"{prefix}_conv", c, filters, 3)
            self._bn(f"{prefix}_conv_bn", filters)
            self._conv(f"{prefix}_skip", skip_c, filters, 3)
            self._bn(f"{prefix}_skip_bn", filters)
            return filters
        if blk[0] != "simple_up":
            raise TypeError(f"Unknown decoder block kind {blk[0]!r}")
        (_, up_stride, t_conv, t_filters, t_ksize, t_bias, t_bn, _, _, skip_conn,
         skip_add, n_refine, r_first, r_filters, r_ksize, r_bias, r_bn, _) = blk
        if t_conv:
            self.layers[f"{prefix}_trans_conv"] = ConvTransposeSame(
                c, int(t_filters), t_ksize, up_stride, bias=t_bias
            )
            c = int(t_filters)
            if t_bn:
                self._bn(f"{prefix}_trans_conv_bn", c)
        if skip_conn and skip_c is not None:
            if not skip_add:
                c += skip_c
            elif skip_c != c:
                self._conv(f"{prefix}_skip_conv1x1", skip_c, c, 1)
        for i in range(n_refine):
            filters = r_first if (i == 0 and r_first is not None) else r_filters
            c = self._conv(f"{prefix}_refine_conv{i}", c, filters, r_ksize, bias=r_bias)
            if r_bn:
                self._bn(f"{prefix}_refine_conv{i}_bn", c)
        return c

    # -- execution ------------------------------------------------------- #
    def _relu_bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The hourglass order: ReLU, then batch norm."""
        return self._run(name, F.relu(x))

    def _encoder_block(self, x: torch.Tensor, blk: tuple, prefix: str) -> torch.Tensor:
        kind = blk[0]
        if kind == "simple_conv":
            (_, pool, pool_before, pstride, num_convs, _, _, _, bn, activation) = blk
            if pool and pool_before:
                x = max_pool_same(x, pstride)
            for i in range(num_convs):
                x = self._run(f"{prefix}_conv{i}", x)
                if bn:
                    x = self._run(f"{prefix}_bn{i}", x)
                x = apply_activation(x, activation)
            if pool and not pool_before:
                x = max_pool_same(x, pstride)
            return x
        if kind == "pooling":
            return max_pool_same(x, blk[2]) if blk[1] else x
        if kind == "s2d":
            return space_to_depth(x, int(blk[2]))
        if kind == "hg_stem":
            (_, pool, pstride, _, _) = blk
            x = self._relu_bn(self._run(f"{prefix}_conv7x7", x), f"{prefix}_conv7x7_bn")
            x = self._relu_bn(self._run(f"{prefix}_conv3x3", x), f"{prefix}_conv3x3_bn")
            x = max_pool_same(x, 2 if (pool and pstride > 1) else 1)
            return self._relu_bn(self._run(f"{prefix}_conv3x3_out", x),
                                 f"{prefix}_conv3x3_out_bn")
        # "hg_down"
        x = max_pool_same(x, 2)
        return self._relu_bn(self._run(f"{prefix}_conv", x), f"{prefix}_bn")

    def _decoder_block(
        self, x: torch.Tensor, blk: tuple, skip: Optional[torch.Tensor], prefix: str
    ) -> torch.Tensor:
        if blk[0] == "hg_up":
            (_, up_stride, _, interp) = blk
            xm = self._relu_bn(self._run(f"{prefix}_conv", x), f"{prefix}_conv_bn")
            xm = upsample(xm, up_stride, interp)
            xs = self._relu_bn(self._run(f"{prefix}_skip", skip), f"{prefix}_skip_bn")
            return xm + xs
        (_, up_stride, t_conv, _, _, _, t_bn, t_act, interp, skip_conn, skip_add,
         n_refine, _, _, _, _, r_bn, r_act) = blk
        if t_conv:
            x = self._run(f"{prefix}_trans_conv", x)
            if t_bn:
                x = self._run(f"{prefix}_trans_conv_bn", x)
            x = apply_activation(x, t_act)
        else:
            x = upsample(x, up_stride, interp)
        if skip_conn and skip is not None:
            if not skip_add:
                x = torch.cat([skip, x], dim=1)
            elif f"{prefix}_skip_conv1x1" in self.layers:
                x = self._run(f"{prefix}_skip_conv1x1", skip) + x
            else:
                x = skip + x
        for i in range(n_refine):
            x = self._run(f"{prefix}_refine_conv{i}", x)
            if r_bn:
                x = self._run(f"{prefix}_refine_conv{i}_bn", x)
            x = apply_activation(x, r_act)
        return x

    def forward(
        self, x: torch.Tensor
    ) -> Tuple[List[torch.Tensor], List[List[IntermediateFeature]]]:
        for i, blk in enumerate(self.stem_blocks):
            x = self._encoder_block(x, blk, f"stem{i}")
        stem = {"stem": x} if self.stem_blocks else {}
        outputs, intermediates = [], []
        for s in range(self.stacks):
            feats = dict(stem)
            for i, blk in enumerate(self.encoder_blocks):
                x = self._encoder_block(x, blk, f"stack{s}_enc{i}")
                if i in self._kept:
                    feats[i] = x
            stack_feats = []
            stride = self._encoder_stride
            for i, blk in enumerate(self.decoder_blocks):
                stack_feats.append(IntermediateFeature(x, stride))
                key = self._skips[i]
                x = self._decoder_block(x, blk, None if key is None else feats[key],
                                        f"stack{s}_dec{i}")
                stride //= block_upsampling_stride(blk)
            outputs.append(x)
            intermediates.append(stack_feats)
        return outputs, intermediates
