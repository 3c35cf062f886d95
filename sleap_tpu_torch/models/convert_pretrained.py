"""Convert torchvision ImageNet weights to the local pretrained-encoder ``.npz``.

Port of :mod:`sleap_tpu.models.convert_pretrained`: a torchvision-layout
``state_dict`` (a mapping of tensors or numpy arrays; torchvision itself is
not needed) becomes the ``.npz`` the JAX package's converter writes, keyed
by flax paths (``backbone_module/<layer>/<leaf>``), so both packages read
one file from ``$SLEAP_TPU_PRETRAINED_DIR/<encoder>.npz``
(:meth:`sleap_tpu_torch.models.pretrained_encoder.UnetPretrainedEncoder.init_weights_hook`)::

    python -m sleap_tpu_torch.models.convert_pretrained resnet18-f37072fd.pth \
        --encoder resnet18 --out-dir ~/.sleap_tpu_pretrained
    export SLEAP_TPU_PRETRAINED_DIR=~/.sleap_tpu_pretrained

Layouts: conv kernels OIHW -> HWIO (depthwise ``(C, 1, k, k)`` ->
``(k, k, 1, C)`` by the same transpose); batch norm ``weight``/``bias`` ->
params ``scale``/``bias`` and ``running_mean``/``running_var`` ->
batch_stats ``mean``/``var``. Torchvision's ResNet-50 is v1.5 (stride on
the 3x3 conv) where these encoders are v1 (stride on the first 1x1): the
shapes agree, so the weights load, but strided blocks do not compute
torchvision's activations.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Iterable, List, Tuple

import numpy as np

from sleap_tpu_torch.models.pretrained_encoder import (
    _DENSENET_BLOCKS,
    _EFFNET_SCALING,
    _EFFNET_STAGES,
    _MBV2_STAGES,
    _RESNET_SPECS,
    _VGG_REPS,
    _round_repeats,
    AVAILABLE_ENCODERS,
)

PREFIX = "backbone_module"


def _conv_t(w: np.ndarray) -> np.ndarray:
    """torch OIHW -> flax HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _pairs_conv(flax_name: str, torch_name: str, bias: bool = False):
    out = [(f"{flax_name}/kernel", f"{torch_name}.weight", _conv_t)]
    if bias:
        out.append((f"{flax_name}/bias", f"{torch_name}.bias", None))
    return out


def _pairs_bn(flax_name: str, torch_name: str):
    return [
        (f"{flax_name}/scale", f"{torch_name}.weight", None),
        (f"{flax_name}/bias", f"{torch_name}.bias", None),
        (f"{flax_name}/mean", f"{torch_name}.running_mean", None),
        (f"{flax_name}/var", f"{torch_name}.running_var", None),
    ]


# --------------------------------------------------------------------------- #
# Per-family mapping specs: list of (flax_path, torch_key, transform)
# --------------------------------------------------------------------------- #


def _map_resnet(encoder: str) -> List[Tuple[str, str, Callable]]:
    # torchvision resnet18/34/50/101/152 AND resnext50_32x4d/resnext101_32x8d
    # share the layerN.M.{conv,bn,downsample} naming, so one mapper covers
    # both families (the grouped conv2 kernel converts with the same OIHW ->
    # HWIO transpose; flax feature_group_count splits along I the same way).
    blocks, bottleneck, _g, _w, _se = _RESNET_SPECS[encoder]
    pairs = _pairs_conv("stem_conv", "conv1") + _pairs_bn("stem_bn", "bn1")
    for si, nb in enumerate(blocks):
        for bi in range(nb):
            fl = f"stage{si + 1}_block{bi + 1}"
            th = f"layer{si + 1}.{bi}"
            n_convs = 3 if bottleneck else 2
            for ci in range(1, n_convs + 1):
                pairs += _pairs_conv(f"{fl}_conv{ci}", f"{th}.conv{ci}")
                pairs += _pairs_bn(f"{fl}_bn{ci}", f"{th}.bn{ci}")
            # Projection shortcut exists on the first block of each stage
            # except stage 1 of basic-block nets (stride 1, equal channels).
            if bi == 0 and (bottleneck or si > 0):
                pairs += _pairs_conv(f"{fl}_proj", f"{th}.downsample.0")
                pairs += _pairs_bn(f"{fl}_proj_bn", f"{th}.downsample.1")
    return pairs


def _map_vgg(encoder: str) -> List[Tuple[str, str, Callable]]:
    # torchvision vgg features conv indices, in order.
    feat_idx = {
        "vgg16": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
        "vgg19": [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34],
    }[encoder]
    reps = _VGG_REPS[encoder]
    pairs = []
    k = 0
    for si, n in enumerate(reps):
        for ri in range(n):
            pairs += _pairs_conv(
                f"block{si + 1}_conv{ri + 1}", f"features.{feat_idx[k]}", bias=True
            )
            k += 1
    return pairs


def _map_mobilenetv2() -> List[Tuple[str, str, Callable]]:
    pairs = _pairs_conv("stem_conv", "features.0.0") + _pairs_bn(
        "stem_bn", "features.0.1"
    )
    feat = 1
    for si, (t, c, reps, s) in enumerate(_MBV2_STAGES):
        for ri in range(reps):
            fl = f"block{si + 1}_{ri + 1}"
            th = f"features.{feat}.conv"
            if t == 1:
                pairs += _pairs_conv(f"{fl}_dw", f"{th}.0.0")
                pairs += _pairs_bn(f"{fl}_dw_bn", f"{th}.0.1")
                pairs += _pairs_conv(f"{fl}_project", f"{th}.1")
                pairs += _pairs_bn(f"{fl}_project_bn", f"{th}.2")
            else:
                pairs += _pairs_conv(f"{fl}_expand", f"{th}.0.0")
                pairs += _pairs_bn(f"{fl}_expand_bn", f"{th}.0.1")
                pairs += _pairs_conv(f"{fl}_dw", f"{th}.1.0")
                pairs += _pairs_bn(f"{fl}_dw_bn", f"{th}.1.1")
                pairs += _pairs_conv(f"{fl}_project", f"{th}.2")
                pairs += _pairs_bn(f"{fl}_project_bn", f"{th}.3")
            feat += 1
    pairs += _pairs_conv("top_conv", "features.18.0")
    pairs += _pairs_bn("top_bn", "features.18.1")
    return pairs


def _map_densenet(encoder: str) -> List[Tuple[str, str, Callable]]:
    pairs = _pairs_conv("stem_conv", "features.conv0") + _pairs_bn(
        "stem_bn", "features.norm0"
    )
    for bi, n_layers in enumerate(_DENSENET_BLOCKS[encoder]):
        for li in range(n_layers):
            fl = f"block{bi + 1}_layer{li + 1}"
            th = f"features.denseblock{bi + 1}.denselayer{li + 1}"
            pairs += _pairs_bn(f"{fl}_bn1", f"{th}.norm1")
            pairs += _pairs_conv(f"{fl}_conv1", f"{th}.conv1")
            pairs += _pairs_bn(f"{fl}_bn2", f"{th}.norm2")
            pairs += _pairs_conv(f"{fl}_conv2", f"{th}.conv2")
        if bi < 3:
            pairs += _pairs_bn(f"trans{bi + 1}_bn", f"features.transition{bi + 1}.norm")
            pairs += _pairs_conv(
                f"trans{bi + 1}_conv", f"features.transition{bi + 1}.conv"
            )
    pairs += _pairs_bn("final_bn", "features.norm5")
    return pairs


def _map_efficientnet(encoder: str) -> List[Tuple[str, str, Callable]]:
    _, depth_mult = _EFFNET_SCALING[encoder]
    pairs = _pairs_conv("stem_conv", "features.0.0") + _pairs_bn(
        "stem_bn", "features.0.1"
    )
    for si, (t, _c, reps, _s, _k) in enumerate(_EFFNET_STAGES):
        for ri in range(_round_repeats(reps, depth_mult)):
            fl = f"block{si + 1}{chr(97 + ri)}"
            th = f"features.{si + 1}.{ri}.block"
            if t == 1:
                dw, se, proj = f"{th}.0", f"{th}.1", f"{th}.2"
            else:
                pairs += _pairs_conv(f"{fl}_expand", f"{th}.0.0")
                pairs += _pairs_bn(f"{fl}_expand_bn", f"{th}.0.1")
                dw, se, proj = f"{th}.1", f"{th}.2", f"{th}.3"
            pairs += _pairs_conv(f"{fl}_dw", f"{dw}.0")
            pairs += _pairs_bn(f"{fl}_dw_bn", f"{dw}.1")
            pairs += _pairs_conv(f"{fl}_se_reduce", f"{se}.fc1", bias=True)
            pairs += _pairs_conv(f"{fl}_se_expand", f"{se}.fc2", bias=True)
            pairs += _pairs_conv(f"{fl}_project", f"{proj}.0")
            pairs += _pairs_bn(f"{fl}_project_bn", f"{proj}.1")
    pairs += _pairs_conv("top_conv", "features.8.0")
    pairs += _pairs_bn("top_bn", "features.8.1")
    return pairs


_MAPPERS = {}
for _n in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50", "resnext101"):
    _MAPPERS[_n] = (lambda n=_n: _map_resnet(n))
for _n in _VGG_REPS:
    _MAPPERS[_n] = (lambda n=_n: _map_vgg(n))
for _n in _DENSENET_BLOCKS:
    _MAPPERS[_n] = (lambda n=_n: _map_densenet(n))
for _n in _EFFNET_SCALING:
    _MAPPERS[_n] = (lambda n=_n: _map_efficientnet(n))
_MAPPERS["mobilenetv2"] = _map_mobilenetv2
# No torchvision checkpoints exist for mobilenet(v1) or the seresnet/
# seresnext family — those encoders build (random init) but have no
# converter mapping; convert timm checkpoints manually if needed.

# Accept torchvision model-zoo style aliases on the CLI.
_ALIASES = {
    "mobilenet_v2": "mobilenetv2",
    "resnext50_32x4d": "resnext50",
    "resnext101_32x8d": "resnext101",
}
for _i in range(8):
    _ALIASES["efficientnet_b%d" % _i] = "efficientnetb%d" % _i


def convert_torchvision_state_dict(
    state_dict: Dict[str, "np.ndarray"], encoder: str
) -> Dict[str, np.ndarray]:
    """Map a torchvision ``state_dict`` to ``{flax_path: array}``.

    ``state_dict`` values may be torch tensors or numpy arrays. Raises
    ``KeyError`` listing every expected-but-missing source key, so a wrong
    ``--encoder`` fails loudly instead of silently converting nothing.
    """
    encoder = _ALIASES.get(encoder, encoder)
    if encoder not in _MAPPERS:
        raise ValueError(
            f"Unsupported encoder {encoder!r}; available: {AVAILABLE_ENCODERS}"
        )

    def to_np(v):
        return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)

    pairs = _MAPPERS[encoder]()
    missing = [tk for _, tk, _ in pairs if tk not in state_dict]
    if missing:
        raise KeyError(
            f"{len(missing)} expected source keys absent (first 8: "
            f"{missing[:8]}); is this really a torchvision {encoder} "
            "state_dict?"
        )
    out = {}
    for flax_name, torch_key, transform in pairs:
        arr = to_np(state_dict[torch_key])
        out[f"{PREFIX}/{flax_name}"] = (
            transform(arr) if transform is not None else np.ascontiguousarray(arr)
        )
    return out


def convert_checkpoint(path: str, encoder: str, out_dir: str) -> str:
    """Convert a torchvision ``.pth``/``.pt`` checkpoint file to npz."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and not any("." in k for k in obj):
        obj = obj["state_dict"]
    arrays = convert_torchvision_state_dict(obj, encoder)
    encoder = _ALIASES.get(encoder, encoder)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{encoder}.npz")
    np.savez(out_path, **arrays)
    return out_path


def main(argv: Iterable[str] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help="torchvision state_dict (.pth/.pt)")
    p.add_argument(
        "--encoder", required=True,
        help=f"one of {AVAILABLE_ENCODERS} (torchvision aliases accepted)",
    )
    p.add_argument(
        "--out-dir",
        default=os.environ.get("SLEAP_TPU_PRETRAINED_DIR", "."),
        help="output folder (default: $SLEAP_TPU_PRETRAINED_DIR or cwd)",
    )
    args = p.parse_args(list(argv) if argv is not None else None)
    out = convert_checkpoint(args.checkpoint, args.encoder, args.out_dir)
    print(out)


if __name__ == "__main__":
    main()
