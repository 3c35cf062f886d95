"""Model export for deployment (port of :mod:`sleap_tpu.inference.export`).

The JAX package serializes a predictor's whole jitted batch function as
StableHLO. Here the same function, :meth:`Predictor._infer` (preprocessing,
the networks, the peak and crop kernels, grouping or class assignment), is
traced by ``torch.export`` into an ``ExportedProgram`` and saved as
``<save_path>/model.pt2`` beside an ``info.json`` of the JAX keys and the
program's device. A deployment (a closed-loop rig, say) then runs the model
with no predictor, config or checkpoint reader: :func:`load_exported_model`
gives back a callable from uint8 frames to the predictor's dict of
NaN-padded tensors.

The four kernels are the custom ops ``torch.ops.sleap_tpu_torch.*``
(:mod:`~sleap_tpu_torch.ops.cuda_peaks`, :mod:`~sleap_tpu_torch.ops.cuda_crops`),
so the program calls them as eager code does: the CUDA kernels on the card,
the plain versions on the CPU. A program runs on the device it was exported
on, batch and frame size fixed. Float32 programs run with TF32 off
(:func:`~sleap_tpu_torch.precision.ieee_fp32`), as ``predict`` does: the
flag is global, and the exported convolutions read it when they run.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from sleap_tpu_torch.precision import ieee_fp32

PROGRAM = "model.pt2"
FORMAT = "torch.export ExportedProgram (.pt2)"
# The predictor attributes that hold a model; the first one present takes
# the frames, and gives their channels (the JAX exporter's order).
_INPUT_MODELS = ("confmap_model", "centroid_model", "bottomup_model", "model")


def export_model(
    model_path: Union[str, Sequence[str]],
    save_path: str = "exported_model",
    batch_size: int = 4,
    image_size: Optional[int] = None,
    max_instances: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    **kwargs,
) -> str:
    """Export trained model folder(s) as a ``torch.export`` program.

    Writes ``<save_path>/model.pt2`` and ``<save_path>/info.json`` for a
    predictor loaded on ``device`` (the card unless the caller asks for the
    CPU); ``image_size`` None means 1024. Other keyword arguments go to
    :meth:`~sleap_tpu_torch.inference.predictors.Predictor.from_model_paths`.
    """
    from sleap_tpu_torch.inference.predictors import Predictor

    predictor = Predictor.from_model_paths(
        model_path, device=device, batch_size=batch_size, max_instances=max_instances, **kwargs
    )
    if image_size is None:
        image_size = 1024
    return export_predictor(
        predictor,
        save_path,
        image_size=image_size,
        model_paths=[model_path] if isinstance(model_path, str) else list(model_path),
    )


class _Infer(torch.nn.Module):
    """A predictor's batch function as a module that owns its networks, so
    ``torch.export`` lifts their weights as the program's parameters."""

    def __init__(self, predictor, models: Dict[str, torch.nn.Module]):
        super().__init__()
        self.predictor = predictor
        self.networks = torch.nn.ModuleDict(models)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.predictor._infer(images, {})


def _refuse_host_modes(predictor) -> None:
    """The top-down evaluation modes read the labels' instances on the host
    (the JAX package's infer functions take centroids as a second input),
    so one image input cannot drive them."""
    from sleap_tpu_torch.inference.predictors import TopDownPredictor

    if not isinstance(predictor, TopDownPredictor):
        return
    if predictor.centroid_model is None:
        raise ValueError(
            f"{type(predictor).__name__} without a centroid model runs in the ground-truth "
            "centroid mode, which takes the labels' instances as a second input: it cannot be "
            "exported from frames alone."
        )
    if predictor.confmap_model is None:
        raise ValueError(
            f"{type(predictor).__name__} without a centered-instance model runs in the "
            "centroid-only mode, which matches the labels' instances on the host: it cannot be "
            "exported from frames alone."
        )


def export_predictor(
    predictor,
    save_path: str = "exported_model",
    image_size: int = 1024,
    model_paths: Optional[Sequence[str]] = None,
) -> str:
    """Export a live predictor's batch function for (batch_size, image_size,
    image_size, channels) uint8 frames on its device."""
    from sleap_tpu_torch.inference.predictors import TrainedModel

    _refuse_host_modes(predictor)
    found = [(name, getattr(predictor, name)) for name in _INPUT_MODELS
             if isinstance(getattr(predictor, name, None), TrainedModel)]
    models = {name: tm.module for name, tm in found}
    first = found[0][1]
    channels = 1 if first.grayscale else 3
    batch_size = predictor.batch_size
    device = torch.device(predictor.device)
    example = torch.zeros((batch_size, image_size, image_size, channels), dtype=torch.uint8,
                          device=device)
    with torch.no_grad(), ieee_fp32():
        program = torch.export.export(_Infer(predictor, models), (example,), strict=False)
    outputs = sorted(program.call_spec.out_spec.context) if program.call_spec.out_spec else []

    os.makedirs(save_path, exist_ok=True)
    torch.export.save(program, os.path.join(save_path, PROGRAM))
    info = {
        "predictor": type(predictor).__name__,
        "model_paths": list(model_paths or []),
        "input_shape": [batch_size, image_size, image_size, channels],
        "input_dtype": "uint8",
        "outputs": f"dict of NaN-padded tensors ({', '.join(outputs)})",
        "format": FORMAT,
        "device": str(device),
        "compute_dtype": str(next(first.module.parameters()).dtype).removeprefix("torch."),
    }
    with open(os.path.join(save_path, "info.json"), "w") as f:
        json.dump(info, f, indent=2)
    return save_path


def load_exported_model(save_path: str) -> Callable:
    """Load an exported program; return a callable from (batch, height,
    width, channels) uint8 frames (an array or a tensor, of the exported
    shape) to the predictor's dict of tensors, on the program's device.

    Raises if that device is not here: the program is not moved to another.
    """
    # The kernels' ops must be registered before the program is read.
    from sleap_tpu_torch.ops import cuda_crops, cuda_peaks  # noqa: F401

    with open(os.path.join(save_path, "info.json")) as f:
        info = json.load(f)
    device = torch.device(info["device"])
    if device.type == "cuda" and not (torch.cuda.is_available()
                                      and (device.index or 0) < torch.cuda.device_count()):
        raise RuntimeError(
            f"{save_path} was exported for {device}, which this machine does not have; "
            "export it again on the device it should run on."
        )
    module = torch.export.load(os.path.join(save_path, PROGRAM)).module()

    def run(images: Union[np.ndarray, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(images).to(device)
        with torch.no_grad(), ieee_fp32():
            return module(x)

    return run
