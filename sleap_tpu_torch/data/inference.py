"""Inference stages as pipeline blocks (port of :mod:`sleap_tpu.data.inference`).

Each block has ``input_keys`` / ``output_keys`` and a
``transform_dataset(examples)`` iterator over example dicts of numpy
values, with the JAX package's key names and defaults; they chain with the
blocks of :mod:`~sleap_tpu_torch.data.dataset_ops`. A frame's arrays are
(H, W, C) or a batch's (S, H, W, C): a rank-3 array goes through as a batch
of one and comes back rank 3.

``ModelPredictor``, ``GlobalPeakFinder`` and ``LocalPeakFinder`` run on
``device`` (the card unless the caller asks for another, with no
fallback): the arrays are staged there and the results come back as
numpy. The peak finders call :mod:`~sleap_tpu_torch.ops.peak_finding`,
which launches the CUDA kernels on the card (global peaks; local peaks,
the bf16 kernel on bf16 maps). ``MockGlobalPeakFinder`` and
``PredictedCenterInstanceNormalizer`` are host numpy, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator, List, Union

import numpy as np
import torch

from sleap_tpu_torch.data.normalization import ensure_float
from sleap_tpu_torch.ops.peak_finding import find_global_peaks, find_local_peaks, flatten_local_peaks
from sleap_tpu_torch.precision import ieee_fp32

Device = Union[str, torch.device]


def _expand_to_rank4(arr: np.ndarray) -> tuple:
    """(H, W, C) -> (1, H, W, C); returns (batched, was_rank3)."""
    if arr.ndim == 3:
        return arr[None], True
    return arr, False


def _staged(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _names(v) -> List[str]:
    return [v] if isinstance(v, str) else list(v)


@dataclass
class ModelPredictor:
    """Run a trained model on examples' images on ``device``.

    ``model`` is a :class:`~sleap_tpu_torch.inference.predictors.TrainedModel`
    loaded on that device; its head outputs are written, as float32, under
    ``model_output_keys`` in order (the last head fills any extra key).
    Float32 runs with TF32 off (:func:`~sleap_tpu_torch.precision.ieee_fp32`).
    """

    model: Any = None
    model_input_keys: Any = "instance_image"
    model_output_keys: Any = "predicted_instance_confidence_maps"
    device: Device = field(default_factory=lambda: torch.device("cuda"))

    def __post_init__(self):
        self.model_input_keys = _names(self.model_input_keys)
        self.model_output_keys = _names(self.model_output_keys)

    @property
    def input_keys(self) -> List[str]:
        return list(self.model_input_keys)

    @property
    def output_keys(self) -> List[str]:
        return self.input_keys + list(self.model_output_keys)

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            imgs, was3 = _expand_to_rank4(np.asarray(ex[self.model_input_keys[0]]))
            with ieee_fp32(), torch.inference_mode():
                out = self.model.module(ensure_float(_staged(imgs, self.device)))
                head_outputs = [v.float().cpu().numpy() for v in out.values()]
            for i, output_key in enumerate(self.model_output_keys):
                y = head_outputs[min(i, len(head_outputs) - 1)]
                ex[output_key] = y[0] if was3 else y
            yield ex


@dataclass
class GlobalPeakFinder:
    """The global peak of each confidence map channel on ``device`` (kernel
    ``global_peaks`` on the card), scaled by ``confmaps_stride``."""

    confmaps_key: str = "predicted_instance_confidence_maps"
    confmaps_stride: int = 1
    peak_threshold: float = 0.2
    peaks_key: str = "predicted_center_instance_points"
    peak_vals_key: str = "predicted_center_instance_confidences"
    keep_confmaps: bool = True
    integral: bool = True
    integral_patch_size: int = 5
    device: Device = field(default_factory=lambda: torch.device("cuda"))

    @property
    def input_keys(self) -> List[str]:
        return [self.confmaps_key]

    @property
    def output_keys(self) -> List[str]:
        out = [self.peaks_key, self.peak_vals_key]
        if self.keep_confmaps:
            out.append(self.confmaps_key)
        return out

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            cms, was3 = _expand_to_rank4(np.asarray(ex[self.confmaps_key]))
            peaks, vals = find_global_peaks(
                _staged(cms, self.device),
                threshold=self.peak_threshold,
                refinement="integral" if self.integral else None,
                integral_patch_size=self.integral_patch_size,
            )
            peaks = peaks.cpu().numpy() * float(self.confmaps_stride)
            vals = vals.cpu().numpy()
            ex[self.peaks_key] = peaks[0] if was3 else peaks
            ex[self.peak_vals_key] = vals[0] if was3 else vals
            if not self.keep_confmaps:
                ex.pop(self.confmaps_key)
            yield ex


@dataclass
class MockGlobalPeakFinder:
    """Put the ground-truth instance nearest the example's centroid where
    the model's prediction would go, in the crop's coordinates (host)."""

    all_peaks_in_key: str = "instances"
    peaks_out_key: str = "predicted_center_instance_points"
    peak_vals_key: str = "predicted_center_instance_confidences"
    keep_confmaps: bool = True
    confmaps_in_key: str = "instance_confidence_maps"
    confmaps_out_key: str = "predicted_instance_confidence_maps"

    @property
    def input_keys(self) -> List[str]:
        keys = [self.all_peaks_in_key, "centroid", "bbox", "scale"]
        if self.keep_confmaps:
            keys.append(self.confmaps_in_key)
        return keys

    @property
    def output_keys(self) -> List[str]:
        out = [self.peaks_out_key, self.peak_vals_key]
        if self.keep_confmaps:
            out.append(self.confmaps_out_key)
        return out

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            centroid = np.asarray(ex["centroid"], np.float64) / np.asarray(ex["scale"])
            all_peaks = np.asarray(ex[self.all_peaks_in_key], np.float64)
            dists = np.nanmin(
                np.linalg.norm(all_peaks - centroid.reshape(1, 1, 2), axis=-1), axis=1)
            center_instance = all_peaks[int(np.nanargmin(dists))].copy()
            bbox = np.asarray(ex["bbox"], np.float64).reshape(-1)
            center_instance -= bbox[[1, 0]].reshape(1, 2)  # (x1, y1)
            ex[self.peaks_out_key] = center_instance.astype(np.float32)
            ex[self.peak_vals_key] = np.ones(len(center_instance), np.float32)
            ex.pop(self.all_peaks_in_key)
            if self.keep_confmaps:
                ex[self.confmaps_out_key] = ex.pop(self.confmaps_in_key)
            yield ex


@dataclass
class LocalPeakFinder:
    """Every local peak of the maps on ``device`` (kernel ``local_peaks`` on
    float32 maps, ``local_peaks_hwcs`` on bf16 ones), flattened to lists of
    points, values and sample and channel indices."""

    confmaps_key: str = "centroid_confidence_maps"
    confmaps_stride: int = 1
    peak_threshold: float = 0.2
    peaks_key: str = "predicted_centroids"
    peak_vals_key: str = "predicted_centroid_confidences"
    peak_sample_inds_key: str = "predicted_centroid_sample_inds"
    peak_channel_inds_key: str = "predicted_centroid_channel_inds"
    keep_confmaps: bool = True
    integral: bool = True
    max_peaks: int = 32
    device: Device = field(default_factory=lambda: torch.device("cuda"))

    @property
    def input_keys(self) -> List[str]:
        return [self.confmaps_key]

    @property
    def output_keys(self) -> List[str]:
        out = [self.peaks_key, self.peak_vals_key, self.peak_sample_inds_key,
               self.peak_channel_inds_key]
        if self.keep_confmaps:
            out.append(self.confmaps_key)
        return out

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            cms, _ = _expand_to_rank4(np.asarray(ex[self.confmaps_key]))
            peaks, vals, s_inds, c_inds = flatten_local_peaks(*find_local_peaks(
                _staged(cms, self.device),
                max_peaks=self.max_peaks,
                threshold=self.peak_threshold,
                refinement="integral" if self.integral else None,
            ))
            ex[self.peaks_key] = (peaks * float(self.confmaps_stride)).astype(np.float32)
            ex[self.peak_vals_key] = vals.astype(np.float32)
            ex[self.peak_sample_inds_key] = s_inds
            ex[self.peak_channel_inds_key] = c_inds
            if not self.keep_confmaps:
                ex.pop(self.confmaps_key)
            yield ex


@dataclass
class PredictedCenterInstanceNormalizer:
    """Map crop-relative predicted points back to full-frame coordinates
    (host)."""

    centroid_key: str = "centroid"
    centroid_confidence_key: str = "centroid_confidence"
    peaks_key: str = "predicted_center_instance_points"
    peak_confidences_key: str = "predicted_center_instance_confidences"
    new_centroid_key: str = "predicted_centroid"
    new_centroid_confidence_key: str = "predicted_centroid_confidence"
    new_peaks_key: str = "predicted_instance"
    new_peak_confidences_key: str = "predicted_instance_confidences"

    @property
    def input_keys(self) -> List[str]:
        return [self.centroid_key, self.centroid_confidence_key, self.peaks_key,
                self.peak_confidences_key, "scale", "bbox"]

    @property
    def output_keys(self) -> List[str]:
        return [self.new_centroid_key, self.new_centroid_confidence_key, self.new_peaks_key,
                self.new_peak_confidences_key]

    def transform_dataset(self, examples: Iterable[dict]) -> Iterator[dict]:
        for ex in examples:
            scale = np.asarray(ex["scale"], np.float64)
            centroids = np.asarray(ex[self.centroid_key], np.float64) / scale
            bbox = np.asarray(ex["bbox"], np.float64).reshape(-1, 4)
            pts = np.asarray(ex[self.peaks_key], np.float64)
            pts = (pts + bbox[0, [1, 0]].reshape(1, 2)) / scale
            ex[self.new_centroid_key] = centroids.astype(np.float32)
            ex[self.new_centroid_confidence_key] = ex[self.centroid_confidence_key]
            ex[self.new_peaks_key] = pts.astype(np.float32)
            ex[self.new_peak_confidences_key] = ex[self.peak_confidences_key]
            yield ex
