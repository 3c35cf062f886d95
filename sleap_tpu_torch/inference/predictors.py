"""Predictors: trained models -> PyTorch inference -> ``Labels``.

Port of :mod:`sleap_tpu.inference.predictors` for the single-instance and
top-down (centroid + centered-instance) paths. Each batch runs on the
caller's device: preprocessing, the UNet forward, peak finding (CUDA kernels
on a CUDA device) and the coordinate rules, which are the JAX package's:

- peaks are scaled by the output stride, then ``/ input_scale + 0.5`` when
  the input was scaled;
- crops are cut around the centroids on the (pre-crop resized) frames, cast
  back to the frame dtype by truncation, and crop offsets are divided by the
  instance model's input scale.

Only numpy frames with ``make_labels=False`` avoid ``sleap_tpu`` entirely;
reading run folders, videos and ``.slp`` files, and assembling ``Labels``,
use the JAX package's JAX-free modules (config, providers, core).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.data.normalization import (
    apply_imagenet_mode,
    ensure_float,
    ensure_grayscale,
    ensure_rgb,
)
from sleap_tpu_torch.data.resizing import pad_to_stride, resize_image
from sleap_tpu_torch.data.streaming import stage_to_device
from sleap_tpu_torch.models.model import Model, PoseNet, find_head
from sleap_tpu_torch.models.params import state_dict_from_flax, state_dict_from_keras
from sleap_tpu_torch.ops.peak_finding import (
    crop_bboxes_unit,
    find_global_peaks,
    find_global_peaks_with_offsets,
    find_local_peaks,
    find_local_peaks_with_offsets,
)

# --------------------------------------------------------------------------- #
# Trained model loading
# --------------------------------------------------------------------------- #


@dataclass
class TrainedModel:
    """A module on its device plus what inference needs from its config."""

    module: PoseNet
    input_scale: float
    output_stride: int
    pad_to_stride: int
    part_names: List[str]
    crop_size: Optional[int] = None
    grayscale: bool = True
    imagenet_mode: Optional[str] = None
    skeleton: Any = None  # a sleap_tpu Skeleton, used when building Labels


def load_trained_model(
    model_path: str,
    device: Union[str, torch.device],
    params: Optional[Mapping[str, Any]] = None,
) -> TrainedModel:
    """Load a run folder (``training_config.json`` + weights) onto ``device``.

    Weights come from ``params``, a flax ``variables["params"]`` tree with
    numpy leaves, or else from the folder's Keras ``best_model.h5``. Reading
    an orbax checkpoint needs JAX and is not ported yet (ROADMAP.md, queue 1):
    a folder with neither raises.
    """
    from sleap_tpu.config import TrainingJobConfig

    model_dir = os.path.dirname(model_path) if model_path.endswith(".json") else model_path
    config = TrainingJobConfig.load_json(model_dir)
    skeleton = config.data.labels.skeletons[0] if config.data.labels.skeletons else None
    model = Model.from_config(config.model, skeleton=skeleton)

    h5_path = os.path.join(model_dir, "best_model.h5")
    if params is not None:
        weights, keras, layers = params, False, params.get("backbone", {})
    elif os.path.exists(h5_path):
        from sleap_tpu.io.keras_h5 import read_keras_weights

        weights = layers = read_keras_weights(h5_path)
        keras = True
    else:
        raise NotImplementedError(
            f"No best_model.h5 in {model_dir} and no params given: reading orbax "
            "checkpoints without JAX is not ported yet (ROADMAP.md, queue 1). "
            "Pass the checkpoint's params tree as numpy arrays."
        )
    name, fold = model.input_conv
    in_channels = int(np.shape(layers[name]["kernel"])[2]) // fold
    module = model.make_module(in_channels)
    to_state = state_dict_from_keras if keras else state_dict_from_flax
    module.load_state_dict(to_state(module, weights))
    module.to(device).eval()

    head = config.model.heads.which_oneof
    pp = config.data.preprocessing
    part_names = getattr(head, "part_names", None) or (skeleton.node_names if skeleton else [])
    return TrainedModel(
        module=module,
        input_scale=pp.input_scaling,
        output_stride=head.output_stride,
        pad_to_stride=pp.pad_to_stride or model.maximum_stride,
        part_names=list(part_names),
        crop_size=config.data.instance_cropping.crop_size,
        grayscale=in_channels == 1,
        imagenet_mode=pp.imagenet_mode,
        skeleton=skeleton,
    )


def _preprocess(
    imgs: torch.Tensor,
    grayscale: bool,
    input_scale: float,
    pad_stride: int,
    resize_img: bool = True,
    imagenet_mode: Optional[str] = None,
) -> torch.Tensor:
    """Grayscale/RGB, float, ImageNet scaling, resize, pad (JAX ``_preprocess``)."""
    imgs = ensure_grayscale(imgs) if grayscale else ensure_rgb(imgs)
    imgs = ensure_float(imgs)
    if imagenet_mode:
        imgs = apply_imagenet_mode(imgs, imagenet_mode)
    if resize_img and input_scale != 1.0:
        imgs = resize_image(imgs, input_scale)
    if pad_stride and pad_stride > 1:
        imgs = pad_to_stride(imgs, pad_stride)
    return imgs


def _cast_like(crops: torch.Tensor, ref_dtype: torch.dtype) -> torch.Tensor:
    """Cast crops back to the frame dtype; float -> int truncates (TF cast)."""
    if not ref_dtype.is_floating_point:
        return torch.trunc(crops).to(ref_dtype)
    return crops.to(ref_dtype)


def _adjust_peaks(peaks: torch.Tensor, output_stride: int, input_scale: float) -> torch.Tensor:
    """peaks * stride, then / scale + 0.5 when scaled."""
    peaks = peaks * float(output_stride)
    if input_scale != 1.0:
        peaks = peaks / input_scale + 0.5
    return peaks


def _skeleton(tm: TrainedModel):
    """The model's skeleton, or one rebuilt from its part names."""
    if tm.skeleton is not None:
        return tm.skeleton
    from sleap_tpu.core.skeleton import Skeleton

    skeleton = Skeleton("skeleton")
    for name in tm.part_names:
        skeleton.add_node(name)
    return skeleton


# --------------------------------------------------------------------------- #
# Data sources
# --------------------------------------------------------------------------- #


def _array_batches(frames: np.ndarray, batch_size: int) -> Iterator[Tuple[dict, int]]:
    """Fixed-size batches of in-memory frames, the last padded by repeating
    its final frame (``sleap_tpu.data.providers.batch_examples``'s layout)."""
    for start in range(0, len(frames), batch_size):
        inds = np.arange(start, min(start + batch_size, len(frames)))
        n_valid = len(inds)
        inds = np.concatenate([inds, np.full(batch_size - n_valid, inds[-1])])
        yield {
            "image": frames[inds],
            "video_ind": np.zeros(batch_size, np.int64),
            "frame_ind": inds,
            "scale": np.ones(batch_size, np.float32),
        }, n_valid


def _make_provider(data):
    from sleap_tpu.core.labels import Labels
    from sleap_tpu.data.providers import LabelsReader, VideoReader
    from sleap_tpu.io.video import Video

    if isinstance(data, (LabelsReader, VideoReader)):
        return data
    if isinstance(data, Labels):
        return LabelsReader(labels=data)
    if isinstance(data, Video):
        return VideoReader(video=data)
    if isinstance(data, str):
        if data.endswith(".slp"):
            return LabelsReader(labels=Labels.load_file(data))
        return VideoReader.from_filepath(data)
    raise TypeError(f"Cannot make a data provider from {type(data)}.")


# --------------------------------------------------------------------------- #
# Predictor base
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class Predictor:
    """Runs a model on batches of frames on ``device``."""

    device: torch.device
    peak_threshold: float = 0.2
    integral_refinement: bool = True
    integral_patch_size: int = 5
    batch_size: int = 4

    @classmethod
    def from_model_paths(
        cls,
        model_paths: Union[str, Sequence[str]],
        *,
        device: Union[str, torch.device],
        peak_threshold: float = 0.2,
        integral_refinement: bool = True,
        integral_patch_size: int = 5,
        batch_size: int = 4,
        max_instances: Optional[int] = None,
        params: Optional[Mapping[str, Any]] = None,
    ) -> "Predictor":
        """Dispatch by the head types of the run folder(s).

        ``params`` maps a model path to its flax params tree (numpy), for
        folders whose weights are orbax checkpoints.
        """
        from sleap_tpu.config import TrainingJobConfig

        if isinstance(model_paths, str):
            model_paths = [model_paths]
        paths = {}
        for path in model_paths:
            config = TrainingJobConfig.load_json(
                os.path.dirname(path) if path.endswith(".json") else path
            )
            paths[config.model.heads.which_oneof_attrib_name] = path
        params = params or {}

        def load(head):
            return load_trained_model(paths[head], device, params.get(paths[head]))

        common = dict(
            device=torch.device(device),
            peak_threshold=peak_threshold,
            integral_refinement=integral_refinement,
            integral_patch_size=integral_patch_size,
            batch_size=batch_size,
        )
        if set(paths) == {"single_instance"}:
            return SingleInstancePredictor(confmap_model=load("single_instance"), **common)
        if set(paths) == {"centroid", "centered_instance"}:
            return TopDownPredictor(
                centroid_model=load("centroid"),
                confmap_model=load("centered_instance"),
                max_instances=max_instances,
                **common,
            )
        raise NotImplementedError(
            f"Head combination {sorted(paths)} is not ported yet (ROADMAP.md, queue 1)."
        )

    def predict(self, data, make_labels: bool = True):
        """Run inference on numpy frames (N, H, W[, C]) or anything
        ``sleap_tpu``'s providers read; return ``Labels``, or the per-batch
        example dicts when ``make_labels`` is False."""
        t0 = time.time()
        if isinstance(data, np.ndarray):
            frames = data if data.ndim == 4 else data[..., None]
            provider, batches = None, _array_batches(frames, self.batch_size)
        else:
            from sleap_tpu.data.prefetch import prefetch
            from sleap_tpu.data.providers import batch_examples, provider_needs_size_matching

            provider = _make_provider(data)
            target_hw = provider_needs_size_matching(provider)
            batches = prefetch(batch_examples(provider, self.batch_size, target_hw))
        examples = self._predict_generator(batches)
        if not make_labels:
            return list(examples)

        from sleap_tpu.core.labels import Labels
        from sleap_tpu.io.video import Video

        videos = provider.videos if provider is not None else [Video.from_numpy(frames)]
        labels = Labels(labeled_frames=self._make_labeled_frames(examples, videos))
        labels.provenance.update(
            {"predictor": type(self).__name__, "total_elapsed": time.time() - t0}
        )
        return labels

    def _predict_generator(self, batches) -> Iterator[Dict[str, Any]]:
        for batch, n_valid, dev_img in stage_to_device(batches, self.device):
            with torch.inference_mode():
                out = self._infer(dev_img)
            ex = {k: v.cpu().numpy() for k, v in out.items()}
            # Undo host-side size matching of mixed-size videos.
            for key in ("instance_peaks", "centroids"):
                if key in ex:
                    scale = batch["scale"].reshape(-1, *([1] * (ex[key].ndim - 1)))
                    ex[key] = ex[key] / scale
            ex.update(
                image=batch["image"],
                video_ind=batch["video_ind"],
                frame_ind=batch["frame_ind"],
                n_valid=n_valid,
            )
            yield ex

    def _infer(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _make_labeled_frames(self, examples, videos) -> list:
        raise NotImplementedError


# --------------------------------------------------------------------------- #
# Single instance
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class SingleInstancePredictor(Predictor):
    """One animal per frame: confidence maps -> global peaks."""

    confmap_model: TrainedModel

    def _infer(self, images):
        tm = self.confmap_model
        imgs = _preprocess(
            images, tm.grayscale, tm.input_scale, tm.pad_to_stride,
            imagenet_mode=tm.imagenet_mode,
        )
        out = tm.module(imgs)
        cms = out[find_head(out, "SingleInstanceConfmapsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            peaks, vals = find_global_peaks_with_offsets(
                cms, out[off_key], threshold=self.peak_threshold
            )
        else:
            peaks, vals = find_global_peaks(
                cms,
                threshold=self.peak_threshold,
                refinement="integral" if self.integral_refinement else "local",
                integral_patch_size=self.integral_patch_size,
            )
        peaks = _adjust_peaks(peaks, tm.output_stride, tm.input_scale)
        return {"instance_peaks": peaks, "instance_peak_vals": vals}

    def _make_labeled_frames(self, examples, videos):
        from sleap_tpu.core.instance import LabeledFrame, PredictedInstance

        skeleton = _skeleton(self.confmap_model)
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                pts = ex["instance_peaks"][i]
                confs = ex["instance_peak_vals"][i]
                instances = []
                if not np.all(np.isnan(pts)):
                    instances.append(
                        PredictedInstance.from_arrays(
                            points=pts,
                            point_confidences=confs,
                            instance_score=float(np.nansum(confs)),
                            skeleton=skeleton,
                        )
                    )
                frames.append(
                    LabeledFrame(
                        video=videos[int(ex["video_ind"][i])],
                        frame_idx=int(ex["frame_ind"][i]),
                        instances=instances,
                    )
                )
        return frames


# --------------------------------------------------------------------------- #
# Top-down
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class TopDownPredictor(Predictor):
    """Centroids -> crops -> centered-instance confidence maps.

    ``max_instances`` is the static crop count K per frame (default 8). The
    centroid-only and ground-truth-centroid modes of the JAX predictor are
    not ported yet: both models are required.
    """

    centroid_model: TrainedModel
    confmap_model: TrainedModel
    max_instances: Optional[int] = None

    def __post_init__(self):
        if self.centroid_model is None or self.confmap_model is None:
            raise NotImplementedError(
                "Centroid-only and ground-truth-centroid top-down modes are not ported yet "
                "(ROADMAP.md, queue 1)."
            )

    def _infer(self, images):
        K = self.max_instances or 8
        crop = int(self.confmap_model.crop_size or 128)
        threshold = self.peak_threshold
        refinement = "integral" if self.integral_refinement else "local"
        patch = self.integral_patch_size
        ctm, itm = self.centroid_model, self.confmap_model

        # ---- Stage 1: centroids ----
        imgs = _preprocess(
            images, ctm.grayscale, ctm.input_scale, ctm.pad_to_stride,
            imagenet_mode=ctm.imagenet_mode,
        )
        out = ctm.module(imgs)
        cms = out[find_head(out, "CentroidConfmapsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            peaks, vals, mask = find_local_peaks_with_offsets(
                cms, out[off_key], max_peaks=K, threshold=threshold
            )
        else:
            peaks, vals, mask = find_local_peaks(
                cms, max_peaks=K, threshold=threshold,
                refinement=refinement, integral_patch_size=patch,
            )
        # (S, 1, K, ...) -> (S, K, ...): the centroid model has one channel.
        centroids = _adjust_peaks(peaks[:, 0], ctm.output_stride, ctm.input_scale)
        centroid_vals, centroid_mask = vals[:, 0], mask[:, 0]

        # ---- Stage 2: crops on the (pre-crop resized) frames ----
        full, i_scale = images, itm.input_scale
        centroids_c = centroids
        if i_scale != 1.0:
            full = resize_image(ensure_float(full), i_scale)
            centroids_c = centroids * i_scale
        crop_offsets = centroids_c - crop / 2.0
        S = images.shape[0]
        top_left = torch.nan_to_num(centroids_c.reshape(S * K, 2)) - (crop - 1) / 2.0
        sample_inds = torch.arange(S, device=images.device).repeat_interleave(K)
        crops = crop_bboxes_unit(full, top_left, sample_inds, (crop, crop))
        crops = _cast_like(crops, full.dtype)

        # ---- Stage 3: instance peaks on the crops ----
        crops_p = _preprocess(
            crops, itm.grayscale, i_scale, 1, resize_img=False,
            imagenet_mode=itm.imagenet_mode,
        )
        out2 = itm.module(crops_p)
        cms2 = out2[find_head(out2, "CenteredInstanceConfmapsHead")]
        off2 = find_head(out2, "OffsetRefinementHead")
        if off2 is not None:
            pk, pv = find_global_peaks_with_offsets(cms2, out2[off2], threshold=threshold)
        else:
            pk, pv = find_global_peaks(
                cms2, threshold=threshold, refinement=refinement,
                integral_patch_size=patch,
            )
        pk = _adjust_peaks(pk, itm.output_stride, i_scale)  # (S*K, n_nodes, 2)
        pk = pk + (crop_offsets.reshape(S * K, 2) / i_scale)[:, None, :]

        n_nodes = pk.shape[1]
        pk = pk.reshape(S, K, n_nodes, 2)
        pv = pv.reshape(S, K, n_nodes)
        return {
            "instance_peaks": torch.where(centroid_mask[:, :, None, None], pk, float("nan")),
            "instance_peak_vals": torch.where(centroid_mask[:, :, None], pv, 0.0),
            "centroids": centroids,
            "centroid_vals": torch.where(centroid_mask, centroid_vals, 0.0),
            "centroid_mask": centroid_mask,
        }

    def _make_labeled_frames(self, examples, videos):
        from sleap_tpu.core.instance import LabeledFrame, PredictedInstance

        skeleton = _skeleton(self.confmap_model)
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                instances = []
                for k in range(ex["centroid_mask"].shape[1]):
                    pts = ex["instance_peaks"][i, k]
                    if not ex["centroid_mask"][i, k] or np.all(np.isnan(pts)):
                        continue
                    instances.append(
                        PredictedInstance.from_arrays(
                            points=pts,
                            point_confidences=ex["instance_peak_vals"][i, k],
                            instance_score=float(ex["centroid_vals"][i, k]),
                            skeleton=skeleton,
                        )
                    )
                frames.append(
                    LabeledFrame(
                        video=videos[int(ex["video_ind"][i])],
                        frame_idx=int(ex["frame_ind"][i]),
                        instances=instances,
                    )
                )
        return frames


# --------------------------------------------------------------------------- #
# User-facing loader
# --------------------------------------------------------------------------- #


def load_model(
    model_path: Union[str, Sequence[str]],
    *,
    device: Union[str, torch.device],
    batch_size: int = 4,
    peak_threshold: float = 0.2,
    refinement: str = "integral",
    max_instances: Optional[int] = None,
    params: Optional[Mapping[str, Any]] = None,
) -> Predictor:
    """Load trained model folder(s) as a predictor on ``device``.

    Single-instance and top-down (centroid + centered-instance) folders are
    supported; ``params`` maps a folder to its flax params tree (numpy).
    """
    return Predictor.from_model_paths(
        model_path,
        device=device,
        peak_threshold=peak_threshold,
        integral_refinement=(refinement == "integral"),
        batch_size=batch_size,
        max_instances=max_instances,
        params=params,
    )
