"""Predictors: trained models -> PyTorch inference -> ``Labels``.

Port of :mod:`sleap_tpu.inference.predictors` for the single-instance and
top-down (centroid + centered-instance) paths, and the loading and dispatch
of bottom-up folders (:mod:`sleap_tpu_torch.inference.bottomup`) and
multiclass folders (:mod:`sleap_tpu_torch.inference.multiclass`). Each batch
runs on the caller's device: preprocessing, the UNet forward, peak finding
(CUDA kernels on a CUDA device) and the coordinate rules, which are the JAX
package's:

- peaks are scaled by the output stride, then ``/ input_scale + 0.5`` when
  the input was scaled;
- crops are cut around the centroids on the (pre-crop resized) frames, cast
  back to the frame dtype by truncation, and crop offsets are divided by the
  instance model's input scale.

Run folders, providers and ``Labels`` are the port's own
(:mod:`sleap_tpu_torch.config`, :mod:`~sleap_tpu_torch.data.providers`,
:mod:`~sleap_tpu_torch.core`): nothing here imports the JAX package. Entry
points run on ``"cuda"`` unless the caller passes another device. A
predictor given a ``tracker`` (:mod:`sleap_tpu_torch.tracking`) runs it over
the frames it built before it returns ``Labels``, as the JAX predictors do.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.config import TrainingJobConfig
from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
from sleap_tpu_torch.core.labels import Labels, load_file
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data.normalization import (
    apply_imagenet_mode,
    ensure_float,
    ensure_grayscale,
    ensure_rgb,
)
from sleap_tpu_torch.data.prefetch import prefetch
from sleap_tpu_torch.data.providers import (
    LabelsReader,
    VideoReader,
    batch_examples,
    provider_needs_size_matching,
)
from sleap_tpu_torch.data.instance_centroids import get_instance_centroids
from sleap_tpu_torch.data.resizing import pad_to_stride, resize_image
from sleap_tpu_torch.data.streaming import stage_to_device
from sleap_tpu_torch.io.keras_h5 import read_keras_weights
from sleap_tpu_torch.io.orbax import read_variables
from sleap_tpu_torch.io.video import Video
from sleap_tpu_torch.models.model import Model, PoseNet, find_head
from sleap_tpu_torch.models.params import (
    flax_layers,
    is_variables,
    state_dict_from_flax,
    state_dict_from_keras,
)
from sleap_tpu_torch.ops.peak_finding import (
    crop_bboxes_unit,
    find_global_peaks,
    find_global_peaks_with_offsets,
    find_local_peaks,
    find_local_peaks_with_offsets,
)
from sleap_tpu_torch.precision import ieee_fp32

# --------------------------------------------------------------------------- #
# Trained model loading
# --------------------------------------------------------------------------- #


@dataclass
class TrainedModel:
    """A module on its device plus what inference needs from its config.

    ``output_stride`` is the confidence maps' stride; bottom-up models also
    carry the PAFs' stride and the skeleton's edges as part-name pairs,
    multiclass models their classes and the class maps' stride.
    """

    module: PoseNet
    input_scale: float
    output_stride: int
    pad_to_stride: int
    part_names: List[str]
    crop_size: Optional[int] = None
    grayscale: bool = True
    imagenet_mode: Optional[str] = None
    skeleton: Optional[Skeleton] = None  # used when building Labels
    paf_stride: Optional[int] = None
    edges: List[Tuple[str, str]] = field(default_factory=list)
    classes: List[str] = field(default_factory=list)
    class_maps_stride: Optional[int] = None
    center_on_part: Optional[str] = None
    # The size frames were matched to in training, when the run recorded one.
    target_hw: Optional[Tuple[int, int]] = None


def load_trained_model(
    model_path: str,
    device: Union[str, torch.device] = "cuda",
    params: Optional[Mapping[str, Any]] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> TrainedModel:
    """Load a run folder (``training_config.json`` + weights) onto ``device``,
    in ``eval()`` mode (batch norm runs on its running statistics).

    Weights come from ``params``, flax variables ``{"params",
    "batch_stats"}`` or a bare ``params`` tree (a model without batch norm)
    with numpy leaves, if given; else from the folder's Keras
    ``best_model.h5``; else from its orbax checkpoint ``best_model.ckpt``,
    read by the port's own readers
    (:func:`~sleap_tpu_torch.io.orbax.read_variables`); else from
    ``best_model.pt``, the ``state_dict`` the port's trainer saves
    (:mod:`sleap_tpu_torch.training.trainer`), read with
    ``weights_only=True``. A folder with none of them raises
    ``FileNotFoundError``. ``compute_dtype`` is the
    network's (float32, or bf16 for any backbone; see
    :class:`~sleap_tpu_torch.models.model.PoseNet`).
    """
    model_dir = os.path.dirname(model_path) if model_path.endswith(".json") else model_path
    config = TrainingJobConfig.load_json(model_dir)
    skeleton = config.data.labels.skeletons[0] if config.data.labels.skeletons else None
    model = Model.from_config(config.model, skeleton=skeleton)

    h5_path = os.path.join(model_dir, "best_model.h5")
    ckpt_path = os.path.join(model_dir, "best_model.ckpt")
    pt_path = os.path.join(model_dir, "best_model.pt")
    weights, state, keras = None, None, False
    if params is not None:
        weights = params
    elif os.path.exists(h5_path):
        weights, keras = read_keras_weights(h5_path), True
    elif os.path.isdir(ckpt_path):
        weights = read_variables(ckpt_path)
    elif os.path.exists(pt_path):
        state = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"No weights in {model_dir}: no params given, and none of best_model.h5, "
            "best_model.ckpt or best_model.pt there."
        )
    in_channels = _input_channels(model, config, weights, state, keras)
    crop = config.data.instance_cropping.crop_size
    module = model.make_module(in_channels, compute_dtype, (crop, crop) if crop else None)
    if state is None:
        to_state = state_dict_from_keras if keras else state_dict_from_flax
        state = to_state(module, weights)
    module.load_state_dict(state)  # cast into the module's dtype
    module.to(device).eval()

    head = config.model.heads.which_oneof
    confmaps, pafs = getattr(head, "confmaps", head), getattr(head, "pafs", None)
    class_maps = getattr(head, "class_maps", None)
    pp = config.data.preprocessing
    return TrainedModel(
        module=module,
        input_scale=pp.input_scaling,
        output_stride=confmaps.output_stride,
        pad_to_stride=pp.pad_to_stride or model.maximum_stride,
        part_names=list(model.part_names),
        crop_size=config.data.instance_cropping.crop_size,
        center_on_part=config.data.instance_cropping.center_on_part,
        grayscale=in_channels == 1,
        imagenet_mode=pp.imagenet_mode,
        skeleton=skeleton,
        paf_stride=None if pafs is None else pafs.output_stride,
        edges=list(model.edges),
        classes=list(model.classes),
        class_maps_stride=None if class_maps is None else class_maps.output_stride,
        target_hw=((int(pp.target_height), int(pp.target_width))
                   if pp.resize_and_pad_to_target and pp.target_height and pp.target_width
                   else None),
    )


def _input_channels(model: Model, config, weights, state, keras: bool) -> int:
    """The frames' channel count a model was trained on: the first conv's
    input channels over its s2d fold; for the pretrained encoders, whose
    stem always takes RGB (grayscale is tiled), the config's
    ``ensure_rgb`` (the JAX loader reads 1 for them otherwise)."""
    conv = model.input_conv
    if conv is None:
        pp = config.data.preprocessing
        return 3 if pp.ensure_rgb and not pp.ensure_grayscale else 1
    name, fold = conv
    if state is not None:  # the port's own checkpoint: a state_dict, OIHW kernels
        return int(state[f"backbone.layers.{name}.weight"].shape[1]) // fold
    if keras:
        layers = weights
    else:
        layers = flax_layers(weights["params"] if is_variables(weights) else weights)
    return int(np.shape(layers[name]["kernel"])[2]) // fold


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
    """The model's skeleton, or one rebuilt from its part names and edges."""
    if tm.skeleton is not None:
        return tm.skeleton
    skeleton = Skeleton("skeleton")
    for name in tm.part_names:
        skeleton.add_node(name)
    for src, dst in tm.edges:
        skeleton.add_edge(src, dst)
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
    """A provider from what ``data`` has: a provider already (iterable with
    ``videos`` and ``max_height_and_width``), labels (``labeled_frames``) or a
    video (``get_frame``): the port's types or the JAX package's; or a path,
    a ``.slp`` file's labels or else a video file."""
    if hasattr(data, "max_height_and_width") and hasattr(data, "videos"):
        return data
    if hasattr(data, "labeled_frames"):
        return LabelsReader(labels=data)
    if hasattr(data, "get_frame"):
        return VideoReader(video=data)
    if isinstance(data, str):
        if data.endswith(".slp"):
            return LabelsReader(labels=load_file(data))
        return VideoReader.from_filepath(data)
    raise TypeError(f"Cannot make a data provider from {type(data)}.")


# --------------------------------------------------------------------------- #
# Predictor base
# --------------------------------------------------------------------------- #


@dataclass(kw_only=True)
class Predictor:
    """Runs a model on batches of frames on ``device`` (the card unless the
    caller asks for another). ``verbosity`` "rich" prints progress on one
    line, "json" a JSON object a batch, "none" nothing."""

    device: torch.device = field(default_factory=lambda: torch.device("cuda"))
    peak_threshold: float = 0.2
    integral_refinement: bool = True
    integral_patch_size: int = 5
    batch_size: int = 4
    tracker: Any = None
    verbosity: str = "none"

    @classmethod
    def from_model_paths(
        cls,
        model_paths: Union[str, Sequence[str]],
        *,
        device: Union[str, torch.device] = "cuda",
        peak_threshold: float = 0.2,
        integral_refinement: bool = True,
        integral_patch_size: int = 5,
        batch_size: int = 4,
        max_instances: Optional[int] = None,
        params: Optional[Mapping[str, Any]] = None,
        compute_dtype: torch.dtype = torch.float32,
        verbosity: str = "none",
    ) -> "Predictor":
        """Dispatch by the head types of the run folder(s), as the JAX
        package does: a centroid or a centered-instance folder alone gives
        a top-down predictor in one of its evaluation modes.

        ``params`` maps a model path to its flax params tree (numpy), which
        then replaces the folder's own weights. ``compute_dtype`` is the
        networks' (float32 or bf16).
        """
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
            return load_trained_model(
                paths[head], device, params.get(paths[head]), compute_dtype=compute_dtype
            )

        common = dict(
            device=torch.device(device),
            peak_threshold=peak_threshold,
            integral_refinement=integral_refinement,
            integral_patch_size=integral_patch_size,
            batch_size=batch_size,
            verbosity=verbosity,
        )
        if set(paths) == {"single_instance"}:
            return SingleInstancePredictor(confmap_model=load("single_instance"), **common)
        if paths and set(paths) <= {"centroid", "centered_instance"}:
            return TopDownPredictor(
                centroid_model=load("centroid") if "centroid" in paths else None,
                confmap_model=load("centered_instance") if "centered_instance" in paths else None,
                max_instances=max_instances,
                **common,
            )
        if set(paths) == {"multi_instance"}:
            from sleap_tpu_torch.inference.bottomup import BottomUpPredictor

            return BottomUpPredictor(
                bottomup_model=load("multi_instance"), max_instances=max_instances, **common
            )
        if set(paths) == {"multi_class_bottomup"}:
            from sleap_tpu_torch.inference.multiclass import BottomUpMultiClassPredictor

            return BottomUpMultiClassPredictor(model=load("multi_class_bottomup"), **common)
        if set(paths) in ({"multi_class_topdown"}, {"centroid", "multi_class_topdown"}):
            from sleap_tpu_torch.inference.multiclass import TopDownMultiClassPredictor

            return TopDownMultiClassPredictor(
                centroid_model=load("centroid") if "centroid" in paths else None,
                confmap_model=load("multi_class_topdown"),
                max_instances=max_instances,
                **common,
            )
        raise ValueError(f"Unsupported head combination: {sorted(paths)}.")

    # Whether frames are size-matched before batching (and the results
    # scaled back): to the size a model's run recorded (upstream SLEAP's
    # target_height and target_width), else, as the JAX predictor does, to
    # the largest of the provider's videos when they differ in size.
    size_matching = True

    def _trained_target(self) -> Optional[Tuple[int, int]]:
        """The size a model of this predictor was trained to match frames
        to, if its run recorded one (see
        :meth:`~sleap_tpu_torch.training.trainer.Trainer.setup`)."""
        for f in fields(self):
            model = getattr(self, f.name)
            if isinstance(model, TrainedModel) and model.target_hw is not None:
                return model.target_hw
        return None

    def _tracks(self) -> list:
        """Tracks every ``Labels`` of this predictor registers, in order."""
        return []

    @ieee_fp32()
    def predict(self, data, make_labels: bool = True):
        """Run inference on numpy frames (N, H, W[, C]), a video or labels
        (the port's or the JAX package's), or the path of a ``.slp`` or
        video file; return the port's ``Labels``, or the per-batch example
        dicts when ``make_labels`` is False. Float32 runs with TF32 off,
        and the caller's TF32 flags are restored after
        (:func:`~sleap_tpu_torch.precision.ieee_fp32`)."""
        t0 = time.time()
        if isinstance(data, np.ndarray):
            frames = data if data.ndim == 4 else data[..., None]
            provider, batches = None, _array_batches(frames, self.batch_size)
        else:
            provider = _make_provider(data)
            target_hw = ((self._trained_target() or provider_needs_size_matching(provider))
                         if self.size_matching else None)
            batches = prefetch(batch_examples(provider, self.batch_size, target_hw))
        total = len(provider) if provider is not None else len(frames)
        examples = self._predict_generator(batches, total)
        if not make_labels:
            return list(examples)

        videos = provider.videos if provider is not None else [Video.from_numpy(frames)]
        labeled = self._track(self._make_labeled_frames(examples, videos))
        labels = Labels(labeled_frames=labeled, tracks=self._tracks())
        labels.provenance.update(
            {"predictor": type(self).__name__, "total_elapsed": time.time() - t0}
        )
        return labels

    def _track(self, frames: List[LabeledFrame]) -> List[LabeledFrame]:
        """Run ``tracker``, if any, over the built frames in order, then its
        final pass (the JAX package's ``_attach_tracker``)."""
        tracker = self.tracker
        if tracker is None:
            return frames
        for lf in frames:
            lf.instances = tracker.track(
                untracked_instances=list(lf.instances),
                img=lf.image if tracker.uses_image else None,
                t=lf.frame_idx,
            )
        if hasattr(tracker, "final_pass"):
            tracker.final_pass(frames)
        return frames

    def _report_progress(self, done: int, total: int, t0: float) -> None:
        rate = done / max(time.time() - t0, 1e-6)
        if self.verbosity == "json":
            print(json.dumps({"n_processed": done, "n_total": total,
                              "elapsed": time.time() - t0, "rate": rate}), flush=True)
        elif self.verbosity == "rich":
            print(f"\rPredicting... {done}/{total} ({rate:.1f} FPS)", end="", flush=True)

    def _predict_generator(self, batches, total: int = 0) -> Iterator[Dict[str, Any]]:
        done, t0 = 0, time.time()
        for batch, n_valid, dev_img in stage_to_device(batches, self.device):
            with torch.inference_mode():
                out = self._infer(dev_img, batch)
            ex = self._postprocess({k: v.cpu().numpy() for k, v in out.items()}, batch)
            ex.update(
                image=batch["image"],
                video_ind=batch["video_ind"],
                frame_ind=batch["frame_ind"],
                n_valid=n_valid,
            )
            if "instances" in batch:
                ex["instances"] = batch["instances"]
            done += n_valid
            if self.verbosity != "none":
                self._report_progress(done, total, t0)
            yield ex

    def _postprocess(self, ex: Dict[str, np.ndarray], batch: dict) -> Dict[str, Any]:
        """Host side of a batch: undo the size matching of mixed-size videos."""
        for key in ("instance_peaks", "centroids"):
            if key in ex:
                scale = batch["scale"].reshape(-1, *([1] * (ex[key].ndim - 1)))
                ex[key] = ex[key] / scale
        return ex

    def _infer(self, images: torch.Tensor, batch: dict) -> Dict[str, torch.Tensor]:
        """One batch's outputs from its frames on the device; ``batch`` is
        the host batch (ground-truth instances for the top-down modes that
        read them)."""
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

    def _infer(self, images, batch):
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

    ``max_instances`` is the static crop count K per frame (default 8).
    With one of the two models, the JAX predictor's evaluation modes:

    - no centroid model: ground-truth centroids, from the instances of
      labels the frames come from (the anchor part, else the bounding-box
      midpoint), are cropped; each instance's score is 1;
    - no centered-instance model: centroids only, each valid one given the
      points of the nearest ground-truth instance, with scores of 1.

    Both modes size-match frames of videos that differ in size, as the pair
    does (the ground-truth centroids scaled with their frame); the JAX
    predictor batches such frames unmatched there, so it cannot stack them.
    """

    centroid_model: Optional[TrainedModel] = None
    confmap_model: Optional[TrainedModel] = None
    max_instances: Optional[int] = None

    def __post_init__(self):
        if self.centroid_model is None and self.confmap_model is None:
            raise ValueError("A top-down predictor needs a centroid or a centered-instance model.")

    @property
    def _max_peaks(self) -> int:
        return self.max_instances or 8

    def _centroids(self, images: torch.Tensor, batch: dict, K: int):
        """The top K centroids of each frame (S, K, 2) in the coordinates of
        the (size-matched) images, with their values and validity (S, K):
        the centroid model's, or without one the ground-truth instances'
        (values 1), scaled as their frame was."""
        if self.centroid_model is not None:
            return self._find_centroids(images, K)
        tm = self.confmap_model
        skeleton = _skeleton(tm)
        anchor = skeleton.node_names.index(tm.center_on_part) \
            if tm.center_on_part in skeleton.node_names else None
        centroids = np.full((images.shape[0], K, 2), np.nan)
        scales = batch.get("scale", np.ones(images.shape[0]))
        for i, gt in enumerate(batch.get("instances", [])):
            if gt.size:
                cents = get_instance_centroids(torch.from_numpy(gt.astype("f8")), anchor)[:K]
                centroids[i, :len(cents)] = cents.numpy() * float(scales[i])
        centroids = torch.from_numpy(centroids.astype(np.float32)).to(images.device)
        mask = ~torch.isnan(centroids).any(dim=-1)
        return centroids, mask.float(), mask

    def _find_centroids(self, images: torch.Tensor, K: int):
        """Stage 1: the top K centroids of each frame, in frame coordinates,
        with their values and validity (S, K)."""
        ctm = self.centroid_model
        imgs = _preprocess(
            images, ctm.grayscale, ctm.input_scale, ctm.pad_to_stride,
            imagenet_mode=ctm.imagenet_mode,
        )
        out = ctm.module(imgs)
        cms = out[find_head(out, "CentroidConfmapsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            peaks, vals, mask = find_local_peaks_with_offsets(
                cms, out[off_key], max_peaks=K, threshold=self.peak_threshold
            )
        else:
            peaks, vals, mask = find_local_peaks(
                cms, max_peaks=K, threshold=self.peak_threshold,
                refinement="integral" if self.integral_refinement else "local",
                integral_patch_size=self.integral_patch_size,
            )
        # (S, 1, K, ...) -> (S, K, ...): the centroid model has one channel.
        centroids = _adjust_peaks(peaks[:, 0], ctm.output_stride, ctm.input_scale)
        return centroids, vals[:, 0], mask[:, 0]

    def _crop_peaks(self, images: torch.Tensor, centroids: torch.Tensor):
        """Stages 2 and 3: crops around the (S, K) centroids on the
        (pre-crop resized) frames, then each crop's global peaks in frame
        coordinates (S, K, n_nodes, 2) and values (S, K, n_nodes), and the
        instance model's head outputs."""
        S, K = centroids.shape[:2]
        crop = int(self.confmap_model.crop_size or 128)
        itm = self.confmap_model
        full, i_scale = images, itm.input_scale
        centroids_c = centroids
        if i_scale != 1.0:
            full = resize_image(ensure_float(full), i_scale)
            centroids_c = centroids * i_scale
        crop_offsets = centroids_c - crop / 2.0
        top_left = torch.nan_to_num(centroids_c.reshape(S * K, 2)) - (crop - 1) / 2.0
        sample_inds = torch.arange(S, device=images.device).repeat_interleave(K)
        crops = crop_bboxes_unit(full, top_left, sample_inds, (crop, crop))
        crops = _cast_like(crops, full.dtype)

        crops_p = _preprocess(
            crops, itm.grayscale, i_scale, 1, resize_img=False,
            imagenet_mode=itm.imagenet_mode,
        )
        out = itm.module(crops_p)
        cms = out[find_head(out, "CenteredInstanceConfmapsHead")]
        off_key = find_head(out, "OffsetRefinementHead")
        if off_key is not None:
            pk, pv = find_global_peaks_with_offsets(cms, out[off_key], threshold=self.peak_threshold)
        else:
            pk, pv = find_global_peaks(
                cms, threshold=self.peak_threshold,
                refinement="integral" if self.integral_refinement else "local",
                integral_patch_size=self.integral_patch_size,
            )
        pk = _adjust_peaks(pk, itm.output_stride, i_scale)  # (S*K, n_nodes, 2)
        pk = pk + (crop_offsets.reshape(S * K, 2) / i_scale)[:, None, :]
        n_nodes = pk.shape[1]
        return pk.reshape(S, K, n_nodes, 2), pv.reshape(S, K, n_nodes), out

    def _infer(self, images, batch):
        centroids, centroid_vals, centroid_mask = self._centroids(images, batch, self._max_peaks)
        if self.confmap_model is None:
            return {
                "centroids": torch.where(centroid_mask[..., None], centroids, float("nan")),
                "centroid_vals": torch.where(centroid_mask, centroid_vals, 0.0),
                "centroid_mask": centroid_mask,
            }
        pk, pv, _ = self._crop_peaks(images, centroids)
        return {
            "instance_peaks": torch.where(centroid_mask[:, :, None, None], pk, float("nan")),
            "instance_peak_vals": torch.where(centroid_mask[:, :, None], pv, 0.0),
            "centroids": centroids,
            "centroid_vals": torch.where(centroid_mask, centroid_vals, 0.0),
            "centroid_mask": centroid_mask,
        }

    def _make_labeled_frames(self, examples, videos):
        centroid_only = self.confmap_model is None
        skeleton = _skeleton(self.centroid_model if centroid_only else self.confmap_model)
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                instances = []
                for k in range(ex["centroid_mask"].shape[1]):
                    if not ex["centroid_mask"][i, k]:
                        continue
                    if centroid_only:
                        pts = _nearest_instance(ex.get("instances", [])[i:i + 1], ex["centroids"][i, k])
                        if pts is None:
                            continue
                        vals = np.ones(len(pts), np.float32)
                    else:
                        pts, vals = ex["instance_peaks"][i, k], ex["instance_peak_vals"][i, k]
                    if np.all(np.isnan(pts)):
                        continue
                    instances.append(
                        PredictedInstance.from_arrays(
                            points=pts,
                            point_confidences=vals,
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


def _nearest_instance(gts: list, centroid: np.ndarray) -> Optional[np.ndarray]:
    """Of the frame's ground-truth instances (``gts``: one array, or none),
    the points (n_nodes, 2) of the one with the node nearest ``centroid``;
    None without one."""
    if not gts or gts[0].size == 0:
        return None
    gt = gts[0]
    d = np.linalg.norm(gt - centroid[None, None, :], axis=-1)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        d = np.nanmin(d, axis=-1)
    if np.all(np.isnan(d)):
        return None
    return gt[np.nanargmin(d)]


# --------------------------------------------------------------------------- #
# User-facing loader
# --------------------------------------------------------------------------- #


def load_model(
    model_path: Union[str, Sequence[str]],
    *,
    device: Union[str, torch.device] = "cuda",
    batch_size: int = 4,
    peak_threshold: float = 0.2,
    refinement: str = "integral",
    max_instances: Optional[int] = None,
    params: Optional[Mapping[str, Any]] = None,
    compute_dtype: torch.dtype = torch.float32,
    tracker: Optional[str] = None,
    tracker_window: int = 5,
    tracker_max_instances: Optional[int] = None,
) -> Predictor:
    """Load trained model folder(s) as a predictor on ``device`` (the card
    by default; pass ``device="cpu"`` for the CPU: there is no fallback).

    Single-instance, top-down (centroid + centered-instance), bottom-up
    (multi-instance) and multiclass (multi-class bottom-up, or centroid +
    multi-class top-down) folders are supported. Weights are the folder's
    own (``best_model.h5`` or ``best_model.ckpt``) unless ``params`` maps the
    folder to a flax params tree (numpy); ``compute_dtype`` is float32 or
    bf16. ``tracker`` names a tracker of
    :meth:`~sleap_tpu_torch.tracking.tracker.Tracker.make_tracker_by_name`
    ("flow", "simple", ...), with a window of ``tracker_window`` frames and
    at most ``tracker_max_instances`` tracks; its flow runs on ``device``.
    Multiclass predictors keep the identities of their class heads and run
    no tracker, as in the JAX package.
    """
    predictor = Predictor.from_model_paths(
        model_path,
        device=device,
        peak_threshold=peak_threshold,
        integral_refinement=(refinement == "integral"),
        batch_size=batch_size,
        max_instances=max_instances,
        params=params,
        compute_dtype=compute_dtype,
    )
    if tracker is not None:
        from sleap_tpu_torch.tracking.tracker import Tracker

        predictor.tracker = Tracker.make_tracker_by_name(
            tracker=tracker,
            track_window=tracker_window,
            max_tracks=tracker_max_instances,
            device=predictor.device,
        )
    return predictor
