"""MoveNet: a COCO-17 single-instance predictor around the caller's model
(port of :mod:`sleap_tpu.inference.movenet`).

The model stays the caller's, as in the JAX package: nothing is
downloaded. ``MoveNetPredictor.from_trained_models(name, model_path=...)``
takes any callable with TF-Hub MoveNet's contract (int32 ``(1, S, S, 3)``
images in, ``(1, 1, 17, 3)`` normalized ``[y, x, score]`` rows out), or the
path of a local TF SavedModel, which :func:`load_local_movenet` runs on the
CPU with ``tensorflow`` (imported there). Without ``model_path`` it raises
the JAX package's ``NotImplementedError``, which names the download.

Around the model, the JAX package's logic: each frame is resized to fit
S x S (scale ``min(S/h, S/w)``, sizes ``int(round(h * scale))``) by
:func:`~sleap_tpu_torch.data.resizing.resize_linear_uint8`, bit for bit
``cv2.resize`` with ``INTER_LINEAR`` and without cv2, and padded; a gray
frame is repeated to 3 channels. Outputs map back as
``(x, y) * S / scale``; points scored under ``peak_threshold`` are NaN, and
the instance score is the sum of the scores. A ``tracker`` runs on the
predictor's ``device`` (:meth:`~sleap_tpu_torch.inference.predictors.Predictor._track`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from sleap_tpu_torch.core.instance import LabeledFrame, PredictedInstance
from sleap_tpu_torch.core.skeleton import Skeleton
from sleap_tpu_torch.data.resizing import resize_linear_uint8
from sleap_tpu_torch.inference.predictors import Predictor

MOVENET_MODELS = {
    "lightning": {"image_size": 192},
    "thunder": {"image_size": 256},
}

COCO_17_NODES: List[str] = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

COCO_17_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (0, 6), (5, 7), (7, 9),
    (6, 8), (8, 10), (5, 6), (5, 11), (6, 12), (11, 12), (11, 13),
    (13, 15), (12, 14), (14, 16),
]


def movenet_skeleton() -> Skeleton:
    """The 17-keypoint COCO skeleton MoveNet predicts."""
    return Skeleton.from_names_and_edge_inds(COCO_17_NODES, COCO_17_EDGES, name="movenet")


def load_local_movenet(model_path: str) -> Callable[[np.ndarray], np.ndarray]:
    """A local MoveNet TF SavedModel (TF-Hub's ``serving_default``
    signature: int32 images in, ``output_0`` rows out) as a callable, run
    on the CPU by ``tensorflow``."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(f"Loading the MoveNet SavedModel {model_path} needs tensorflow, which "
                          "is not installed; pass a callable as model_path instead.") from e

    with tf.device("/CPU:0"):
        loaded = tf.saved_model.load(model_path)
    sig = loaded.signatures["serving_default"]

    def model_fn(images: np.ndarray) -> np.ndarray:
        with tf.device("/CPU:0"):
            out = sig(tf.constant(images, dtype=tf.int32))
        return out["output_0"].numpy()

    return model_fn


@dataclass(kw_only=True)
class MoveNetPredictor(Predictor):
    """MoveNet single-instance predictor: ``model_fn`` maps int32 images
    ``(1, S, S, 3)`` to normalized keypoints ``(1, 1, 17, 3)`` rows
    ``[y, x, score]``, one frame a call."""

    model_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None
    model_name: str = "lightning"
    batch_size: int = 1

    # Frames are resized to the model's size, never matched to each other.
    size_matching = False

    @property
    def image_size(self) -> int:
        return MOVENET_MODELS[self.model_name]["image_size"]

    @property
    def is_grayscale(self) -> bool:
        return False

    @classmethod
    def from_trained_models(
        cls,
        model_name: str = "lightning",
        model_path: Union[str, Callable, None] = None,
        peak_threshold: float = 0.2,
        *,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ) -> "MoveNetPredictor":
        """A MoveNet predictor ("lightning", 192 px, or "thunder", 256 px)
        of ``model_path``: a local TF SavedModel folder or a callable with
        MoveNet's contract; its tracker, if any, runs on ``device``."""
        if model_name not in MOVENET_MODELS:
            raise ValueError(f"Unknown MoveNet model {model_name!r}.")
        if model_path is None:
            raise NotImplementedError(
                "TF-Hub downloads are unavailable in this offline "
                "environment. Download MoveNet "
                f"('https://tfhub.dev/google/movenet/singlepose/{model_name}') "
                "on a connected machine, save it with tf.saved_model.save, "
                "and pass model_path=<local dir>."
            )
        model_fn = model_path if callable(model_path) else load_local_movenet(model_path)
        return cls(model_fn=model_fn, model_name=model_name, peak_threshold=peak_threshold,
                   batch_size=1, device=torch.device(device), **kwargs)

    def _preprocess_frame(self, img: np.ndarray):
        """Resize and pad a frame to (S, S) RGB; returns (int32 image,
        scale), where points map back as ``points / scale``."""
        size = self.image_size
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        h, w = img.shape[0], img.shape[1]
        scale = min(size / h, size / w)
        new_h, new_w = int(round(h * scale)), int(round(w * scale))
        if (new_h, new_w) != (h, w):
            img = resize_linear_uint8(img, (new_h, new_w))
        out = np.zeros((size, size, 3), np.int32)
        out[:new_h, :new_w] = img
        return out, scale

    def _predict_generator(self, batches, total: int = 0):
        if self.model_fn is None:
            raise ValueError("model_fn not set; use from_trained_models().")
        done, t0 = 0, time.time()
        size = self.image_size
        for batch, n_valid in batches:
            points_all, confs_all = [], []
            for i in range(n_valid):
                img, scale = self._preprocess_frame(np.asarray(batch["image"][i]))
                raw = np.asarray(self.model_fn(img[None]), np.float32).reshape(17, 3)
                # Normalized [y, x] -> (x, y) in padded-image pixels -> frame pixels.
                pts = raw[:, [1, 0]] * size
                points_all.append(pts / scale)
                confs_all.append(raw[:, 2])
            done += n_valid
            if self.verbosity != "none":
                self._report_progress(done, total, t0)
            yield {
                "instance_peaks": np.asarray(points_all),
                "confidences": np.asarray(confs_all),
                "video_ind": np.asarray(batch["video_ind"][:n_valid]),
                "frame_ind": np.asarray(batch["frame_ind"][:n_valid]),
                "n_valid": n_valid,
            }

    def _make_labeled_frames(self, examples, videos) -> list:
        skeleton = movenet_skeleton()
        frames = []
        for ex in examples:
            for i in range(ex["n_valid"]):
                points = np.array(ex["instance_peaks"][i], np.float64)
                confs = np.asarray(ex["confidences"][i], np.float64)
                points[confs < self.peak_threshold] = np.nan
                instances = []
                if not np.all(np.isnan(points)):
                    instances.append(PredictedInstance.from_arrays(
                        points=points,
                        point_confidences=confs,
                        instance_score=float(np.nansum(confs)),
                        skeleton=skeleton,
                    ))
                frames.append(LabeledFrame(video=videos[int(ex["video_ind"][i])],
                                           frame_idx=int(ex["frame_ind"][i]),
                                           instances=instances))
        return frames
