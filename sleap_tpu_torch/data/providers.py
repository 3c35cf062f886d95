"""Host-side data providers: frames plus metadata, batched for inference.

Copies of :mod:`sleap_tpu.data.providers`'s readers and batching, with what
inference reads of them. The readers take any object with the attributes
they use, so the port's ``Labels`` and ``Video`` and the JAX package's both
work:

- a labels object: ``labeled_frames`` (each with ``video``, ``frame_idx``
  and ``image``) and ``videos``;
- a video: ``get_frame``, ``num_frames``, ``height`` and ``width``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass
class LabelsReader:
    """Iterates the labeled frames of a labels object: dicts with ``image``
    (H, W, C), ``video_ind``, ``frame_ind`` and ``scale``."""

    labels: Any

    @property
    def videos(self) -> List[Any]:
        return self.labels.videos

    @property
    def max_height_and_width(self) -> Tuple[int, int]:
        return max(v.height for v in self.videos), max(v.width for v in self.videos)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        video_ids = {id(v): i for i, v in enumerate(self.videos)}
        for lf in self.labels.labeled_frames:
            try:
                image = lf.image
            except Exception:
                continue  # an unreadable frame is skipped
            yield {
                "image": image,
                "video_ind": video_ids[id(lf.video)],
                "frame_ind": lf.frame_idx,
                "scale": np.array([1.0, 1.0], np.float32),
            }


@dataclass
class VideoReader:
    """Iterates the frames of one video."""

    video: Any

    @property
    def videos(self) -> List[Any]:
        return [self.video]

    @property
    def max_height_and_width(self) -> Tuple[int, int]:
        return self.video.height, self.video.width

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self.video.num_frames):
            try:
                image = self.video.get_frame(i)
            except Exception:
                break  # an unreadable frame ends the video
            yield {
                "image": image,
                "video_ind": 0,
                "frame_ind": i,
                "scale": np.array([1.0, 1.0], np.float32),
            }


def resize_and_pad_example(image: np.ndarray, target_hw: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Scale a frame to fit ``target_hw`` and pad it bottom/right; return
    (image, scale). Needs ``cv2``, imported here only."""
    h, w = image.shape[:2]
    th, tw = target_hw
    if (h, w) == (th, tw):
        return image, 1.0
    import cv2

    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(image, (nw, nh))
    if resized.ndim == 2:
        resized = resized[..., None]
    out = np.zeros((th, tw, image.shape[2]), dtype=image.dtype)
    out[:nh, :nw] = resized
    return out, scale


def batch_examples(
    provider, batch_size: int, target_hw: Optional[Tuple[int, int]] = None
) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Group a provider's examples into batches of ``batch_size``.

    The last batch is padded by repeating its final example, so shapes stay
    static; yields ``(batch, n_valid)``. With ``target_hw``, frames are
    size-matched on the host and each example's ``scale`` is carried for
    mapping coordinates back.
    """
    buf: List[Dict[str, Any]] = []

    def emit(buf):
        n_valid = len(buf)
        while len(buf) < batch_size:
            buf.append(buf[-1])
        batch = {
            "image": np.stack([ex["image"] for ex in buf], axis=0),
            "video_ind": np.array([ex["video_ind"] for ex in buf]),
            "frame_ind": np.array([ex["frame_ind"] for ex in buf]),
            # Size matching is isotropic: the (sx, sy) pair becomes a scalar.
            "scale": np.array(
                [np.asarray(ex.get("scale", 1.0), "f4").reshape(-1)[0] for ex in buf], "f4"
            ),
        }
        return batch, n_valid

    for ex in provider:
        if target_hw is not None:
            img, scale = resize_and_pad_example(ex["image"], target_hw)
            ex = dict(ex, image=img, scale=scale)
        buf.append(ex)
        if len(buf) == batch_size:
            yield emit(buf)
            buf = []
    if buf:
        yield emit(buf)


def provider_needs_size_matching(provider) -> Optional[Tuple[int, int]]:
    """The target (h, w) when the provider's videos differ in size, else None."""
    videos = provider.videos
    if len({(v.height, v.width) for v in videos}) <= 1:
        return None
    return provider.max_height_and_width
