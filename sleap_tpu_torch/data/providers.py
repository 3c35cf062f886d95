"""Host-side data providers: frames plus metadata, batched for inference.

Copies of :mod:`sleap_tpu.data.providers`'s readers and batching, with what
inference reads of them. The readers take any object with the attributes
they use, so the port's ``Labels`` and ``Video`` and the JAX package's both
work:

- a labels object: ``labeled_frames`` (each with ``video``, ``frame_idx``,
  ``image`` and ``instances``) and ``videos``;
- a video: ``get_frame``, ``num_frames``, ``height`` and ``width``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from sleap_tpu_torch.core.labels import Labels
from sleap_tpu_torch.data.resizing import resize_linear_uint8
from sleap_tpu_torch.io.video import Video


@dataclass
class LabelsReader:
    """Iterates the labeled frames of a labels object (those at
    ``example_indices``, if given): dicts with ``image`` (H, W, C),
    ``video_ind``, ``frame_ind``, ``scale`` and ``instances``, the points
    (n_instances, n_nodes, 2) of the frame's instances, invisible points
    NaN."""

    labels: Any
    user_instances_only: bool = False
    example_indices: Optional[Sequence[int]] = None

    @classmethod
    def from_user_instances(cls, labels: Any) -> "LabelsReader":
        """A reader of the frames with user instances, each giving only its
        training instances. Instances with no visible point are removed from
        ``labels`` in place first, and frames left empty dropped, as the
        JAX package does."""
        labels.remove_empty_instances(keep_empty_frames=False)
        inds = [i for i, lf in enumerate(labels.labeled_frames) if lf.has_user_instances]
        return cls(labels=labels, user_instances_only=True, example_indices=inds)

    @classmethod
    def from_unlabeled_suggestions(cls, labels: Any) -> "LabelsReader":
        """A reader over the suggested frames that have no user instance,
        in the order of ``labels.suggestions``: their labeled frames where
        they have one, else new empty frames."""
        frames = [
            labels.find_first(s.video, s.frame_idx) or _empty_frame(s.video, s.frame_idx)
            for s in labels.unlabeled_suggestions
        ]
        return cls(labels=Labels(labeled_frames=frames, videos=labels.videos))

    @property
    def videos(self) -> List[Any]:
        return self.labels.videos

    def __len__(self) -> int:
        if self.example_indices is not None:
            return len(self.example_indices)
        return len(self.labels.labeled_frames)

    @property
    def max_height_and_width(self) -> Tuple[int, int]:
        return max(v.height for v in self.videos), max(v.width for v in self.videos)

    @property
    def is_from_multi_size_videos(self) -> bool:
        """True when the videos differ in frame size."""
        return len({(v.height, v.width) for v in self.videos}) > 1

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        video_ids = {id(v): i for i, v in enumerate(self.videos)}
        frames = self.labels.labeled_frames
        if self.example_indices is not None:
            frames = [frames[int(i)] for i in self.example_indices]
        for lf in frames:
            try:
                image = lf.image
            except (KeyError, IndexError, FileNotFoundError):
                continue  # a frame its video lacks, or a missing video, is skipped
            instances = lf.training_instances if self.user_instances_only else lf.instances
            yield {
                "image": image,
                "video_ind": video_ids[id(lf.video)],
                "frame_ind": lf.frame_idx,
                "scale": np.array([1.0, 1.0], np.float32),
                "instances": np.stack([inst.numpy() for inst in instances]).astype(np.float32)
                if instances else np.zeros((0, 0, 2), np.float32),
            }


def _empty_frame(video: Any, frame_idx: int):
    from sleap_tpu_torch.core.instance import LabeledFrame

    return LabeledFrame(video=video, frame_idx=frame_idx)


@dataclass
class VideoReader:
    """Iterates the frames of one video (those at ``example_indices``, if
    given); an unreadable frame ends it."""

    video: Any
    example_indices: Optional[Sequence[int]] = None

    @classmethod
    def from_filepath(cls, filename: str, example_indices: Optional[Sequence[int]] = None,
                      device="cuda", **kwargs) -> "VideoReader":
        """A reader over the video file at ``filename``, a media file decoded
        on ``device``; keyword arguments (``dataset``, ``input_format``,
        ``grayscale``, ...) go to its backend."""
        return cls(video=Video.from_filename(filename, device=device, **kwargs),
                   example_indices=example_indices)

    @property
    def videos(self) -> List[Any]:
        return [self.video]

    def __len__(self) -> int:
        if self.example_indices is not None:
            return len(self.example_indices)
        return self.video.num_frames

    @property
    def max_height_and_width(self) -> Tuple[int, int]:
        return self.video.height, self.video.width

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self.example_indices
        for i in range(self.video.num_frames) if indices is None else indices:
            try:
                image = self.video.get_frame(int(i))
            except (KeyError, IndexError):
                break  # a frame past the video's end ends it
            yield {
                "image": image,
                "video_ind": 0,
                "frame_ind": int(i),
                "scale": np.array([1.0, 1.0], np.float32),
            }


def resize_and_pad_example(image: np.ndarray, target_hw: Tuple[int, int]) -> Tuple[np.ndarray, float]:
    """Scale a frame to fit ``target_hw`` and pad it bottom/right; return
    (image, scale). The resize is OpenCV's bilinear one, done here
    (:func:`~sleap_tpu_torch.data.resizing.resize_linear_uint8`)."""
    h, w = image.shape[:2]
    th, tw = target_hw
    if (h, w) == (th, tw):
        return image, 1.0
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_linear_uint8(image, (nh, nw))
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
    mapping coordinates back. Examples' ground-truth ``instances`` are
    carried as a list, one array per example.
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
        if "instances" in buf[0]:
            batch["instances"] = [ex["instances"] for ex in buf]
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
