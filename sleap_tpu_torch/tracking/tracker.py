"""Cross-frame instance tracking (port of :mod:`sleap_tpu.tracking.tracker`).

The tracker of the JAX package, with the same candidate makers, queues,
matching and spawning rules, so both give the same tracks. What differs is
where the flow-shift work runs:

- each frame is converted to grayscale (cv2's BGR luma weights for three
  channels), resized with :func:`resize_linear` when ``img_scale != 1``,
  uploaded to the tracker's ``device`` and built into its Lucas-Kanade
  pyramid once (:class:`FlowImage`); the queue holds that pyramid in place
  of the frame, so no pyramid is built twice;
- all prior frames of the window are shifted onto the new frame in one
  batched :func:`~sleap_tpu_torch.ops.optical_flow.lk_flow_pyramids` call,
  read back to the host once.

:func:`retrack` works on in-memory ``Labels``; :func:`main` re-tracks a
saved predictions file, as the JAX module's CLI does, with flow on the card
unless ``--cpu`` asks for the CPU (``python -m
sleap_tpu_torch.tracking.tracker predictions.slp [-o out.slp] [--cpu]``);
so does the tracking-only branch of ``sleap_tpu_torch.cli.track`` (a
tracker and no model).
"""

from __future__ import annotations

import functools
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sleap_tpu_torch.core.instance import PredictedInstance, Track
from sleap_tpu_torch.ops.optical_flow import build_pyramid, lk_flow_pyramids
from sleap_tpu_torch.tracking.components import (
    FrameMatches,
    centroid_distance,
    connect_single_track_breaks,
    cull_frame_instances,
    cull_instances,
    factory_object_keypoint_similarity,
    first_choice_matching,
    greedy_matching,
    hungarian_matching,
    instance_iou,
    instance_similarity,
    normalized_instance_similarity,
)

# cv2's luma weights of a three-channel frame in BGR order.
_BGR_LUMA = np.array([0.114, 0.587, 0.299])

logger = logging.getLogger(__name__)


@dataclass(eq=False)
class ShiftedInstance:
    """A prior instance displaced into the current frame by optical flow."""

    points_array: np.ndarray
    skeleton: Any
    track: Optional[Track]
    frame_t: int
    shift_score: float = 0.0

    def numpy(self) -> np.ndarray:
        return self.points_array

    @property
    def centroid(self) -> np.ndarray:
        return np.nanmean(self.points_array, axis=0)

    @property
    def bounding_box(self) -> np.ndarray:
        pts = self.points_array
        return np.array([np.nanmin(pts[:, 1]), np.nanmin(pts[:, 0]),
                         np.nanmax(pts[:, 1]), np.nanmax(pts[:, 0])])

    @property
    def n_visible_points(self) -> int:
        return int(np.sum(~np.isnan(self.points_array).any(axis=-1)))


@dataclass
class MatchedFrameInstances:
    t: int
    instances_t: List[Any]
    img_t: Any = None


@dataclass
class MatchedFrameInstance:
    t: int
    instance_t: Any
    img_t: Any = None


# --------------------------------------------------------------------------- #
# Frames for flow
# --------------------------------------------------------------------------- #


def resize_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    """cv2.resize's output size for ``fx = fy = scale``: each side times
    the scale, rounded to nearest with ties to even."""
    return round(h * scale), round(w * scale)


def _linear_taps(n_in: int, n_out: int, scale: float, device,
                 clamp_weights: bool) -> Tuple[torch.Tensor, ...]:
    """Source taps (i0, i1) and float32 weights (1 - f, f) of cv2's
    INTER_LINEAR along one axis: half-pixel centres, a map step of
    1 / scale, f the fraction of the source coordinate in double, taps
    replicated at the border. Along columns f = 0 where a tap leaves the
    image (``clamp_weights``); along rows f stays and the taps are clipped."""
    src = (np.arange(n_out) + 0.5) * (1.0 / scale) - 0.5
    i0 = np.floor(src)
    f = src - i0
    i0 = i0.astype(np.int64)
    if clamp_weights:
        f[i0 < 0] = 0.0
        f[i0 >= n_in - 1] = 0.0
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    i0 = np.clip(i0, 0, n_in - 1)
    to = functools.partial(torch.as_tensor, device=device)
    return to(i0), to(i1), to((1.0 - f).astype("f4")), to(f.astype("f4"))


def resize_linear(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Resize (H, W) float32 as ``cv2.resize(img, None, None, scale, scale)``
    with INTER_LINEAR: half-pixel centres, no antialias, border replicated,
    output size from :func:`resize_size`; columns blended first, then rows,
    as cv2 does for float32 images."""
    h, w = img.shape
    oh, ow = resize_size(h, w, scale)
    c0, c1, cw0, cw1 = _linear_taps(w, ow, scale, img.device, clamp_weights=True)
    r0, r1, rw0, rw1 = _linear_taps(h, oh, scale, img.device, clamp_weights=False)
    cols = img[:, c0] * cw0 + img[:, c1] * cw1
    return cols[r0] * rw0[:, None] + cols[r1] * rw1[:, None]


def to_gray(img: np.ndarray) -> np.ndarray:
    """A frame as (H, W) float32 grayscale, as the JAX tracker converts it:
    cv2's BGR luma weights for three channels, else the first channel."""
    im = np.squeeze(np.asarray(img))
    if im.ndim == 3 and im.shape[-1] == 3:
        im = im @ _BGR_LUMA
    elif im.ndim == 3:
        im = im[..., 0]
    return im.astype("f4")


@dataclass(eq=False)
class FlowImage:
    """A frame on the flow device: its Lucas-Kanade pyramid (levels of
    :func:`~sleap_tpu_torch.ops.optical_flow.build_pyramid`, batch 1), for
    frames converted at ``scale``."""

    pyramid: List[torch.Tensor]
    scale: float

    @classmethod
    def from_frame(cls, img, scale: float, max_levels: int,
                   device: Union[str, torch.device]) -> "FlowImage":
        if isinstance(img, FlowImage):
            return img
        gray = torch.from_numpy(to_gray(img)).to(device)
        if scale != 1.0:
            gray = resize_linear(gray, scale)
        return cls(build_pyramid(gray[None], max_levels), scale)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.pyramid[0].shape[-2:])


def flow_shift_pairs(
    pairs: Sequence[Tuple[int, FlowImage, List[Any]]],
    new_img: FlowImage,
    min_shifted_points: int = 0,
    window_size: int = 21,
) -> List[List[ShiftedInstance]]:
    """Shift each pair's ``(frame_t, ref_img, ref_instances)`` onto
    ``new_img``: one batched flow call for all pairs of one frame size, one
    read-back. Returns each pair's shifted instances, in order, with the
    JAX tracker's rules: an instance is kept when more than
    ``min_shifted_points`` of its points were found; its score is minus the
    mean error of those points."""
    scale = new_img.scale
    out: List[List[ShiftedInstance]] = [[] for _ in pairs]
    groups: Dict[Tuple[int, int], List[int]] = {}
    for k, (_, ref_img, _) in enumerate(pairs):
        groups.setdefault(ref_img.shape, []).append(k)
    for inds in groups.values():
        pts = [np.concatenate([inst.numpy() for inst in pairs[k][2]], axis=0).astype("f4") * scale
               for k in inds]
        n_max = max(len(p) for p in pts)
        batch = np.full((len(inds), n_max, 2), np.nan, dtype="f4")
        for b, p in enumerate(pts):
            batch[b, :len(p)] = p
        device = new_img.pyramid[0].device
        ref_pyr = [torch.cat([pairs[k][1].pyramid[lv] for k in inds])
                   for lv in range(len(new_img.pyramid))]
        new_pyr = [lv.expand(len(inds), -1, -1) for lv in new_img.pyramid]
        shifted, status, errs = lk_flow_pyramids(
            ref_pyr, new_pyr, torch.from_numpy(batch).to(device), window_size=window_size)
        shifted, status, errs = shifted.cpu().numpy(), status.cpu().numpy(), errs.cpu().numpy()
        for b, k in enumerate(inds):
            frame_t, _, ref_instances = pairs[k]
            n = len(pts[b])
            out[k] = _shifted_instances(ref_instances, shifted[b, :n] / scale, status[b, :n],
                                        errs[b, :n], min_shifted_points, frame_t)
    return out


def _shifted_instances(ref_instances, shifted_pts, status, errs, min_shifted_points, frame_t):
    sections = np.cumsum([len(inst.numpy()) for inst in ref_instances])[:-1]
    result = []
    for ref, pts, found, err in zip(ref_instances, np.split(shifted_pts, sections),
                                    np.split(status, sections), np.split(errs, sections)):
        if found.sum() > min_shifted_points:
            result.append(ShiftedInstance(
                points_array=np.where(found[:, None], pts, np.nan),
                skeleton=ref.skeleton,
                track=ref.track,
                frame_t=frame_t,
                shift_score=-float(np.mean(err[found])) if found.any() else -np.inf,
            ))
    return result


# --------------------------------------------------------------------------- #
# Candidate makers
# --------------------------------------------------------------------------- #


@dataclass
class SimpleCandidateMaker:
    """Candidates are the raw instances of the prior window."""

    min_points: int = 0
    uses_image: bool = False

    def get_candidates(self, track_matching_queue, t=None, img=None, **kwargs):
        candidates = []
        for match_item in track_matching_queue:
            for inst in match_item.instances_t:
                if inst.n_visible_points >= self.min_points:
                    candidates.append(inst)
        return candidates


@dataclass
class FlowCandidateMaker:
    """Flow-shift candidates: prior instances displaced by Lucas-Kanade
    optical flow on ``device``."""

    min_points: int = 0
    img_scale: float = 1.0
    of_window_size: int = 21
    of_max_levels: int = 3
    save_shifted_instances: bool = False
    uses_image: bool = True
    device: Union[str, torch.device] = "cuda"

    shifted_instances: Dict[Tuple[int, int], List[ShiftedInstance]] = field(default_factory=dict)

    def prepare_image(self, img) -> FlowImage:
        """The frame as the queue keeps it: its pyramid on ``device``."""
        return FlowImage.from_frame(img, self.img_scale, self.of_max_levels, self.device)

    def _shift(self, pairs, img) -> List[List[ShiftedInstance]]:
        if not pairs:
            return []
        return flow_shift_pairs(pairs, self.prepare_image(img), self.min_points,
                                self.of_window_size)

    def get_candidates(self, track_matching_queue, t=None, img=None, **kwargs):
        items = [item for item in track_matching_queue
                 if item.instances_t and item.img_t is not None and img is not None]
        pairs = [(item.t, self.prepare_image(item.img_t), item.instances_t) for item in items]
        candidates = []
        for item, shifted in zip(items, self._shift(pairs, img)):
            if self.save_shifted_instances:
                self.shifted_instances[(item.t, t)] = shifted
            candidates.extend(shifted)
        return candidates

    @staticmethod
    def flow_shift_instances(
        ref_instances: List[Any],
        ref_img,
        new_img,
        min_shifted_points: int = 0,
        scale: float = 1.0,
        window_size: int = 21,
        max_levels: int = 3,
        frame_t: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> List[ShiftedInstance]:
        """Shift prior instances onto the new frame (the JAX signature)."""
        ref, new = (FlowImage.from_frame(im, scale, max_levels, device) for im in (ref_img, new_img))
        return flow_shift_pairs([(frame_t, ref, ref_instances)], new, min_shifted_points,
                                window_size)[0]


@dataclass
class PrecomputedFlowCandidateMaker:
    """Flow-shift candidates from externally computed shifts:
    ``shift_fn(ref_t, t, ref_instances)`` returns the
    :class:`ShiftedInstance` list for the reference frame's instances
    displaced onto frame ``t`` (empty or None when there are none)."""

    shift_fn: Any = None
    uses_image: bool = False

    def get_candidates(self, track_matching_queue, t=None, img=None, **kwargs):
        candidates = []
        if self.shift_fn is None:
            return candidates
        for match_item in track_matching_queue:
            if not match_item.instances_t:
                continue
            shifted = self.shift_fn(match_item.t, t, match_item.instances_t)
            if shifted:
                candidates.extend(shifted)
        return candidates


@dataclass
class SimpleMaxTracksCandidateMaker(SimpleCandidateMaker):
    """Capped-track variant: one queue per track."""

    max_tracks: Optional[int] = None

    def get_candidates(self, track_matching_queue_dict, max_tracking=False, t=None, img=None,
                       **kwargs):
        candidates = []
        for track, queue in track_matching_queue_dict.items():
            for item in queue:
                if item.instance_t.n_visible_points >= self.min_points:
                    candidates.append(item.instance_t)
        return candidates


@dataclass
class FlowMaxTracksCandidateMaker(FlowCandidateMaker):
    """Capped-track flow variant: each queued instance is shifted from its
    own frame; all of them in one batched call."""

    max_tracks: Optional[int] = None

    def get_candidates(self, track_matching_queue_dict, max_tracking=False, t=None, img=None,
                       **kwargs):
        pairs = [(item.t, self.prepare_image(item.img_t), [item.instance_t])
                 for queue in track_matching_queue_dict.values() for item in queue
                 if item.img_t is not None and img is not None]
        return [inst for shifted in self._shift(pairs, img) for inst in shifted]


# --------------------------------------------------------------------------- #
# Tracker
# --------------------------------------------------------------------------- #


@dataclass
class Tracker:
    """Frame-by-frame track assignment."""

    track_window: int = 5
    similarity_function: Optional[Callable] = instance_similarity
    matching_function: Callable = greedy_matching
    candidate_maker: Any = field(default_factory=FlowCandidateMaker)
    max_tracks: Optional[int] = None
    max_tracking: bool = False
    cleaner: Optional[Callable] = None
    target_instance_count: int = 0
    pre_cull_function: Optional[Callable] = None
    post_connect_single_breaks: bool = False
    robust_best_instance: float = 1.0
    min_new_track_points: int = 0

    track_matching_queue: Optional[Deque] = None
    track_matching_queue_dict: Dict = field(default_factory=dict)
    spawned_tracks: List[Track] = field(default_factory=list)
    last_matches: Optional[FrameMatches] = None

    def __post_init__(self):
        if self.track_matching_queue is None:
            self.track_matching_queue = deque(maxlen=self.track_window)

    @property
    def has_max_tracking(self) -> bool:
        return isinstance(self.candidate_maker,
                          (SimpleMaxTracksCandidateMaker, FlowMaxTracksCandidateMaker))

    @property
    def uses_image(self) -> bool:
        return getattr(self.candidate_maker, "uses_image", False)

    @property
    def is_valid(self) -> bool:
        return self.similarity_function is not None

    @property
    def unique_tracks_in_queue(self) -> List[Track]:
        """The tracks of the instances in the matching queue(s)."""
        tracks = set()
        if self.has_max_tracking:
            tracks.update(self.track_matching_queue_dict.keys())
        else:
            for item in self.track_matching_queue:
                for inst in item.instances_t:
                    tracks.add(inst.track)
        return list(tracks)

    def reset_candidates(self):
        if self.has_max_tracking:
            for track in self.track_matching_queue_dict:
                self.track_matching_queue_dict[track] = deque(maxlen=self.track_window)
        else:
            self.track_matching_queue = deque(maxlen=self.track_window)

    def track(
        self,
        untracked_instances: List[Any],
        img: Optional[np.ndarray] = None,
        t: Optional[int] = None,
        img_hw: Optional[Tuple[int, int]] = None,
    ) -> List[Any]:
        if self.candidate_maker is None:
            return untracked_instances
        sim_fn = self.similarity_function
        if sim_fn is normalized_instance_similarity and img_hw is not None:
            sim_fn = functools.partial(normalized_instance_similarity, img_hw=img_hw)

        if t is None:
            if self.has_max_tracking and self.track_matching_queue_dict:
                t = max((q[-1].t for q in self.track_matching_queue_dict.values() if q),
                        default=-1) + 1
            elif self.track_matching_queue:
                t = self.track_matching_queue[-1].t + 1
            else:
                t = 0

        tracked_instances: List[Any] = []
        if untracked_instances:
            # A frame with instances may serve as a later frame's reference:
            # it enters the queue as its pyramid, built once.
            if img is not None and hasattr(self.candidate_maker, "prepare_image"):
                img = self.candidate_maker.prepare_image(img)
            if self.pre_cull_function:
                self.pre_cull_function(untracked_instances)

            if self.has_max_tracking:
                candidates = self.candidate_maker.get_candidates(
                    track_matching_queue_dict=self.track_matching_queue_dict,
                    max_tracking=self.max_tracking, t=t, img=img,
                )
            else:
                candidates = self.candidate_maker.get_candidates(
                    track_matching_queue=self.track_matching_queue, t=t, img=img
                )

            frame_matches = FrameMatches.from_candidate_instances(
                untracked_instances=untracked_instances,
                candidate_instances=candidates,
                similarity_function=sim_fn,
                matching_function=self.matching_function,
                robust_best_instance=self.robust_best_instance,
            )
            self.last_matches = frame_matches

            for match in frame_matches.matches:
                match.instance.track = match.track
                match.instance.tracking_score = float(match.score)
                tracked_instances.append(match.instance)

            tracked_instances.extend(
                self.spawn_for_untracked_instances(frame_matches.unmatched_instances, t)
            )

        if self.has_max_tracking:
            for inst in tracked_instances:
                if inst.track in self.track_matching_queue_dict:
                    self.track_matching_queue_dict[inst.track].append(
                        MatchedFrameInstance(t, inst, img))
                elif not self.max_tracking or len(self.track_matching_queue_dict) < (
                        self.max_tracks or 0):
                    self.track_matching_queue_dict[inst.track] = deque(maxlen=self.track_window)
                    self.track_matching_queue_dict[inst.track].append(
                        MatchedFrameInstance(t, inst, img))
        else:
            self.track_matching_queue.append(MatchedFrameInstances(t, tracked_instances, img))
        return tracked_instances

    def spawn_for_untracked_instances(self, unmatched_instances: List[Any], t: int) -> List[Any]:
        """Create new tracks for unmatched instances."""
        results = []
        for inst in unmatched_instances:
            if inst.n_visible_points < self.min_new_track_points:
                continue
            if self.has_max_tracking and self.max_tracking and self.max_tracks:
                if len(self.track_matching_queue_dict) >= self.max_tracks:
                    continue
            track = Track(spawned_on=t, name=f"track_{len(self.spawned_tracks)}")
            self.spawned_tracks.append(track)
            inst.track = track
            inst.tracking_score = 1.0
            results.append(inst)
        return results

    def final_pass(self, frames) -> None:
        if self.cleaner:
            self.cleaner.run(frames)
        elif self.target_instance_count and self.post_connect_single_breaks:
            connect_single_track_breaks(frames, self.target_instance_count)

    def get_name(self) -> str:
        tracker_name = type(self.candidate_maker).__name__
        similarity_name = getattr(self.similarity_function, "__name__", "custom")
        match_name = getattr(self.matching_function, "__name__", "custom")
        return f"{tracker_name}.{similarity_name}.{match_name}"

    @classmethod
    def make_tracker_by_name(
        cls,
        tracker: str = "flow",
        similarity: str = "instance",
        match: str = "greedy",
        robust: float = 1.0,
        track_window: int = 5,
        min_new_track_points: int = 0,
        min_match_points: int = 0,
        img_scale: float = 1.0,
        of_window_size: int = 21,
        of_max_levels: int = 3,
        save_shifted_instances: bool = False,
        target_instance_count: int = 0,
        pre_cull_to_target: bool = False,
        pre_cull_iou_threshold: Optional[float] = None,
        post_connect_single_breaks: bool = False,
        clean_instance_count: int = 0,
        clean_iou_threshold: Optional[float] = None,
        max_tracking: bool = False,
        max_tracks: Optional[int] = None,
        oks_errors: Optional[list] = None,
        oks_score_weighting: bool = False,
        oks_normalization: str = "all",
        kf_node_indices: Optional[list] = None,
        kf_init_frame_count: int = 0,
        device: Union[str, torch.device] = "cuda",
        **kwargs,
    ) -> "Tracker":
        """The JAX factory's full option surface; flow runs on ``device``."""
        if tracker.lower() == "none":
            return cls(candidate_maker=None, similarity_function=None)

        if max_tracks is not None:
            max_tracking = True

        oks = factory_object_keypoint_similarity(
            keypoint_errors=oks_errors,
            score_weighting=oks_score_weighting,
            normalization_keypoints=oks_normalization,
        )
        similarity_map = {
            "instance": instance_similarity,
            "normalized_instance": normalized_instance_similarity,
            "centroid": centroid_distance,
            "iou": instance_iou,
            "object_keypoint": oks,
            "object keypoint": oks,
        }
        matching_map = {
            "hungarian": hungarian_matching,
            "greedy": greedy_matching,
            "first_choice": first_choice_matching,
        }
        if similarity not in similarity_map:
            raise ValueError(f"Unknown similarity {similarity!r}.")
        if match not in matching_map:
            raise ValueError(f"Unknown matching {match!r}.")

        flow = dict(min_points=min_match_points, img_scale=img_scale,
                    of_window_size=of_window_size, of_max_levels=of_max_levels, device=device)
        if tracker == "flow":
            if max_tracking:
                candidate_maker = FlowMaxTracksCandidateMaker(
                    save_shifted_instances=save_shifted_instances, max_tracks=max_tracks, **flow)
            else:
                candidate_maker = FlowCandidateMaker(
                    save_shifted_instances=save_shifted_instances, **flow)
        elif tracker == "simple":
            if max_tracking:
                candidate_maker = SimpleMaxTracksCandidateMaker(
                    min_points=min_match_points, max_tracks=max_tracks)
            else:
                candidate_maker = SimpleCandidateMaker(min_points=min_match_points)
        elif tracker == "simplemaxtracks":
            candidate_maker = SimpleMaxTracksCandidateMaker(
                min_points=min_match_points, max_tracks=max_tracks)
            max_tracking = True
        elif tracker == "flowmaxtracks":
            candidate_maker = FlowMaxTracksCandidateMaker(max_tracks=max_tracks, **flow)
            max_tracking = True
        else:
            raise ValueError(f"Unknown tracker {tracker!r}.")

        pre_cull_function = None
        if target_instance_count and pre_cull_to_target:
            def pre_cull_function(instances):
                instances[:] = cull_frame_instances(
                    instances, instance_count=target_instance_count,
                    iou_threshold=pre_cull_iou_threshold,
                )

        cleaner = None
        if clean_instance_count:
            cleaner = TrackCleaner(instance_count=clean_instance_count,
                                   iou_threshold=clean_iou_threshold)

        tracker_obj = cls(
            track_window=track_window,
            similarity_function=similarity_map[similarity],
            matching_function=matching_map[match],
            candidate_maker=candidate_maker,
            max_tracks=max_tracks,
            max_tracking=max_tracking,
            robust_best_instance=robust,
            min_new_track_points=min_new_track_points,
            target_instance_count=target_instance_count,
            pre_cull_function=pre_cull_function,
            post_connect_single_breaks=post_connect_single_breaks,
            cleaner=cleaner,
        )
        if kf_init_frame_count and kf_node_indices is not None:
            from sleap_tpu_torch.tracking.kalman import KalmanTracker

            return KalmanTracker.make_tracker(
                init_tracker=tracker_obj,
                node_indices=list(kf_node_indices),
                instance_count=target_instance_count or (max_tracks or 2),
                init_frame_count=kf_init_frame_count,
            )
        return tracker_obj


@dataclass
class TrackCleaner:
    """Post-hoc cull to the target count, then reconnect single breaks."""

    instance_count: int
    iou_threshold: Optional[float] = None

    def run(self, frames) -> None:
        cull_instances(frames, self.instance_count, self.iou_threshold)
        connect_single_track_breaks(frames, self.instance_count)


def run_tracker(frames, tracker) -> List:
    """Apply a tracker over labeled frames (in the order given)."""
    for lf in frames:
        instances = [inst for inst in lf.instances if isinstance(inst, PredictedInstance)]
        for inst in instances:
            inst.track = None
        img = lf.image if tracker.uses_image else None
        lf.instances = tracker.track(untracked_instances=instances, img=img, t=lf.frame_idx)
    tracker.final_pass(frames)
    return frames


def retrack(labels, tracker):
    """Re-run tracking over in-memory ``Labels``, frames in frame order;
    ``labels.tracks`` becomes the tracks in use, in order of first
    appearance."""
    frames = sorted(labels.labeled_frames, key=lambda lf: lf.frame_idx)
    run_tracker(frames, tracker)
    tracks: List[Track] = []
    for lf in frames:
        for inst in lf.instances:
            if inst.track is not None and not any(inst.track is x for x in tracks):
                tracks.append(inst.track)
    labels.tracks = tracks
    return labels


def main(args=None) -> None:
    """Re-track saved predictions: the JAX module's CLI and flags, and
    ``--cpu`` (flow runs on the card otherwise)."""
    import argparse

    from sleap_tpu_torch.core.labels import Labels

    parser = argparse.ArgumentParser(description="Run tracking on predictions.")
    parser.add_argument("data_path", help="Path to predictions (.slp).")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--tracking.tracker", dest="tracker", default="flow")
    parser.add_argument("--tracking.similarity", dest="similarity", default="instance")
    parser.add_argument("--tracking.match", dest="match", default="greedy")
    parser.add_argument("--tracking.track_window", dest="track_window", type=int, default=5)
    parser.add_argument("--tracking.max_tracks", dest="max_tracks", type=int, default=None)
    parser.add_argument(
        "--tracking.kf_init_frame_count", dest="kf_init_frame_count", type=int, default=0,
        help="If >0, init Kalman filters from this many flow-tracked frames.",
    )
    parser.add_argument(
        "--tracking.kf_node_indices", dest="kf_node_indices", default=None,
        help="Comma-separated node indices the Kalman filters track.",
    )
    parser.add_argument("--frames", default=None,
                        help="Frame range to retrack, e.g. 0-100 (default: all).")
    parser.add_argument("--cpu", action="store_true", help="Run the flow on the CPU.")
    ns = parser.parse_args(args)

    device = "cpu" if ns.cpu else "cuda"
    labels = Labels.load_file(ns.data_path, device=device)
    if ns.frames:
        lo, _, hi = ns.frames.partition("-")
        lo, hi = int(lo), int(hi or lo)
        labels = Labels([lf for lf in labels if lo <= lf.frame_idx <= hi])
    kf_nodes = [int(i) for i in ns.kf_node_indices.split(",")] if ns.kf_node_indices else None
    tracker = Tracker.make_tracker_by_name(
        tracker=ns.tracker,
        similarity=ns.similarity,
        match=ns.match,
        track_window=ns.track_window,
        max_tracks=ns.max_tracks,
        kf_init_frame_count=ns.kf_init_frame_count,
        kf_node_indices=kf_nodes,
        device=device,
    )
    retrack(labels, tracker)
    out = ns.output or (ns.data_path + ".retracked.slp")
    labels.save(out)


if __name__ == "__main__":
    main()
