"""Labels: labeled frames with their videos, skeletons, tracks and
suggestions.

:class:`sleap_tpu.core.labels.Labels` in plain Python and numpy: a mutable
sequence of labeled frames whose videos, skeletons and tracks are collected,
in order of first appearance, into ``videos``, ``skeletons`` and
``tracks``; frames suggested for labeling (:class:`SuggestionFrame`),
negative anchors and a ``provenance`` dict. It has the JAX package's whole
API with its semantics: lookup (``get``, ``find``, ``frames``), views,
instance and track edits (``track_swap``, ``merge_nodes``, ...), the
``remove_*`` family, suggestions, merging (``extend_from``, ``merge``, the
conflict-aware ``complex_merge_between``), ``numpy()`` (frames x tracks x
nodes x 2 or 3), ``to_dict``, ``describe``, the analysis exports
(:mod:`sleap_tpu_torch.info.write_tracking_h5`) and the importers of
:mod:`sleap_tpu_torch.io.formats`. ``save`` and :func:`load_file` write and
read ``.slp`` files through the port's own reader and writer
(:mod:`sleap_tpu_torch.io.slp`). NWB and NIX go through ``pynwb``/``ndx_pose``
and ``nixio`` (:mod:`sleap_tpu_torch.io.formats.ndx_pose`,
:mod:`~sleap_tpu_torch.io.formats.nix`), imported only when called.
"""

from __future__ import annotations

import copy as _copy
import os
from collections.abc import MutableSequence
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from sleap_tpu_torch.core.instance import (
    Instance,
    LabeledFrame,
    PredictedInstance,
    Track,
    empty_points,
)
from sleap_tpu_torch.core.rangelist import RangeList
from sleap_tpu_torch.core.skeleton import Node, Skeleton
from sleap_tpu_torch.io.video import Video

@dataclass(eq=False)
class SuggestionFrame:
    """A frame of a video suggested for labeling."""

    video: Any
    frame_idx: int
    group: Optional[int] = None


class Labels(MutableSequence):
    """Labeled frames plus the registries they share."""

    def __init__(
        self,
        labeled_frames: Optional[List[LabeledFrame]] = None,
        videos: Optional[List[Video]] = None,
        skeletons: Optional[List[Skeleton]] = None,
        tracks: Optional[List[Track]] = None,
        suggestions: Optional[List[SuggestionFrame]] = None,
        negative_anchors: Optional[Dict[Video, list]] = None,
        provenance: Optional[Dict[str, Any]] = None,
    ):
        self.labeled_frames: List[LabeledFrame] = list(labeled_frames or [])
        self.videos: List[Video] = list(videos or [])
        self.skeletons: List[Skeleton] = list(skeletons or [])
        self.tracks: List[Track] = list(tracks or [])
        self.suggestions: List[SuggestionFrame] = list(suggestions or [])
        self.negative_anchors: Dict[Video, list] = negative_anchors or {}
        self.provenance: Dict[str, Any] = dict(provenance or {})
        self.update_cache()

    # -- registries and the frame index ------------------------------------- #
    def _update_registries(self) -> None:
        for lf in self.labeled_frames:
            if lf.video is not None and lf.video not in self.videos:
                self.videos.append(lf.video)
            for inst in lf.instances:
                if inst.skeleton is not None and inst.skeleton not in self.skeletons:
                    self.skeletons.append(inst.skeleton)
                if inst.track is not None and inst.track not in self.tracks:
                    self.tracks.append(inst.track)

    def _frame_index(self) -> Dict[int, Dict[int, LabeledFrame]]:
        """video id -> frame index -> frame, rebuilt when ``labeled_frames``
        was replaced or changed length since the last build."""
        key = (id(self.labeled_frames), len(self.labeled_frames))
        if getattr(self, "_index_key", None) != key:
            index: Dict[int, Dict[int, LabeledFrame]] = {}
            for lf in self.labeled_frames:
                index.setdefault(id(lf.video), {})[lf.frame_idx] = lf
            self._lf_by_video, self._index_key = index, key
        return self._lf_by_video

    def update_cache(self) -> None:
        """Collect the videos, skeletons and tracks the frames refer to, and
        index the frames again."""
        self._update_registries()
        self._index_key = None

    # -- the sequence ------------------------------------------------------- #
    def __len__(self) -> int:
        return len(self.labeled_frames)

    def __iter__(self) -> Iterator[LabeledFrame]:
        return iter(self.labeled_frames)

    def __getitem__(self, key, *secondary_key):
        """:meth:`get`: None for a missing frame, IndexError past the end."""
        return self.get(key, *secondary_key)

    def __setitem__(self, i: int, value: LabeledFrame) -> None:
        self.labeled_frames[i] = value
        self.update_cache()

    def __delitem__(self, i: int) -> None:
        del self.labeled_frames[i]
        self.update_cache()

    def __contains__(self, item) -> bool:
        """Membership of a frame, video, skeleton, node or ``(video,
        frame_idx)`` pair."""
        if isinstance(item, LabeledFrame):
            return item in self.labeled_frames
        if isinstance(item, Video):
            return item in self.videos
        if isinstance(item, Skeleton):
            return item in self.skeletons
        if isinstance(item, Node):
            return any(item in skel.nodes for skel in self.skeletons)
        if (isinstance(item, tuple) and len(item) == 2 and isinstance(item[0], Video)
                and isinstance(item[1], (int, np.integer))):
            return bool(self.find(video=item[0], frame_idx=int(item[1])))
        raise ValueError("Item is not an object type contained in labels.")

    def insert(self, index: int, value: LabeledFrame) -> None:
        """Insert a frame, unless it, or a frame at its (video, frame_idx),
        is here already."""
        if value in self.labeled_frames:
            return
        if (value.video is not None and value.frame_idx is not None
                and (value.video, int(value.frame_idx)) in self):
            return
        self.labeled_frames.insert(index, value)
        self._register_frame(value)

    def append(self, value: LabeledFrame) -> None:
        self.insert(len(self.labeled_frames), value)

    def _register_frame(self, value: LabeledFrame) -> None:
        if value.video is not None and value.video not in self.videos:
            self.videos.append(value.video)
        for inst in value.instances:
            if inst.skeleton not in self.skeletons:
                self.skeletons.append(inst.skeleton)
            if inst.track is not None and inst.track not in self.tracks:
                self.tracks.append(inst.track)
        self._index_key = None

    def extend(self, values: Iterable[LabeledFrame]) -> None:
        for v in values:
            self.append(v)

    def extend_from(self, new_frames: Union["Labels", List[LabeledFrame]], unify: bool = False) -> bool:
        """Add the frames of another Labels or a list. With ``unify``, their
        videos and skeletons become matching ones already here (videos by
        filename, skeletons as :func:`_unify_skeletons` says); frames that
        land on the same (video, frame_idx) merge. False if there was
        nothing to add."""
        if isinstance(new_frames, Labels):
            new_frames = new_frames.labeled_frames
        if not isinstance(new_frames, list) or not new_frames:
            return False
        if not isinstance(new_frames[0], LabeledFrame):
            return False
        incoming = Labels(labeled_frames=list(new_frames))
        if unify and self.labeled_frames:
            by_key = {_video_match_key(v): v for v in self.videos}
            by_key.pop(None, None)
            for lf in incoming.labeled_frames:
                match = by_key.get(_video_match_key(lf.video))
                if match is not None:
                    lf.video = match
            _unify_skeletons(self, incoming)
        self.labeled_frames.extend(incoming.labeled_frames)
        self.merge_matching_frames()
        self.update_cache()
        return True

    # -- lookup ------------------------------------------------------------- #
    def find(self, video: Video, frame_idx: Optional[Union[int, Iterable[int]]] = None,
             return_new: bool = False) -> List[LabeledFrame]:
        """The frames of ``video`` in frame order, or those at ``frame_idx``
        (new empty frames for the missing ones with ``return_new``)."""
        by_idx = self._frame_index().get(id(video), {})
        if frame_idx is None:
            return sorted(by_idx.values(), key=lambda lf: lf.frame_idx)
        if np.isscalar(frame_idx):
            frame_idx = [int(frame_idx)]
        out = []
        for fi in map(int, frame_idx):
            if fi in by_idx:
                out.append(by_idx[fi])
            elif return_new:
                out.append(LabeledFrame(video=video, frame_idx=fi))
        return out

    def find_first(self, video: Video, frame_idx: Optional[int] = None,
                   use_cache: bool = True) -> Optional[LabeledFrame]:
        out = self.find(video, frame_idx)
        return out[0] if out else None

    def find_last(self, video: Video, frame_idx: Optional[int] = None) -> Optional[LabeledFrame]:
        out = self.find(video, frame_idx)
        return out[-1] if out else None

    def frames(self, video: Video, from_frame_idx: int = -1, reverse: bool = False):
        """All of a video's frames, starting just after ``from_frame_idx``
        (just before, with ``reverse``) and wrapping around."""
        frames = self.find(video)
        if not frames:
            return
        idxs = [f.frame_idx for f in frames]
        if reverse:
            start = max((i for i in idxs if i < from_frame_idx), default=idxs[-1])
        else:
            start = min((i for i in idxs if i > from_frame_idx), default=idxs[0])
        cut = idxs.index(start)
        yield from frames[cut:] + frames[:cut]

    def get(self, key, *secondary_key, use_cache: bool = False, raise_errors: bool = False):
        """A frame by position (int, slice, list or array), a video's frames,
        or the frame at ``(video, frame_idx)``; None for what is missing
        unless ``raise_errors`` (an int past the end raises IndexError)."""
        try:
            if secondary_key:
                if not isinstance(key, tuple):
                    key = (key,)
                key = key + tuple(secondary_key)
            if isinstance(key, slice):
                key = range(*key.indices(len(self)))
            elif isinstance(key, (np.integer, np.ndarray)):
                key = key.tolist()
            if isinstance(key, int):
                return self.labeled_frames[key]
            if isinstance(key, Video):
                if key not in self.videos:
                    raise KeyError("Video not found in labels.")
                return self.find(video=key)
            if isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], Video):
                if key[0] not in self.videos:
                    raise KeyError("Video not found in labels.")
                if isinstance(key[1], (np.integer, np.ndarray)):
                    key = (key[0], key[1].tolist())
                if isinstance(key[1], int):
                    hit = self.find_first(video=key[0], frame_idx=key[1], use_cache=use_cache)
                    if hit is None:
                        raise KeyError(f"No label found for specified video at frame {key[1]}.")
                    return hit
                if isinstance(key[1], (list, range)):
                    return self.find(video=key[0], frame_idx=key[1])
                raise KeyError("Invalid label indexing arguments.")
            if isinstance(key, (list, range)):
                return [self.get(int(i), raise_errors=True) for i in key]
            raise KeyError("Invalid label indexing arguments.")
        except KeyError:
            if raise_errors:
                raise
            return None

    # -- views -------------------------------------------------------------- #
    @property
    def user_labeled_frames(self) -> List[LabeledFrame]:
        return [lf for lf in self.labeled_frames if lf.has_user_instances]

    @property
    def predicted_frames(self) -> List[LabeledFrame]:
        return [lf for lf in self.labeled_frames if lf.has_predicted_instances]

    @property
    def all_instances(self) -> List[Instance]:
        return [inst for lf in self.labeled_frames for inst in lf.instances]

    @property
    def user_instances(self) -> List[Instance]:
        return [inst for lf in self.labeled_frames for inst in lf.user_instances]

    @property
    def predicted_instances(self) -> List[PredictedInstance]:
        return [inst for lf in self.labeled_frames for inst in lf.predicted_instances]

    @property
    def labels(self) -> List[LabeledFrame]:
        return self.labeled_frames

    @property
    def skeleton(self) -> Skeleton:
        """The single skeleton; raises if there is none or more than one."""
        if len(self.skeletons) == 1:
            return self.skeletons[0]
        raise ValueError(
            "Labels.skeleton can only be used when there is only a single skeleton saved in "
            "the labels. Use Labels.skeletons instead."
        )

    @property
    def video(self) -> Video:
        """The single video; raises if there is none or more than one."""
        if len(self.videos) == 0:
            raise ValueError("There are no videos in the labels.")
        if len(self.videos) == 1:
            return self.videos[0]
        raise ValueError(
            "Labels.video can only be used when there is only a single video saved in the "
            "labels. Use Labels.videos instead."
        )

    @property
    def has_missing_videos(self) -> bool:
        return any(v.is_missing for v in self.videos)

    def instance_count(self, video: Video, frame_idx: int) -> int:
        lf = self.find_first(video, frame_idx)
        return len(lf.instances) if lf is not None else 0

    def get_track_occupancy(self, video: Video) -> Dict[Track, RangeList]:
        """Each track's occupied frames in ``video`` as half-open ranges."""
        occupancy: Dict[Track, List[int]] = {}
        for lf in self.find(video):
            for inst in lf.instances:
                if inst.track is not None:
                    occupancy.setdefault(inst.track, []).append(lf.frame_idx)
        out = {}
        for track, idxs in occupancy.items():
            idxs = sorted(set(idxs))
            ranges, start, prev = [], idxs[0], idxs[0]
            for i in idxs[1:]:
                if i == prev + 1:
                    prev = i
                else:
                    ranges.append((start, prev + 1))
                    start = prev = i
            ranges.append((start, prev + 1))
            out[track] = RangeList(ranges)
        return out

    def get_track_count(self, video: Video) -> int:
        """The number of tracks occupied in ``video``."""
        return len(self.get_track_occupancy(video))

    @property
    def user_labeled_frame_inds(self) -> List[int]:
        return [i for i, lf in enumerate(self.labeled_frames) if lf.has_user_instances]

    def get_labeled_frame_count(self, video: Optional[Video] = None, filter: str = "") -> int:
        """The number of frames (of ``video``), or of those with user
        (``filter="user"``) or predicted (``"predicted"``) instances."""
        if filter not in ("", "user", "predicted"):
            raise ValueError(f"invalid filter: {filter!r}")
        count = 0
        for lf in self.labeled_frames:
            if video is not None and lf.video != video:
                continue
            if filter == "user" and not lf.has_user_instances:
                continue
            if filter == "predicted" and not lf.has_predicted_instances:
                continue
            count += 1
        return count

    get_frame_count = get_labeled_frame_count

    @property
    def max_user_instances(self) -> int:
        return max((lf.n_user_instances for lf in self.labeled_frames), default=0)

    @property
    def min_user_instances(self) -> Optional[int]:
        return min((lf.n_user_instances for lf in self.labeled_frames), default=None)

    @property
    def is_multi_instance(self) -> bool:
        """True if a frame has more than one user instance."""
        return self.max_user_instances > 1

    # -- editing ------------------------------------------------------------ #
    def add_video(self, video: Video) -> None:
        if video not in self.videos:
            self.videos.append(video)

    def remove_video(self, video: Video) -> None:
        """Remove a video with its frames and suggestions."""
        self.labeled_frames = [lf for lf in self.labeled_frames if lf.video is not video]
        self.suggestions = [s for s in self.suggestions if s.video is not video]
        if video in self.videos:
            self.videos.remove(video)
        self.update_cache()

    def add_track(self, video: Video, track: Track) -> None:
        if track not in self.tracks:
            self.tracks.append(track)

    def instances(self, video: Optional[Video] = None, skeleton: Optional[Skeleton] = None):
        """Iterate the instances, of ``video`` and ``skeleton`` if given."""
        for lf in self.labeled_frames:
            if video is None or lf.video == video:
                for inst in lf.instances:
                    if skeleton is None or inst.skeleton == skeleton:
                        yield inst

    def has_frame(self, lf: Optional[LabeledFrame] = None, video: Optional[Video] = None,
                  frame_idx: Optional[int] = None, use_cache: bool = True) -> bool:
        """True if a frame is here at this (video, frame_idx)."""
        if lf is not None:
            video, frame_idx = lf.video, lf.frame_idx
        if video is None or frame_idx is None:
            raise ValueError("Either lf or both video and frame_idx required.")
        if use_cache:
            return int(frame_idx) in self._frame_index().get(id(video), {})
        return any(f.video == video and f.frame_idx == frame_idx for f in self.labeled_frames)

    def add_instance(self, frame: LabeledFrame, instance: Instance) -> None:
        """Add ``instance`` to ``frame`` (and the frame to the labels),
        registering its track; a user instance of the frame on the same
        track clears the new instance's track."""
        tracks_in_frame = [inst.track for inst in frame.instances
                           if type(inst) is Instance and inst.track is not None]
        if instance.track in tracks_in_frame:
            instance.track = None
        frame.instances.append(instance)
        instance.frame = frame
        if instance.track is not None and instance.track not in self.tracks:
            self.add_track(frame.video, instance.track)
        if frame not in self.labeled_frames:
            self.append(frame)

    def remove_instance(self, frame: LabeledFrame, instance: Instance) -> None:
        frame.remove_instance(instance)

    def remove_track(self, track: Track) -> None:
        """Remove a track, clearing it from (but keeping) its instances."""
        for inst in self.instances():
            if inst.track == track:
                inst.track = None
        if track in self.tracks:
            self.tracks.remove(track)

    def remove_all_tracks(self) -> None:
        for inst in self.instances():
            inst.track = None
        self.tracks = []

    def remove_unused_tracks(self) -> None:
        used = {inst.track for inst in self.instances()}
        self.tracks = [t for t in self.tracks if t in used]

    def find_track_occupancy(self, video: Video, track: Union[Track, int],
                             frame_range=None) -> List[Instance]:
        """The instances on ``track`` in ``video`` (within ``frame_range``, a
        range or (start, end)). An int ``track`` is a position in the
        frame's instance list, matching untracked instances only."""
        if isinstance(frame_range, tuple):
            frame_range = range(*frame_range)

        def matches(inst, lf):
            if isinstance(track, Track):
                return inst.track is track
            return isinstance(track, int) and lf.instances.index(inst) == track and inst.track is None

        return [inst for lf in self.find(video)
                if frame_range is None or lf.frame_idx in frame_range
                for inst in lf.instances if matches(inst, lf)]

    def track_swap(self, video: Video, new_track: Track, old_track: Optional[Union[Track, int]],
                   frame_range: tuple) -> None:
        """Swap the instances of two tracks over a frame range; an int
        ``old_track`` (an instance position) moves its instances to
        ``new_track`` one way."""
        old_insts = self.find_track_occupancy(video, old_track, frame_range)
        new_insts = self.find_track_occupancy(video, new_track, frame_range)
        for inst in old_insts:
            inst.track = new_track
        if isinstance(old_track, Track):
            for inst in new_insts:
                inst.track = old_track

    def track_set_instance(self, frame: LabeledFrame, instance: Instance, new_track: Track) -> None:
        """Put ``instance`` on ``new_track``, swapping the frame's instance
        on that track onto the old one."""
        self.track_swap(frame.video, new_track, instance.track, (frame.frame_idx, frame.frame_idx + 1))
        instance.track = new_track
        if new_track not in self.tracks:
            self.add_track(frame.video, new_track)

    @classmethod
    def make_video_callback(cls, search_paths: Optional[List[str]] = None, **_) -> List[str]:
        """The ``video_search`` value of :meth:`load_file` for these search
        paths (the list itself)."""
        return list(search_paths or [])

    @classmethod
    def complex_merge_between(cls, base_labels: "Labels", new_labels: "Labels",
                              unify: bool = True) -> Tuple[Dict, List[LabeledFrame], List[LabeledFrame]]:
        """Merge ``new_labels`` into ``base_labels`` where it merges cleanly;
        frames where both sides keep unmatched instances of one kind come
        back as conflict lists (extra base frames, extra new frames) for
        :meth:`finish_complex_merge`. With ``unify``, the new videos and
        suggestions are first pointed at base videos of the same filename
        (or embedded source filename), and the skeletons unified."""
        if unify:
            by_key: Dict[str, Video] = {}
            for v in base_labels.videos:
                for key in _video_match_keys(v):
                    by_key.setdefault(key, v)

            def base_video(video):
                return next((by_key[k] for k in _video_match_keys(video) if k in by_key), None)

            for lf in new_labels.labeled_frames:
                match = base_video(lf.video)
                if match is not None:
                    lf.video = match
            for s in new_labels.suggestions:
                match = base_video(s.video)
                if match is not None:
                    s.video = match
            _unify_skeletons(base_labels, new_labels)
        merged, extra_base, extra_new = LabeledFrame.complex_merge_between(
            base_labels, new_labels.labeled_frames)
        if not extra_base and not extra_new:
            base_labels.update_cache()
        base_labels.suggestions.extend(new_labels.suggestions)
        return merged, extra_base, extra_new

    @staticmethod
    def finish_complex_merge(base_labels: "Labels", resolved_frames: List[LabeledFrame]) -> None:
        """Add the resolved conflict frames of :meth:`complex_merge_between`."""
        base_labels.labeled_frames.extend(resolved_frames)
        base_labels.merge_matching_frames()
        base_labels.update_cache()

    def merge_nodes(self, base_node: str, merge_node: str) -> None:
        """Merge ``merge_node`` into ``base_node`` everywhere: an instance
        keeps its base point where it has one and takes the merged node's
        otherwise; then the merged node leaves the skeletons (and the
        instances' points)."""
        for inst in self.instances():
            names = inst.skeleton.node_names
            if base_node in names and merge_node in names:
                inst._merge_nodes_data(base_node, merge_node)
        for skel in self.skeletons:
            if base_node in skel.node_names and merge_node in skel.node_names:
                skel.delete_node(merge_node)

    def copy(self) -> "Labels":
        """A deep copy of the frames and instances that shares the videos and
        tracks."""
        memo = {id(v): v for v in self.videos}
        memo.update({id(t): t for t in self.tracks})
        new = Labels(labeled_frames=_copy.deepcopy(self.labeled_frames, memo),
                     provenance=dict(self.provenance))
        new.tracks = list(self.tracks)
        new.suggestions = list(self.suggestions)
        return new

    # -- suggestions -------------------------------------------------------- #
    def add_suggestion(self, video: Video, frame_idx: int) -> None:
        if self.find_suggestion(video, frame_idx) is None:
            self.suggestions.append(SuggestionFrame(video=video, frame_idx=frame_idx))

    def remove_suggestion(self, video: Video, frame_idx: int) -> None:
        s = self.find_suggestion(video, frame_idx)
        if s is not None:
            self.suggestions.remove(s)

    def clear_suggestions(self) -> None:
        self.suggestions = []

    def get_suggestions(self) -> List[SuggestionFrame]:
        return self.suggestions

    def set_suggestions(self, suggestions: List[SuggestionFrame]) -> None:
        self.suggestions = list(suggestions)

    def append_suggestions(self, suggestions: List[SuggestionFrame]) -> None:
        self.suggestions.extend(suggestions)

    def find_suggestion(self, video: Video, frame_idx: int) -> Optional[SuggestionFrame]:
        return next((s for s in self.suggestions
                     if s.video == video and s.frame_idx == frame_idx), None)

    def get_video_suggestions(self, video: Video, user_labeled: bool = True) -> List[int]:
        """The suggested frame indices of ``video``; without those that have
        user instances when ``user_labeled`` is False."""
        out = []
        for s in self.suggestions:
            if s.video != video:
                continue
            if not user_labeled:
                lf = self.find(video, s.frame_idx)
                if lf and lf[0].has_user_instances:
                    continue
            out.append(s.frame_idx)
        return out

    @property
    def unlabeled_suggestions(self) -> List[SuggestionFrame]:
        """Suggestions whose frame has no user instance."""
        out = []
        for s in self.suggestions:
            lf = self.find(s.video, s.frame_idx)
            if not lf or not lf[0].has_user_instances:
                out.append(s)
        return out

    def get_unlabeled_suggestion_inds(self) -> List[int]:
        unlabeled = set(map(id, self.unlabeled_suggestions))
        return [i for i, s in enumerate(self.suggestions) if id(s) in unlabeled]

    def get_next_suggestion(self, video: Video, frame_idx: int, seek_direction: int = 1):
        """The next (or previous) suggestion: in list order from a suggested
        frame, else by frame order in ``video``, wrapping to the next
        video."""
        if seek_direction not in (-1, 1):
            raise ValueError("seek_direction should be -1 or 1.")
        if video not in self.videos or not self.suggestions:
            return None
        match = self.find_suggestion(video, frame_idx)
        if match is not None:
            idx = self.suggestions.index(match)
            return self.suggestions[(idx + seek_direction) % len(self.suggestions)]
        vid_inds = self.get_video_suggestions(video)
        if seek_direction == 1:
            cand = min((i for i in vid_inds if i > frame_idx), default=None)
        else:
            cand = max((i for i in vid_inds if i < frame_idx), default=None)
        if cand is not None:
            return self.find_suggestion(video, cand)
        next_video = self.videos[(self.videos.index(video) + seek_direction) % len(self.videos)]
        inds = self.get_video_suggestions(next_video)
        if not inds:
            return None
        return self.find_suggestion(next_video, min(inds) if seek_direction == 1 else max(inds))

    # -- removal ------------------------------------------------------------ #
    def remove_frame(self, lf: LabeledFrame) -> None:
        self.labeled_frames.remove(lf)
        self.update_cache()

    def remove_frames(self, lfs: List[LabeledFrame]) -> None:
        gone = set(id(lf) for lf in lfs)
        self.labeled_frames = [lf for lf in self.labeled_frames if id(lf) not in gone]
        self.update_cache()

    def remove_empty_frames(self) -> None:
        self.labeled_frames = [lf for lf in self.labeled_frames if len(lf.instances) > 0]
        self.update_cache()

    def remove_empty_instances(self, keep_empty_frames: bool = True) -> None:
        """Remove instances with no visible point (and then the empty frames
        unless ``keep_empty_frames``)."""
        for lf in self.labeled_frames:
            lf.remove_empty_instances()
        self.update_cache()
        if not keep_empty_frames:
            self.remove_empty_frames()

    def remove_user_instances(self, new_labels: Optional["Labels"] = None) -> None:
        """Remove the user instances; frames left without predictions go.
        With ``new_labels``, only frames it also has are touched."""
        keep = []
        for lf in self.labeled_frames:
            if new_labels is not None and not new_labels.has_frame(lf):
                keep.append(lf)
            elif lf.has_predicted_instances:
                lf.instances = lf.predicted_instances
                keep.append(lf)
        self.labeled_frames = keep
        self.update_cache()

    def remove_predictions(self, new_labels: Optional["Labels"] = None) -> None:
        """Remove the predicted instances; frames left without user
        instances go. With ``new_labels``, only frames it also has are
        touched."""
        keep = []
        for lf in self.labeled_frames:
            if new_labels is not None and not new_labels.has_frame(lf):
                keep.append(lf)
            elif lf.has_user_instances:
                lf.instances = lf.user_instances
                keep.append(lf)
        self.labeled_frames = keep
        self.update_cache()

    def remove_untracked_instances(self, remove_empty_frames: bool = True) -> None:
        for lf in self.labeled_frames:
            lf.remove_untracked()
        if remove_empty_frames:
            self.remove_empty_frames()

    def merge_matching_frames(self) -> None:
        """Combine frames of the same (video, frame_idx) into the first."""
        merged: Dict[Tuple[int, int], LabeledFrame] = {}
        for lf in self.labeled_frames:
            key = (id(lf.video), lf.frame_idx)
            if key in merged:
                for inst in lf.instances:
                    merged[key].insert_instance(inst)
            else:
                merged[key] = lf
        self.labeled_frames = list(merged.values())
        self.update_cache()

    def merge(self, other: "Labels") -> None:
        """Add ``other``'s frames: a frame at a (video, frame_idx) here
        gains the instances whose points match none of its own (videos
        matched by filename); other frames are appended."""
        video_map = {}
        for v_other in other.videos:
            key = _video_match_key(v_other)
            if key is None:
                continue
            for v_self in self.videos:
                if _video_match_key(v_self) == key:
                    video_map[id(v_other)] = v_self
                    break
        for lf in other.labeled_frames:
            video = video_map.get(id(lf.video), lf.video)
            existing = self.find_first(video, lf.frame_idx)
            if existing is None:
                new_lf = LabeledFrame(video=video, frame_idx=lf.frame_idx)
                for inst in lf.instances:
                    new_lf.insert_instance(inst)
                self.append(new_lf)
            else:
                existing_pts = [i.numpy() for i in existing.instances]
                for inst in lf.instances:
                    xy = inst.numpy()
                    if not any(e.shape == xy.shape and np.allclose(e, xy, equal_nan=True)
                               for e in existing_pts):
                        existing.insert_instance(inst)
        self.update_cache()

    # -- splitting ---------------------------------------------------------- #
    def extract(self, inds: Iterable[int], copy: bool = False) -> "Labels":
        """New Labels with the selected frames; with ``copy``, deep copies of
        them that share the videos."""
        lfs = [self.labeled_frames[int(i)] for i in inds]
        if copy:
            lfs = _copy.deepcopy(lfs, {id(v): v for v in self.videos})
        return Labels(labeled_frames=lfs, provenance=dict(self.provenance))

    def split(self, n: Union[int, float], copy: bool = True,
              seed: Optional[int] = None) -> Tuple["Labels", "Labels"]:
        """A random split into two Labels: ``n`` frames (a fraction when a
        float) and the rest. ``np.random.default_rng(seed)``'s permutation
        picks them, so a seed splits as the JAX package does."""
        n_total = len(self)
        n1 = max(int(round(n_total * n)), 1) if isinstance(n, float) else n
        n1 = min(n1, n_total - 1) if n_total > 1 else 1
        idx = np.random.default_rng(seed).permutation(n_total)
        if n_total == 1:
            return self.extract([0], copy=copy), self.extract([0], copy=copy)
        return self.extract(sorted(idx[:n1]), copy=copy), self.extract(sorted(idx[n1:]), copy=copy)

    def with_user_labels_only(self, user_instances_only: bool = True, with_track_only: bool = False,
                              copy: bool = True) -> "Labels":
        """The frames with user instances, keeping only those (and only
        tracked ones with ``with_track_only``)."""
        inds = [i for i, lf in enumerate(self.labeled_frames) if lf.has_user_instances]
        new = self.extract(inds, copy=copy)
        for lf in new.labeled_frames:
            if user_instances_only:
                lf.instances = lf.user_instances
            if with_track_only:
                lf.instances = lf.tracked_instances
        new.update_cache()
        return new

    # -- arrays ------------------------------------------------------------- #
    def numpy(self, video: Optional[Union[Video, int]] = None, all_frames: bool = True,
              untracked: bool = False, return_confidence: bool = False) -> np.ndarray:
        """(frames, tracks, nodes, 2) float32 points of ``video`` (a video or
        an index; the first by default); with ``return_confidence`` the last
        axis is 3 (x, y, point score; NaN for user instances).

        ``all_frames`` spans the whole video, else the labeled range. A
        frame with user instances gives only those. With ``untracked`` (or
        at most one instance a frame) instances fill the track axis in
        frame order; else each goes to its track's position in ``tracks``
        and untracked ones are left out.
        """
        try:
            if video is None:
                video = self.videos[0]
            if isinstance(video, int):
                video = self.videos[video]
        except IndexError:
            raise IndexError("There are no videos in this project. No points matrix to return.")
        lfs = self.find(video)
        n_cols = 3 if return_confidence else 2
        if not lfs:
            return np.zeros((0, 0, 0, n_cols), dtype="float32")
        frame_idxs = sorted(lf.frame_idx for lf in lfs)
        first_frame = 0 if all_frames else frame_idxs[0]
        last_frame = (video.num_frames - 1) if all_frames else frame_idxs[-1]
        n_insts = max(lf.n_user_instances if lf.n_user_instances > 0 else lf.n_predicted_instances
                      for lf in lfs)
        untracked = untracked or n_insts == 1
        n_tracks = n_insts if untracked else len(self.tracks)
        out = np.full((last_frame - first_frame + 1, n_tracks, self.skeleton.n_nodes, n_cols),
                      np.nan, dtype="float32")

        def fill(fi, j, inst):
            out[fi, j, :, :2] = inst.numpy()
            if return_confidence and isinstance(inst, PredictedInstance):
                out[fi, j, :, 2] = inst.scores

        for lf in lfs:
            fi = lf.frame_idx - first_frame
            insts = lf.user_instances if lf.n_user_instances > 0 else lf.predicted_instances
            if untracked:
                for j, inst in enumerate(insts[:n_tracks]):
                    fill(fi, j, inst)
            else:
                for inst in insts:
                    if inst.track is not None:
                        fill(fi, self.tracks.index(inst.track), inst)
        return out

    def describe(self) -> None:
        """Print the skeleton, videos, frame and instance counts, tracks,
        suggestions and provenance."""
        print(f"Skeleton: {self.skeleton}")
        print(f"Videos: {[v.filename for v in self.videos]}")
        n_user = n_pred = n_user_inst = n_pred_inst = 0
        for lf in self.labeled_frames:
            user, pred = lf.user_instances, lf.predicted_instances
            if user:
                n_user += 1
                n_user_inst += len(user)
            if pred:
                n_pred += 1
                n_pred_inst += len(pred)
        print(f"Frames (user/predicted): {n_user:,}/{n_pred:,}")
        print(f"Instances (user/predicted): {n_user_inst:,}/{n_pred_inst:,}")
        print("Tracks:", self.tracks)
        print(f"Suggestions: {len(self.suggestions):,}")
        print("Provenance:", self.provenance)

    # -- exports ------------------------------------------------------------ #
    def export(self, filename: str) -> None:
        """Write the analysis HDF5 file of the first video."""
        from sleap_tpu_torch.info.write_tracking_h5 import export_analysis_file

        export_analysis_file(self, filename, all_frames=True)

    def export_csv(self, filename: str) -> None:
        """Write the analysis CSV of the first video."""
        from sleap_tpu_torch.info.write_tracking_h5 import export_analysis_file

        export_analysis_file(self, filename, csv=True)

    def export_nwb(self, filename: str, **kwargs) -> None:
        """Write the predicted instances to NWB (needs ``pynwb`` and
        ``ndx-pose``; :func:`sleap_tpu_torch.io.formats.ndx_pose.write_labels`)."""
        from sleap_tpu_torch.io.formats import ndx_pose

        ndx_pose.write_labels(filename, self, **kwargs)

    def export_nix(self, filename: str, video=None, **kwargs) -> None:
        """Write a nixtrack file of ``video`` (needs ``nixio``;
        :func:`sleap_tpu_torch.io.formats.nix.write_labels`)."""
        from sleap_tpu_torch.io.formats import nix

        nix.write_labels(filename, self, video=video, **kwargs)

    def to_dict(self, skip_labels: bool = False) -> Dict[str, Any]:
        """The JSON project structure: one node list that skeletons refer to
        by index, and frames whose instances refer to videos, skeletons and
        tracks by index (read by :mod:`sleap_tpu_torch.io.formats.labels_json`)."""
        all_nodes: List[Node] = []
        for skel in self.skeletons:
            for node in skel.nodes:
                if node not in all_nodes:
                    all_nodes.append(node)
        node_to_idx = {node: i for i, node in enumerate(all_nodes)}
        d: Dict[str, Any] = {
            "version": "2.0.0",
            "skeletons": [s.to_dict(node_to_idx) for s in self.skeletons],
            "nodes": [{"name": n.name, "weight": n.weight} for n in all_nodes],
            "videos": [v.to_dict() for v in self.videos],
            "tracks": [{"spawned_on": t.spawned_on, "name": t.name} for t in self.tracks],
            "suggestions": [{"video": str(self.videos.index(s.video)), "frame_idx": s.frame_idx}
                            for s in self.suggestions if s.video in self.videos],
            "negative_anchors": {},
            "provenance": dict(self.provenance),
        }
        if not skip_labels:
            d["labels"] = [self._frame_to_dict(lf) for lf in self.labeled_frames]
        return d

    def _frame_to_dict(self, lf: LabeledFrame) -> Dict[str, Any]:
        insts = []
        for inst in lf.instances:
            pts = inst.points
            points_d = {}
            for i in range(len(pts)):
                if np.isnan(pts[i]["x"]) and np.isnan(pts[i]["y"]):
                    continue
                pd = {"x": float(pts[i]["x"]), "y": float(pts[i]["y"]),
                      "visible": bool(pts[i]["visible"]), "complete": bool(pts[i]["complete"])}
                if inst.predicted:
                    pd["score"] = float(pts[i]["score"])
                points_d[str(i)] = pd
            inst_d: Dict[str, Any] = {
                "skeleton": self.skeletons.index(inst.skeleton) if inst.skeleton in self.skeletons else 0,
                "track": self.tracks.index(inst.track) if inst.track in self.tracks else None,
                "_points": points_d,
            }
            if inst.predicted:
                inst_d["score"] = float(inst.score)
            insts.append(inst_d)
        return {"video": str(self.videos.index(lf.video)), "frame_idx": lf.frame_idx,
                "_instances": insts}

    # -- .slp files --------------------------------------------------------- #
    def save(self, filename: str, with_images: bool = False, embed_all_labeled: bool = False,
             embed_suggested: bool = False, append: bool = False, image_format: str = "png",
             device=None) -> None:
        """Write a ``.slp`` file (making its directory); ``with_images``
        embeds the frames with user instances (every labeled frame with
        ``embed_all_labeled``, and the suggested ones with
        ``embed_suggested``) as ``image_format`` rows, PNG, JPEG, BMP or TIFF
        (JPEG and TIFF encoded on ``device``, by default each video's): a
        training package."""
        from sleap_tpu_torch.io import slp

        parent = os.path.dirname(filename)
        if parent:
            os.makedirs(parent, exist_ok=True)
        slp.write_labels(filename, self, save_frame_data=with_images, all_labeled=embed_all_labeled,
                         suggested=embed_suggested, image_format=image_format, append=append,
                         device=device)

    @staticmethod
    def save_file(labels: "Labels", filename: str, **kwargs) -> None:
        labels.save(filename, **kwargs)

    @classmethod
    def save_hdf5(cls, labels: "Labels" = None, filename: str = None, **kwargs) -> None:
        labels.save(filename, **kwargs)

    @classmethod
    def load_hdf5(cls, filename: str, **kwargs) -> "Labels":
        return cls.load_file(filename, **kwargs)

    def _frame_data_nums(self, video, all_labeled: bool, suggested: bool,
                         user_labeled: bool = True) -> List[int]:
        """The frame numbers of ``video`` whose images the exporters write."""
        nums = {lf.frame_idx for lf in self.find(video)
                if all_labeled or (user_labeled and lf.has_user_instances)}
        if suggested:
            nums.update(s.frame_idx for s in self.suggestions if s.video is video)
        return sorted(nums)

    def save_frame_data_imgstore(self, output_dir: str = "./", format: str = "png",
                                 all_labeled: bool = False, suggested: bool = False,
                                 progress_callback: Optional[Callable] = None,
                                 device=None) -> list:
        """Each video's labeled frames as a PNG ImgStore
        ``output_dir/frame_data_vid{i}``; returns videos of them that decode
        on ``device`` (by default each source video's), none when
        ``progress_callback`` returns False."""
        out = []
        for v_idx, video in enumerate(self.videos):
            path = os.path.join(output_dir, f"frame_data_vid{v_idx}")
            out.append(video.to_imgstore(
                path=path, frame_numbers=self._frame_data_nums(video, all_labeled, suggested),
                format=format, device=device))
            if progress_callback is not None and progress_callback(v_idx, len(self.videos)) is False:
                return []
        return out

    def save_frame_data_hdf5(self, output_path: str, format: str = "png", user_labeled: bool = True,
                             all_labeled: bool = False, suggested: bool = False,
                             progress_callback: Optional[Callable] = None, device=None) -> list:
        """Each video's labeled frames as encoded rows in one HDF5 file,
        dataset ``video{i}`` a video, written in one pass (added to the file
        where it exists); returns videos of them that decode on ``device``
        (by default each source video's), where JPEG rows are encoded too,
        none when ``progress_callback`` returns False."""
        from sleap_tpu_torch.io import hdf5
        from sleap_tpu_torch.io.video import HDF5Video

        out = []
        read_device = self.videos[0]._device(device) if self.videos else device or "cuda"
        with hdf5.Writer(output_path, "a", device=read_device) as f:
            for v_idx, video in enumerate(self.videos):
                nums = self._frame_data_nums(video, all_labeled, suggested, user_labeled=user_labeled)
                video.write_hdf5(f, f"video{v_idx}", nums, format, device=device)
                out.append(Video(HDF5Video(filename=output_path, dataset=f"video{v_idx}/video",
                                           input_format="channels_last", convert_range=False,
                                           device=video._device(device))))
                if progress_callback is not None and \
                        progress_callback(v_idx, len(self.videos)) is False:
                    return []
        return out

    # -- importers ---------------------------------------------------------- #
    @classmethod
    def _load_as(cls, filename: str, fmt: str, **kwargs) -> "Labels":
        from sleap_tpu_torch.io import formats

        return formats.read(filename, as_format=fmt, **kwargs)

    @classmethod
    def load_deeplabcut(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "dlc", **kwargs)

    @classmethod
    def load_coco(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "coco", **kwargs)

    @classmethod
    def load_alphatracker(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "alphatracker", **kwargs)

    @classmethod
    def load_leap_matlab(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "leap", **kwargs)

    @classmethod
    def load_json(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "labels_json", **kwargs)

    @classmethod
    def load_nwb(cls, filename: str, **kwargs) -> "Labels":
        return cls._load_as(filename, "nwb", **kwargs)

    @classmethod
    def load_file(
        cls,
        filename: str,
        video_search: Optional[Union[Callable, List[str], bool]] = None,
        detect_videos: bool = True,
        search_paths: Optional[Union[str, List[str]]] = None,
        device="cuda",
    ) -> "Labels":
        """Read a ``.slp`` file. ``video_search`` is a callback, a list of
        paths, or False to keep stored video paths verbatim
        (``detect_videos=False`` does the same); ``search_paths`` is one
        path or a list to search for moved videos. Media videos decode on
        ``device``."""
        from sleap_tpu_torch.io import slp

        if video_search is None:
            if not detect_videos:
                video_search = False
            elif search_paths is not None:
                video_search = [search_paths] if isinstance(search_paths, str) else list(search_paths)
        return slp.read_labels(filename, video_search=video_search, device=device)

    def __repr__(self) -> str:
        return (
            f"Labels(labeled_frames={len(self.labeled_frames)}, videos={len(self.videos)}, "
            f"skeletons={len(self.skeletons)}, tracks={len(self.tracks)})"
        )


def load_file(filename: str, **kwargs) -> Labels:
    """Read a ``.slp`` file into :class:`Labels` (``sleap.load_file``)."""
    return Labels.load_file(filename, **kwargs)


def _video_match_key(video) -> Optional[str]:
    """A video's identity across labels: its filename on disk; None for an
    in-memory video, which matches nothing."""
    fn = getattr(video, "filename", None)
    if isinstance(fn, str) and fn and fn != "numpy_video":
        return fn
    return None


def _video_match_keys(video) -> List[str]:
    """Its filename, and for a package with embedded frames the filename of
    the video they came from."""
    keys = []
    key = _video_match_key(video)
    if key is not None:
        keys.append(key)
    backend = getattr(video, "backend", None)
    if getattr(backend, "has_embedded_images", False):
        src = getattr(backend, "_source_video_dict", None)
        if src:
            fn = src.get("backend", {}).get("filename")
            if isinstance(fn, str) and fn:
                keys.append(fn)
    return keys


def _unify_skeletons(base_labels: Labels, new_labels: Labels) -> None:
    """Put ``new_labels``' instances on ``base_labels``' skeletons. One
    skeleton each: matched by node name, the base skeleton gaining the nodes
    it lacks (its instances get missing points for them) and each new
    instance's points re-keyed by name into its order. Several: only
    structurally equal skeletons are swapped."""
    if not base_labels.skeletons or not new_labels.skeletons:
        return

    def swap(from_skel, to_skel):
        from_names, to_names = list(from_skel.node_names), list(to_skel.node_names)
        for lf in new_labels.labeled_frames:
            for inst in lf.instances:
                if inst.skeleton is not from_skel:
                    continue
                pts = inst.points.copy()
                inst.skeleton = to_skel
                out = empty_points(to_skel.n_nodes, predicted=inst.predicted)
                for j, name in enumerate(to_names):
                    if name in from_names:
                        out[j] = pts[from_names.index(name)]
                inst.points = out

    if len(base_labels.skeletons) == 1 and len(new_labels.skeletons) == 1:
        old, new_skel = base_labels.skeletons[0], new_labels.skeletons[0]
        if new_skel is old:
            return
        old_names = set(old.node_names)
        for name in new_skel.node_names:
            if name not in old_names:
                old.add_node(name)
        swap(new_skel, old)
        new_labels.skeletons[0] = old
    else:
        for idx, sk in enumerate(new_labels.skeletons):
            if sk in base_labels.skeletons:
                continue
            for old_sk in base_labels.skeletons:
                if sk.matches(old_sk):
                    swap(sk, old_sk)
                    new_labels.skeletons[idx] = old_sk
                    break
