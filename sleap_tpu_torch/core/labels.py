"""Labels: labeled frames with their videos, skeletons, tracks and
suggestions.

The container part of :class:`sleap_tpu.core.labels.Labels`: a sequence of
labeled frames whose videos, skeletons and tracks are collected, in order of
first appearance and compared by identity, into ``videos``, ``skeletons``
and ``tracks``; frames suggested for labeling (:class:`SuggestionFrame`),
negative anchors and a ``provenance`` dict; the lookups and selections
inference and training need (``find``, ``extract``, a seeded ``split``,
``with_user_labels_only``, ``remove_empty_frames``), and merging for
``.slp`` appends (``extend_from``), with the JAX package's semantics.
``save`` and :func:`load_file` write and read ``.slp`` files through the
port's own reader and writer (:mod:`sleap_tpu_torch.io.slp`).
"""

from __future__ import annotations

import copy as _copy
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from sleap_tpu_torch.core.instance import (
    POINT_DTYPE,
    PRED_POINT_DTYPE,
    Instance,
    LabeledFrame,
)


def _append_new(registry: list, item: Any) -> None:
    if item is not None and not any(item is x for x in registry):
        registry.append(item)


@dataclass(eq=False)
class SuggestionFrame:
    """A frame of a video suggested for labeling."""

    video: Any
    frame_idx: int
    group: Optional[int] = None


class Labels:
    def __init__(
        self,
        labeled_frames: Optional[List[LabeledFrame]] = None,
        videos: Optional[List[Any]] = None,
        skeletons: Optional[List[Any]] = None,
        tracks: Optional[List[Any]] = None,
        suggestions: Optional[List[SuggestionFrame]] = None,
        negative_anchors: Optional[Dict[Any, list]] = None,
        provenance: Optional[Dict[str, Any]] = None,
    ):
        self.labeled_frames: List[LabeledFrame] = list(labeled_frames or [])
        self.videos: List[Any] = list(videos or [])
        self.skeletons: List[Any] = list(skeletons or [])
        self.tracks: List[Any] = list(tracks or [])
        self.suggestions: List[SuggestionFrame] = list(suggestions or [])
        self.negative_anchors: Dict[Any, list] = negative_anchors or {}
        self.provenance: Dict[str, Any] = dict(provenance or {})
        self.update_cache()

    def update_cache(self) -> None:
        """Collect the videos, skeletons and tracks the frames refer to."""
        for lf in self.labeled_frames:
            _append_new(self.videos, lf.video)
            for inst in lf.instances:
                _append_new(self.skeletons, inst.skeleton)
                _append_new(self.tracks, inst.track)

    def __len__(self) -> int:
        return len(self.labeled_frames)

    def __iter__(self) -> Iterator[LabeledFrame]:
        return iter(self.labeled_frames)

    def __getitem__(self, i):
        return self.labeled_frames[i]

    def __repr__(self) -> str:
        return (
            f"Labels(labeled_frames={len(self)}, videos={len(self.videos)}, "
            f"skeletons={len(self.skeletons)}, tracks={len(self.tracks)})"
        )

    @property
    def user_instances(self) -> List[Instance]:
        return [inst for lf in self.labeled_frames for inst in lf.user_instances]

    @property
    def skeleton(self):
        """The single skeleton; raises if there is none or more than one."""
        if len(self.skeletons) == 1:
            return self.skeletons[0]
        raise ValueError(
            "Labels.skeleton can only be used when there is only a single skeleton saved in "
            "the labels. Use Labels.skeletons instead."
        )

    @property
    def video(self):
        """The single video; raises if there is none or more than one."""
        if len(self.videos) == 0:
            raise ValueError("There are no videos in the labels.")
        if len(self.videos) == 1:
            return self.videos[0]
        raise ValueError(
            "Labels.video can only be used when there is only a single video saved in the "
            "labels. Use Labels.videos instead."
        )

    def find(
        self, video: Any, frame_idx: Optional[Union[int, Iterable[int]]] = None
    ) -> List[LabeledFrame]:
        """The frames of ``video``, in frame order, or those labeled at
        ``frame_idx``."""
        by_idx = {lf.frame_idx: lf for lf in self.labeled_frames if lf.video is video}
        if frame_idx is None:
            return sorted(by_idx.values(), key=lambda lf: lf.frame_idx)
        if np.isscalar(frame_idx):
            frame_idx = [int(frame_idx)]
        return [by_idx[fi] for fi in map(int, frame_idx) if fi in by_idx]

    def find_first(self, video: Any, frame_idx: Optional[int] = None) -> Optional[LabeledFrame]:
        out = self.find(video, frame_idx)
        return out[0] if out else None

    @property
    def unlabeled_suggestions(self) -> List[SuggestionFrame]:
        """Suggestions whose frame has no user instance."""
        out = []
        for s in self.suggestions:
            lf = self.find_first(s.video, s.frame_idx)
            if lf is None or not lf.has_user_instances:
                out.append(s)
        return out

    def remove_empty_frames(self) -> None:
        self.labeled_frames = [lf for lf in self.labeled_frames if len(lf.instances) > 0]

    def merge_matching_frames(self) -> None:
        """Combine frames of the same (video, frame_idx) into the first."""
        merged: Dict[Tuple[int, int], LabeledFrame] = {}
        for lf in self.labeled_frames:
            key = (id(lf.video), lf.frame_idx)
            if key in merged:
                merged[key].instances.extend(lf.instances)
            else:
                merged[key] = lf
        self.labeled_frames = list(merged.values())

    def extend_from(self, other: "Labels", unify: bool = False) -> None:
        """Append the frames of ``other``. With ``unify``, their videos and
        skeletons become matching ones already here (videos by filename,
        skeletons by node names); frames that land on the same (video,
        frame_idx) merge."""
        if not other.labeled_frames:
            return
        incoming = Labels(labeled_frames=list(other.labeled_frames))
        if unify and self.labeled_frames:
            by_key = {_video_match_key(v): v for v in self.videos}
            by_key.pop(None, None)
            for lf in incoming.labeled_frames:
                lf.video = by_key.get(_video_match_key(lf.video), lf.video)
            _unify_skeletons(self, incoming)
        self.labeled_frames.extend(incoming.labeled_frames)
        self.merge_matching_frames()
        self.update_cache()

    def extract(self, inds: Iterable[int], copy: bool = False) -> "Labels":
        """New Labels with the selected frames; with ``copy``, deep copies of
        them that share the videos."""
        lfs = [self.labeled_frames[int(i)] for i in inds]
        if copy:
            lfs = _copy.deepcopy(lfs, {id(v): v for v in self.videos})
        return Labels(labeled_frames=lfs, provenance=dict(self.provenance))

    def split(
        self, n: Union[int, float], copy: bool = True, seed: Optional[int] = None
    ) -> Tuple["Labels", "Labels"]:
        """A random split into two Labels: ``n`` frames (a fraction when a
        float) and the rest. ``np.random.default_rng(seed)``'s permutation
        picks them, so a seed splits as the JAX package does."""
        n_total = len(self)
        n1 = max(int(round(n_total * n)), 1) if isinstance(n, float) else n
        n1 = min(n1, n_total - 1) if n_total > 1 else 1
        idx = np.random.default_rng(seed).permutation(n_total)
        if n_total == 1:
            return self.extract([0], copy=copy), self.extract([0], copy=copy)
        return (
            self.extract(sorted(idx[:n1]), copy=copy),
            self.extract(sorted(idx[n1:]), copy=copy),
        )

    def with_user_labels_only(
        self,
        user_instances_only: bool = True,
        with_track_only: bool = False,
        copy: bool = True,
    ) -> "Labels":
        """The frames with user instances, keeping only those (and only
        tracked ones with ``with_track_only``)."""
        inds = [i for i, lf in enumerate(self.labeled_frames) if lf.has_user_instances]
        new = self.extract(inds, copy=copy)
        for lf in new.labeled_frames:
            if user_instances_only:
                lf.instances = lf.user_instances
            if with_track_only:
                lf.instances = [i for i in lf.instances if i.track is not None]
        new.update_cache()
        return new

    # -- .slp files ---------------------------------------------------------- #
    def save(self, filename: str, with_images: bool = False, embed_all_labeled: bool = False,
             embed_suggested: bool = False, append: bool = False, image_format: str = "png") -> None:
        """Write a ``.slp`` file (making its directory); ``with_images``
        embeds the frames with user instances (every labeled frame with
        ``embed_all_labeled``, and the suggested ones with
        ``embed_suggested``) as PNG rows: a training package."""
        from sleap_tpu_torch.io import slp

        parent = os.path.dirname(filename)
        if parent:
            os.makedirs(parent, exist_ok=True)
        slp.write_labels(filename, self, save_frame_data=with_images, all_labeled=embed_all_labeled,
                         suggested=embed_suggested, image_format=image_format, append=append)

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
        (by default each source video's), none when ``progress_callback``
        returns False."""
        from sleap_tpu_torch.io import hdf5
        from sleap_tpu_torch.io.video import HDF5Video, Video

        out = []
        with hdf5.Writer(output_path, "a") as f:
            for v_idx, video in enumerate(self.videos):
                nums = self._frame_data_nums(video, all_labeled, suggested, user_labeled=user_labeled)
                video.write_hdf5(f, f"video{v_idx}", nums, format)
                out.append(Video(HDF5Video(filename=output_path, dataset=f"video{v_idx}/video",
                                           input_format="channels_last", convert_range=False,
                                           device=video._device(device))))
                if progress_callback is not None and \
                        progress_callback(v_idx, len(self.videos)) is False:
                    return []
        return out

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


def _unify_skeletons(base: Labels, new: Labels) -> None:
    """Put ``new``'s instances on ``base``'s skeletons. One skeleton each:
    matched by node name, base gaining the nodes it lacks (its instances get
    invisible points for them). Several: only structurally equal skeletons
    (node names, edges and symmetries) are swapped."""
    if not base.skeletons or not new.skeletons:
        return

    def rekey(instances, to_skel):
        for inst in instances:
            from_names = inst.skeleton.node_names
            out = np.zeros(to_skel.n_nodes, PRED_POINT_DTYPE if inst.predicted else POINT_DTYPE)
            out["x"] = out["y"] = np.nan
            for j, name in enumerate(to_skel.node_names):
                if name in from_names:
                    out[j] = inst.points[from_names.index(name)]
            inst.skeleton, inst.points = to_skel, out

    def instances_of(labels, skel):
        return [i for lf in labels.labeled_frames for i in lf.instances if i.skeleton is skel]

    if len(base.skeletons) == 1 and len(new.skeletons) == 1:
        old, incoming = base.skeletons[0], new.skeletons[0]
        if incoming is old:
            return
        grows = [name for name in incoming.node_names if name not in old.node_names]
        if grows:
            base_instances = instances_of(base, old)
            for name in grows:
                old.add_node(name)
            rekey(base_instances, old)
        rekey(instances_of(new, incoming), old)
        new.skeletons[0] = old
        return
    for idx, skel in enumerate(new.skeletons):
        if any(skel is s for s in base.skeletons):
            continue
        for old in base.skeletons:
            if _same_structure(skel, old):
                rekey(instances_of(new, skel), old)
                new.skeletons[idx] = old
                break


def _same_structure(a, b) -> bool:
    return (
        set(a.node_names) == set(b.node_names)
        and set(a.edge_names) == set(b.edge_names)
        and {frozenset(p) for p in a.symmetry_names} == {frozenset(p) for p in b.symmetry_names}
    )
