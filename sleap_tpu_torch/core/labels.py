"""Labels: labeled frames with their videos, skeletons and tracks.

The container part of :class:`sleap_tpu.core.labels.Labels`: a sequence of
labeled frames whose videos and skeletons are collected, in order of first
appearance and compared by identity, into ``videos``, ``skeletons`` and
``tracks``, plus a ``provenance`` dict; and the selection training needs
(``extract``, a seeded ``split``, ``with_user_labels_only``), with the JAX
package's semantics. Reading and writing ``.slp`` files is not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from sleap_tpu_torch.core.instance import Instance, LabeledFrame


def _append_new(registry: list, item: Any) -> None:
    if item is not None and not any(item is x for x in registry):
        registry.append(item)


class Labels:
    def __init__(self, labeled_frames: Optional[List[LabeledFrame]] = None,
                 provenance: Optional[Dict[str, Any]] = None,
                 tracks: Optional[List[Any]] = None):
        self.labeled_frames: List[LabeledFrame] = list(labeled_frames or [])
        self.provenance: Dict[str, Any] = dict(provenance or {})
        self.videos: List[Any] = []
        self.skeletons: List[Any] = []
        self.tracks: List[Any] = list(tracks or [])
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
