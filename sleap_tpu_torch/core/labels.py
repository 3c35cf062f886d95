"""Labels: the frames ``predict`` returns, with their videos and skeletons.

The container part of :class:`sleap_tpu.core.labels.Labels`: a sequence of
labeled frames whose videos and skeletons are collected, in order of first
appearance and compared by identity, into ``videos``, ``skeletons`` and
``tracks``, plus a ``provenance`` dict. Reading and writing ``.slp`` files is not ported yet
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

from sleap_tpu_torch.core.instance import LabeledFrame


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
