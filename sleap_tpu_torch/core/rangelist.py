"""RangeList: an ordered list of non-overlapping half-open (start, end)
ranges, which track occupancy is kept in (:mod:`sleap_tpu.core.rangelist`,
copied whole)."""

from __future__ import annotations

from typing import List, Optional, Tuple

Range = Tuple[int, int]


class RangeList:
    def __init__(self, range_list: Optional[List[Range]] = None):
        self._list: List[Range] = [tuple(r) for r in (range_list or [])]

    @property
    def list(self) -> List[Range]:
        return self._list

    @list.setter
    def list(self, val: List[Range]) -> None:
        self._list = [tuple(r) for r in val]

    @property
    def is_empty(self) -> bool:
        return len(self._list) == 0

    @property
    def start(self) -> Optional[int]:
        return self._list[0][0] if self._list else None

    def add(self, val: int) -> None:
        """Add a single value (the range (val, val + 1))."""
        self.insert((val, val + 1))

    def insert(self, new_range: Range) -> List[Range]:
        """Insert a range, merging overlapping and adjacent ranges."""
        new_range = self._as_tuple(new_range)
        if new_range[1] <= new_range[0]:
            return self._list
        result: List[Range] = []
        start, end = new_range
        placed = False
        for r in self._list:
            if r[1] < start:
                result.append(r)
            elif r[0] > end:
                if not placed:
                    result.append((start, end))
                    placed = True
                result.append(r)
            else:
                start = min(start, r[0])
                end = max(end, r[1])
        if not placed:
            result.append((start, end))
        self._list = result
        return self._list

    def insert_list(self, ranges: List[Range]) -> List[Range]:
        for r in ranges:
            self.insert(r)
        return self._list

    def remove(self, remove_range: Range) -> List[Range]:
        """Remove a range, splitting the ranges that straddle it."""
        rs, re = self._as_tuple(remove_range)
        result: List[Range] = []
        for a, b in self._list:
            if b <= rs or a >= re:
                result.append((a, b))
                continue
            if a < rs:
                result.append((a, rs))
            if b > re:
                result.append((re, b))
        self._list = result
        return self._list

    def cut(self, cut: int) -> Tuple[List[Range], List[Range]]:
        """Split into (before, after) lists at a value."""
        before, after = [], []
        for a, b in self._list:
            if b <= cut:
                before.append((a, b))
            elif a >= cut:
                after.append((a, b))
            else:
                before.append((a, cut))
                after.append((cut, b))
        return before, after

    def cut_range(self, cut: Range) -> Tuple[List[Range], List[Range], List[Range]]:
        """Split into (before, within, after) at a cut range."""
        cs, ce = self._as_tuple(cut)
        before, _ = self.__class__(self._list).cut(cs)
        _, after = self.__class__(self._list).cut(ce)
        mid_list, _ = self.__class__(self.__class__(self._list).cut(cs)[1]).cut(ce)
        return before, mid_list, after

    @staticmethod
    def join(list_list: List[List[Range]]) -> List[Range]:
        out = RangeList()
        for lst in list_list:
            out.insert_list(lst)
        return out.list

    @staticmethod
    def _as_tuple(r) -> Range:
        if isinstance(r, range):
            return (r.start, r.stop)
        return (int(r[0]), int(r[1]))

    def __repr__(self) -> str:
        return f"RangeList({self._list})"
