"""BED interval membership via sorted numpy arrays.

Replaces the reference's intervaltree dependency
(reference shared/interval_tree.py:7-56) with merged, sorted interval
arrays + searchsorted: point and range queries are O(log n) with tiny
constants, and a whole vector of positions can be tested in one call —
which is what the vectorized candidate extractor needs.
Intervals are 0-based half-open [start, end); zero-length rows are widened
to length 1 like the reference (:31-33).
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def _merge(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    merged_s, merged_e = [], []
    for s, e in zip(starts, ends):
        if merged_e and s <= merged_e[-1]:
            merged_e[-1] = max(merged_e[-1], e)
        else:
            merged_s.append(s)
            merged_e.append(e)
    return np.asarray(merged_s, dtype=np.int64), np.asarray(merged_e, dtype=np.int64)


class BedIntervals:
    """Per-contig merged interval sets with scalar and vector queries."""

    def __init__(self, per_contig: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None):
        self._per_contig: Dict[str, Tuple[np.ndarray, np.ndarray]] = per_contig or {}

    @classmethod
    def from_bed(cls, bed_file_path: Optional[str]) -> "BedIntervals":
        if bed_file_path is None:
            return cls()
        raw: Dict[str, list] = {}
        opener = gzip.open if str(bed_file_path).endswith(".gz") else open
        with opener(bed_file_path, "rt") as fh:
            for row in fh:
                row = row.strip()
                if not row or row.startswith(("#", "track", "browser")):
                    continue
                columns = row.split()
                ctg, start, end = columns[0], int(columns[1]), int(columns[2])
                if start == end:
                    end += 1
                raw.setdefault(ctg, []).append((start, end))
        per_contig = {}
        for ctg, rows in raw.items():
            arr = np.asarray(rows, dtype=np.int64)
            per_contig[ctg] = _merge(arr[:, 0], arr[:, 1])
        return cls(per_contig)

    @classmethod
    def from_intervals(cls, intervals: Iterable[Tuple[str, int, int]]) -> "BedIntervals":
        raw: Dict[str, list] = {}
        for ctg, start, end in intervals:
            raw.setdefault(ctg, []).append((start, max(end, start + 1)))
        per_contig = {}
        for ctg, rows in raw.items():
            arr = np.asarray(rows, dtype=np.int64)
            per_contig[ctg] = _merge(arr[:, 0], arr[:, 1])
        return cls(per_contig)

    def __len__(self) -> int:
        return len(self._per_contig)

    def __contains__(self, contig: str) -> bool:
        return contig in self._per_contig

    @property
    def is_empty(self) -> bool:
        return not self._per_contig

    def contains_point(self, contig: str, position: int) -> bool:
        """Is 0-based ``position`` inside any interval of ``contig``?"""
        entry = self._per_contig.get(contig)
        if entry is None:
            return False
        starts, ends = entry
        i = int(np.searchsorted(starts, position, side="right")) - 1
        return i >= 0 and position < ends[i]

    def overlaps_range(self, contig: str, start: int, end: int) -> bool:
        """Does [start, end) overlap any interval of ``contig``?"""
        entry = self._per_contig.get(contig)
        if entry is None:
            return False
        starts, ends = entry
        i = int(np.searchsorted(starts, end, side="left")) - 1
        return i >= 0 and start < ends[i]

    def contains_points(self, contig: str, positions: np.ndarray) -> np.ndarray:
        """Vectorized point membership for an array of 0-based positions."""
        entry = self._per_contig.get(contig)
        if entry is None:
            return np.zeros(len(positions), dtype=bool)
        starts, ends = entry
        idx = np.searchsorted(starts, positions, side="right") - 1
        valid = idx >= 0
        result = np.zeros(len(positions), dtype=bool)
        result[valid] = positions[valid] < ends[idx[valid]]
        return result
