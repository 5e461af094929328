"""Frame-pair sampling for optical flow.

Behavioral parity with reference utils/frame_sampling.py:77-146. The default
pipeline mode is "hierarchical2": power-of-2 pair distances with midpoint
starts (stride = dist/2 for dist > 1), two-way. This gives O(N log N) pairs —
the video-length scaling mechanism of the whole system (there is no attention
anywhere; couplings stay pair-local so downstream solves stay sparse).
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Iterable, List, Tuple

Pair = Tuple[int, int]


class SamplePairsMode(Enum):
    EXHAUSTED = "exhausted"
    CONSECUTIVE = "consecutive"
    HIERARCHICAL = "hierarchical"
    HIERARCHICAL2 = "hierarchical2"

    @classmethod
    def names(cls):
        return [m.value for m in cls]


def sample_hierarchical(
    num_frames: int,
    two_way: bool,
    min_dist: int = 1,
    max_dist: int | None = None,
    include_mid_point: bool = False,
) -> set:
    assert min_dist >= 1
    if max_dist is None:
        max_dist = num_frames - 1
    if max_dist < min_dist:
        return set()
    min_level = math.ceil(math.log2(min_dist))
    max_level = math.floor(math.log2(max_dist))

    pairs = set()
    signs = (-1, 1) if two_way else (1,)
    for level in range(min_level, max_level + 1):
        dist = 1 << level
        step = 1 << (max(0, level - 1) if include_mid_point else level)
        for start in range(0, num_frames, step):
            for sign in signs:
                end = start + sign * dist
                if 0 <= end < num_frames:
                    pairs.add((start, end))
    return pairs


def sample_pairs(
    num_frames: int,
    modes: Iterable[str] = ("hierarchical2",),
    two_way: bool = True,
) -> List[Pair]:
    """Sample frame pairs; returns a sorted list of (i, j) index pairs."""
    pairs: set = set()
    for mode in modes:
        mode = SamplePairsMode(mode)
        if mode == SamplePairsMode.EXHAUSTED:
            pairs |= {
                (i, j)
                for i in range(num_frames)
                for j in (range(num_frames) if two_way else range(i + 1, num_frames))
                if i != j
            }
        elif mode == SamplePairsMode.CONSECUTIVE:
            pairs |= sample_hierarchical(num_frames, two_way, 1, 1)
        elif mode == SamplePairsMode.HIERARCHICAL:
            pairs |= sample_hierarchical(num_frames, two_way)
        elif mode == SamplePairsMode.HIERARCHICAL2:
            pairs |= sample_hierarchical(num_frames, two_way, include_mid_point=True)
    return sorted(pairs)


def to_one_way(pairs: Iterable[Pair]) -> List[Pair]:
    return sorted({(min(i, j), max(i, j)) for i, j in pairs})
