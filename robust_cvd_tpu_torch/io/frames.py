"""`frames.txt` — video metadata sidecar.

Format (reference video.py:91-97 writer, lib/Importer.cpp:197-238 reader):
    line 1: frame count
    line 2: width
    line 3: height
    lines 4..: one presentation timestamp (seconds) per frame

On load, timestamps are remapped to start at 0 and must be strictly
monotonic, matching the reference importer's behavior.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class VideoMeta:
    width: int
    height: int
    pts: tuple  # seconds, starting at 0.0

    @property
    def num_frames(self) -> int:
        return len(self.pts)

    @property
    def aspect(self) -> float:
        return self.width / self.height

    @property
    def inv_aspect(self) -> float:
        return self.height / self.width


def save_frames_txt(path, width: int, height: int, pts: Sequence[float]) -> None:
    lines = [str(len(pts)), str(width), str(height)]
    lines += [repr(float(t)) for t in pts]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_frames_txt(path) -> VideoMeta:
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    width = int(tokens[1])
    height = int(tokens[2])
    pts = [float(t) for t in tokens[3 : 3 + n]]
    if len(pts) != n:
        raise ValueError(f"{path}: expected {n} timestamps, got {len(pts)}")
    if n > 0:
        first = pts[0]
        pts = [t - first for t in pts]
        for a, b in zip(pts, pts[1:]):
            if b <= a:
                raise ValueError(f"{path}: non-monotonic timestamps")
    return VideoMeta(width=width, height=height, pts=tuple(pts))
