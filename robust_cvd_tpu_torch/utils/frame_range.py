"""Frame ranges parsed from strings like "1,3,5-7".

Behavioral parity with reference lib/FrameRange.h:22-60 / utils/frame_range.py:
an ordered set of frame indices; an empty range resolves to ALL frames.
"""

from __future__ import annotations


class FrameRange:
    def __init__(self, spec: str = ""):
        self.spec = spec.strip()
        self._frames: list[int] | None = None
        if self.spec:
            frames: set[int] = set()
            for part in self.spec.split(","):
                part = part.strip()
                if not part:
                    continue
                if "-" in part:
                    lo, hi = part.split("-")
                    lo, hi = int(lo), int(hi)
                    if hi < lo:
                        raise ValueError(f"invalid range segment '{part}'")
                    frames.update(range(lo, hi + 1))
                else:
                    frames.add(int(part))
            self._frames = sorted(frames)

    def resolve(self, num_frames: int, clip: bool = True) -> "FrameRange":
        """Fill an empty range with all frames; optionally clip to bounds."""
        out = FrameRange()
        if self._frames is None:
            out._frames = list(range(num_frames))
        elif clip:
            out._frames = [f for f in self._frames if 0 <= f < num_frames]
        else:
            out._frames = list(self._frames)
        out.spec = out.to_string()
        return out

    def frames(self) -> list:
        if self._frames is None:
            raise ValueError("unresolved empty frame range")
        return self._frames

    def __iter__(self):
        return iter(self.frames())

    def __len__(self):
        return len(self.frames())

    def __contains__(self, frame: int) -> bool:
        return frame in set(self.frames())

    def in_range(self, frame: int) -> bool:
        return frame in self

    def first_frame(self) -> int:
        return self.frames()[0]

    def last_frame(self) -> int:
        return self.frames()[-1]

    def is_consecutive(self) -> bool:
        fr = self.frames()
        return all(b == a + 1 for a, b in zip(fr, fr[1:]))

    def to_string(self) -> str:
        """Canonical compact form, e.g. '0-4,7,9-10'."""
        if self._frames is None:
            return ""
        spans = []
        fr = self.frames()
        i = 0
        while i < len(fr):
            j = i
            while j + 1 < len(fr) and fr[j + 1] == fr[j] + 1:
                j += 1
            spans.append(str(fr[i]) if i == j else f"{fr[i]}-{fr[j]}")
            i = j + 1
        return ",".join(spans)

    def __repr__(self):
        return f"FrameRange({self.to_string()!r})"
