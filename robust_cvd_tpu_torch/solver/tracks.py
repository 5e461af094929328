"""Long feature tracks: corner-seeded, flow-advected track table.

A copy of robust_cvd_tpu/solver/tracks.py (numpy on the host; the port
imports nothing of the JAX package), the reference's TrackTable machinery
(lib/core/TrackTable.h + DepthVideoProcessor::computeTracks,
lib/Processor.cpp:646-886): tracks are chained through consecutive forward
flow, gated by flow-consistency masks and the distance to dynamic pixels,
spawned at strong corners where no live track is near (spawn disk), pruned
where they collide (prune disk) or end up too short.

The corner response is computed on the device by the caller
(pipeline/processor.py, through the corner kernel on the card); the
sequential spawn and advance bookkeeping runs here with the native
disk-stamp and greedy-sampling helpers, including the reference's
int(f + 0.5) truncations.

Track locations are stored normalized to [0,1] x [0,inv_aspect], the
reference's Obs convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native


@dataclass
class Track:
    first_frame: int
    locs: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def length(self) -> int:
        return len(self.locs)

    def last_frame(self) -> int:
        return self.first_frame + len(self.locs) - 1

    def obs(self, frame: int) -> Tuple[float, float]:
        return self.locs[frame - self.first_frame]


class TrackTable:
    """Sequential-observation track store (reference core/TrackTable.h)."""

    def __init__(self):
        self.tracks: Dict[int, Track] = {}
        self.frames: List[List[int]] = []  # frame -> live track ids
        self._next_id = 0

    def add_frame(self):
        self.frames.append([])

    def create_track(self, frame: int, loc) -> int:
        tid = self._next_id
        self._next_id += 1
        self.tracks[tid] = Track(first_frame=frame, locs=[tuple(loc)])
        self.frames[frame].append(tid)
        return tid

    def add_obs(self, tid: int, frame: int, loc):
        t = self.tracks[tid]
        assert frame == t.last_frame() + 1
        t.locs.append(tuple(loc))
        self.frames[frame].append(tid)

    def num_tracks(self) -> int:
        return self._next_id

    def has_track(self, tid: int) -> bool:
        return tid in self.tracks

    def delete_track(self, tid: int):
        t = self.tracks.pop(tid)
        for k in range(t.length):
            self.frames[t.first_frame + k].remove(tid)

    def save_csv(self, path):
        """One track per line as frame,x,y triplets
        (reference Importer.cpp:480-533 reads this back)."""
        with open(path, "w") as f:
            for tid in sorted(self.tracks):
                t = self.tracks[tid]
                cells = []
                for k, (x, y) in enumerate(t.locs):
                    cells += [str(t.first_frame + k), repr(float(x)), repr(float(y))]
                f.write(",".join(cells) + "\n")

    def save_binary(self, path, num_frames: Optional[int] = None):
        """The reference's `DepthVideoTrackTable::save` wire format
        (core/TrackTable-impl.h:571-602 + TrackBaseSequential::serialize,
        TrackTable-impl.h:210-221): little-endian
        [numTracks u64] then per track slot
        [valid u8] { [firstFrame u64] [numObs u64] [numObs x (x f32, y f32)] },
        then [framesOffset u64] [numFrames u64] (FrameBase serializes no
        per-frame payload, TrackTable.h:195-198 — the per-frame track sets
        are reconstructed on load)."""
        import struct

        if num_frames is None:
            num_frames = len(self.frames)
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", self._next_id))
            for tid in range(self._next_id):
                t = self.tracks.get(tid)
                if t is None:
                    f.write(struct.pack("<?", False))
                    continue
                f.write(struct.pack("<?", True))
                f.write(struct.pack("<QQ", t.first_frame, t.length))
                f.write(np.asarray(t.locs, "<f4").tobytes())
            f.write(struct.pack("<QQ", 0, num_frames))

    @classmethod
    def load_binary(cls, path) -> "TrackTable":
        """Inverse of `save_binary`; reconstructs the per-frame live-track
        lists the way the reference's deserialize does
        (core/TrackTable-impl.h:649-694)."""
        import struct

        tt = cls()
        with open(path, "rb") as f:
            (num_tracks,) = struct.unpack("<Q", f.read(8))
            for tid in range(num_tracks):
                (valid,) = struct.unpack("<?", f.read(1))
                if not valid:
                    continue
                first, size = struct.unpack("<QQ", f.read(16))
                locs = np.frombuffer(f.read(8 * size), "<f4").reshape(size, 2)
                tt.tracks[tid] = Track(
                    first_frame=int(first),
                    locs=[(float(x), float(y)) for x, y in locs],
                )
            offset, num_frames = struct.unpack("<QQ", f.read(16))
        tt._next_id = num_tracks
        tt.frames = [[] for _ in range(offset + num_frames)]
        for tid in sorted(tt.tracks):
            t = tt.tracks[tid]
            for k in range(t.length):
                tt.frames[t.first_frame + k].append(tid)
        return tt


def compute_tracks(
    corner: np.ndarray,
    flows_fwd: Dict[int, np.ndarray],
    masks_fwd: Dict[int, np.ndarray],
    inv_aspect: float,
    dynamic_distance: Optional[np.ndarray] = None,
    spawn_distance: int = 20,
    prune_distance: int = 5,
    min_dynamic_distance: float = 3.0,
    min_track_length: int = 4,
) -> TrackTable:
    """Build the track table (reference Processor.cpp:646-886).

    corner: (N, H, W) corner strength; flows_fwd[i]: flow i -> i+1 (H, W, 2);
    masks_fwd[i]: bool (H, W); dynamic_distance: (N, H, W) or None.
    """
    N, h, w = corner.shape
    tt = TrackTable()

    def dd(frame):
        if dynamic_distance is None:
            return None
        return dynamic_distance[frame]

    for frame in range(N):
        tt.add_frame()
        spawn_mask = np.zeros((h, w), bool)
        prune_mask = np.zeros((h, w), bool)
        dyn = dd(frame)

        # continue tracks from the previous frame
        if frame > 0 and (frame - 1) in flows_fwd:
            flow = flows_fwd[frame - 1]
            fmask = masks_fwd[frame - 1]
            continued_x, continued_y = [], []
            for tid in list(tt.frames[frame - 1]):
                x0n, y0n = tt.tracks[tid].obs(frame - 1)
                fx0 = x0n * w
                fy0 = y0n / inv_aspect * h
                ix0 = min(int(fx0 + 0.5), w - 1)
                iy0 = min(int(fy0 + 0.5), h - 1)
                if not fmask[iy0, ix0]:
                    continue
                fx1 = fx0 + flow[iy0, ix0, 0]
                fy1 = fy0 + flow[iy0, ix0, 1]
                ix1, iy1 = int(fx1 + 0.5), int(fy1 + 0.5)
                if not (0 <= ix1 < w and 0 <= iy1 < h):
                    continue
                if prune_mask[iy1, ix1]:
                    continue
                if dyn is not None and dyn[iy1, ix1] < min_dynamic_distance:
                    continue
                tt.add_obs(tid, frame, (fx1 / w, fy1 / h * inv_aspect))
                continued_x.append(ix1)
                continued_y.append(iy1)
                prune_mask |= native.stamp_disks(
                    np.asarray([ix1], np.int32), np.asarray([iy1], np.int32),
                    w, h, prune_distance,
                )
            if continued_x:
                spawn_mask |= native.stamp_disks(
                    np.asarray(continued_x, np.int32),
                    np.asarray(continued_y, np.int32),
                    w, h, spawn_distance,
                )

        # spawn new tracks at strong un-covered corners
        if frame < N - 1:
            cand = np.ones((h, w), bool)
            if (frame - 1) in masks_fwd:
                cand &= np.asarray(masks_fwd[frame - 1], bool)
            if dyn is not None:
                cand &= dyn > min_dynamic_distance
            ys, xs = np.nonzero(cand)
            order = np.argsort(-corner[frame][ys, xs], kind="stable")
            xs, ys = xs[order], ys[order]
            keep = ~spawn_mask[ys, xs]
            xs, ys = xs[keep], ys[keep]
            sel = native.greedy_sample(xs, ys, w, h, spawn_distance)
            for x, y in zip(xs[sel], ys[sel]):
                tt.create_track(frame, (x / w, y / h * inv_aspect))

    for tid in range(tt.num_tracks()):
        if tt.has_track(tid) and tt.tracks[tid].length < min_track_length:
            tt.delete_track(tid)
    return tt
