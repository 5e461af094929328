"""`flow_constraints.dat` v3 — the constraint cache format.

Byte-compatible with reference lib/FlowConstraints.cpp:116-224:

    [0xDEADBEEF:u32][version:u32=3][matchSeparation:i32]
    [numPairs:u64] per pair: [key:2xi32][count:u64][count x 2 x (x,y):f32]
    [numTriplets:u64] per triplet: [key:i32][count:u64][count x 3 x (x,y):f32]
    [0xDEADBEEF:u32]

`isStatic` is NOT serialized (reference FlowConstraints.h:96-104) — it is
recomputed from masks after load (pose_optimization.py:170-175).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 0xDEADBEEF
VERSION = 3


def save_flow_constraints_dat(
    path,
    match_separation: int,
    pairs: Dict[Tuple[int, int], np.ndarray],
    triplets: Dict[int, np.ndarray],
) -> None:
    """pairs: (i, j) -> (C, 2, 2) float32 [loc0, loc1] in normalized coords;
    triplets: t -> (C, 3, 2)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IIi", MAGIC, VERSION, match_separation))
        f.write(struct.pack("<Q", len(pairs)))
        for (i, j) in sorted(pairs):
            locs = np.asarray(pairs[(i, j)], np.float32)
            f.write(struct.pack("<iiQ", i, j, locs.shape[0]))
            f.write(locs.tobytes())
        f.write(struct.pack("<Q", len(triplets)))
        for t in sorted(triplets):
            locs = np.asarray(triplets[t], np.float32)
            f.write(struct.pack("<iQ", t, locs.shape[0]))
            f.write(locs.tobytes())
        f.write(struct.pack("<I", MAGIC))


def load_flow_constraints_dat(path):
    with open(path, "rb") as f:
        data = f.read()
    pos = 0

    def take(fmt):
        nonlocal pos
        vals = struct.unpack_from("<" + fmt, data, pos)
        pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    if take("I") != MAGIC:
        raise ValueError("missing magic at start of flow_constraints.dat")
    version = take("I")
    if version > VERSION:
        raise ValueError("flow_constraints.dat version too new")
    match_separation = take("i")

    pairs: Dict[Tuple[int, int], np.ndarray] = {}
    for _ in range(take("Q")):
        i, j, count = take("iiQ")
        locs = np.frombuffer(data, np.float32, count * 4, pos).reshape(count, 2, 2)
        pos += 16 * count
        pairs[(i, j)] = locs.copy()

    triplets: Dict[int, np.ndarray] = {}
    for _ in range(take("Q")):
        t, count = take("iQ")
        locs = np.frombuffer(data, np.float32, count * 6, pos).reshape(count, 3, 2)
        pos += 24 * count
        triplets[t] = locs.copy()

    if take("I") != MAGIC:
        raise ValueError("missing magic at end of flow_constraints.dat")
    return match_separation, pairs, triplets
