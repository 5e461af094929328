"""The constraint-sharded pose solve and the batched .raw IO engine on the
card: chip_smoke.py's sharded_solve_check and io_engine_check.

    PYTHONPATH=. python3 tools/sharded_solve_cuda.py [--reps 1] [--frames 100] [--seed 0]

sharded_solve_check solves tests/test_torch_pkg_sharded_solve.py's static
scene on the card in this process and on chip_smoke.SHARDED_RANKS spawned
ranks sharing it over gloo (SolverParams bitwise equal on every rank,
poses and depth grid against one process's); --reps repeats it. Then
io_engine_check writes and reads one --frames-frame 224x384 depth stream
through native/io_engine.cpp and through io/raw.py's loop (files equal
byte for byte) and prints both times. Raises on a failed check. Needs one
card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--frames", type=int, default=chip_smoke.IO_FRAMES)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sharded_solve_cuda: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.device_line())
    for _ in range(args.reps):
        chip_smoke.sharded_solve_check()
    with tempfile.TemporaryDirectory(prefix="sharded_solve_cuda_") as base:
        chip_smoke.io_engine_check(base, args.frames, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
