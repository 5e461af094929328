"""The data-parallel mesh alone on the card: chip_smoke.py's mesh phase.

    PYTHONPATH=. python3 tools/mesh_cuda.py [--frames 100] [--epochs 1] [--seed 0]

Runs chip_smoke.pipeline_phase (the CLI in this one process, with the post
filter) at --epochs on a clip of color_full PNGs with seeded full-width
checkpoints, then chip_smoke.mesh_phase at the same --epochs: the CLI on
chip_smoke.MESH_RANKS spawned ranks that share the card over gloo, on a
copy of the clip's inputs, held to the one-process run's files, then the
nccl checks (a 1-rank group; with two or more cards, the CLI on one rank a
card). The kernels are built on their first launch. Prints both runs'
stages and epochs (seconds, steps, ms a step, the collectives' share) and
the launches by rank. Needs one card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mesh_cuda: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.device_line())
    with tempfile.TemporaryDirectory(prefix="mesh_cuda_") as base:
        clip = os.path.join(base, "clip")
        t0 = time.perf_counter()
        launches, proc = chip_smoke.pipeline_phase(clip, args.frames, args.seed, args.epochs)
        single = time.perf_counter() - t0
        history = proc.tuner.history
        del proc
        torch.cuda.empty_cache()
        mesh = chip_smoke.mesh_phase(clip, os.path.join(base, "mesh", "clip"), args.frames,
                                     args.epochs, history)
    print(f"one process: {single:.3f} s, launches {launches}; mesh launches by rank {mesh}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
