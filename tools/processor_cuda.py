"""The processor ops alone on the card: chip_smoke.py's processor phase.

    PYTHONPATH=. python3 tools/processor_cuda.py [--frames 100] [--seed 0]

Writes chip_smoke.make_clip's synthetic clip (224x384, exact constant-shift
hierarchical2 flows) with a seeded depth stream in place of MiDaS's, then
runs chip_smoke.processor_phase on it with the default cameras: the 13 ops
of pipeline/processor.py through Processor.process (the filters on the
whole clip and, card vs CPU, on its first frames; compute_tracks through
the corner kernel; the solver ops on an 8-frame clip at full width), each
with its checks and seconds. Prints the card's name and power limit and
the phase's seconds. Needs one card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("processor_cuda: CUDA is not available", file=sys.stderr)
        return 1
    from robust_cvd_tpu_torch.io.store import VideoStore

    print(chip_smoke.device_line())
    with tempfile.TemporaryDirectory(prefix="processor_cuda_") as base:
        chip_smoke.make_clip(base, args.frames, args.seed)
        rng = np.random.default_rng(args.seed)
        depth = rng.uniform(1.0, 3.0, (args.frames, chip_smoke.H, chip_smoke.W))
        VideoStore.open(base).save_depth_stream("depth_midas2", depth.astype(np.float32))
        t0 = time.perf_counter()
        launches = chip_smoke.processor_phase(base, None, args.seed)
        print(f"processor phase {time.perf_counter() - t0:.3f} s, corner launches {launches}")
    print(chip_smoke.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
