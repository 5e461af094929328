"""The whole pipeline alone on the card: chip_smoke.py's pipeline phase.

    PYTHONPATH=. python3 tools/pipeline_cuda.py [--frames 100] [--epochs 10] [--seed 0]
        [--variant "--save_tensorboard false" --variant "" ...]

Runs chip_smoke.pipeline_phase (main(["--path", clip, "--post_filter",
"true"]) on a clip of color_full PNGs with seeded full-width checkpoints,
and its checks) once per --variant, in the order given, each on a fresh
clip in this one process, then chip_smoke.post_filter_profile on it; a
variant is a string of extra CLI flags (the empty string: every other
default). The kernels are built on their first launch. Prints, per run, the
stage table, the epochs' seconds, the solves' totals and the post filter's
profile, and at the end one line per run with its total, train-step, solve
and post-filter seconds. Needs one card.
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variant", action="append", default=None,
                    help="extra CLI flags of one run (repeat for several runs)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("pipeline_cuda: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.device_line())
    rows = []
    for k, variant in enumerate(args.variant or [""]):
        print(f"== run {k}: flags {variant!r}")
        with tempfile.TemporaryDirectory(prefix="pipeline_cuda_") as base:
            t0 = time.perf_counter()
            launches, proc = chip_smoke.pipeline_phase(
                os.path.join(base, "clip"), args.frames, args.seed, args.epochs,
                argv=shlex.split(variant))
            total = time.perf_counter() - t0
            chip_smoke.post_filter_profile(proc)
        stats = proc.tuner.stats
        rows.append(f"run {k} flags {variant!r}: phase {total:.3f} s, train steps "
                    f"{stats['train_steps_s']:.3f} s, solves {stats['pose_opt_s']:.3f} s, "
                    f"post filter {stats['post_filter_s']:.3f} s, launches {launches}")
        del proc
        torch.cuda.empty_cache()
    for row in rows:
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
