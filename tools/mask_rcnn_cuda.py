"""Mask R-CNN dynamic masks alone on the card: chip_smoke.py's mask_rcnn phase.

    PYTHONPATH=. python3 tools/mask_rcnn_cuda.py [--frames 100] [--seed 0] [--keep 20]
        [--frames-per-pass 2 ...]

Writes the pipeline clip's inputs (chip_smoke.mask_rcnn_clip: color_full
PNGs at 224x384, frames.txt, color_down), then runs
chip_smoke.mask_rcnn_phase (a seeded checkpoint with shaped heads,
compute_dynamic_masks_rcnn in bf16 over every frame, its checks and the
card-vs-CPU checks) and chip_smoke.mask_rcnn_profile, once per
--frames-per-pass value (pipeline/masks.py's RCNN_FRAMES_PER_PASS), each
on a fresh copy of the clip in this one process. Prints the phase's lines
(the stage's seconds a frame among them) and at the end one line per run
with the phase's seconds. Needs one card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep", type=int, default=chip_smoke.RCNN_KEEP)
    ap.add_argument("--frames-per-pass", type=int, action="append", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mask_rcnn_cuda: CUDA is not available", file=sys.stderr)
        return 1
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.pipeline import masks

    print(chip_smoke.device_line())
    rows = []
    with tempfile.TemporaryDirectory(prefix="mask_rcnn_cuda_") as base:
        clip = os.path.join(base, "clip")
        t0 = time.perf_counter()
        chip_smoke.mask_rcnn_clip(clip, args.frames, args.seed)
        print(f"stage mask_rcnn_clip_s {time.perf_counter() - t0:.3f}")
        for fpp in args.frames_per_pass or [masks.RCNN_FRAMES_PER_PASS]:
            print(f"== frames a pass: {fpp}")
            masks.RCNN_FRAMES_PER_PASS = fpp
            run = os.path.join(base, f"run{fpp}")
            shutil.copytree(clip, run)
            t0 = time.perf_counter()
            _, net = chip_smoke.mask_rcnn_phase(run, args.seed, keep=args.keep)
            phase = time.perf_counter() - t0
            store = VideoStore.open(run)
            chip_smoke.mask_rcnn_profile(net, store.load_color_full(),
                                         store.load_color_down().shape[1:3])
            rows.append(f"frames a pass {fpp}: phase {phase:.3f} s")
            del net
            torch.cuda.empty_cache()
    for row in rows:
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
