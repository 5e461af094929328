"""chip_smoke.py's card-vs-CPU filter check over many random cameras.

    PYTHONPATH=. python3 tools/filter_ties_cuda.py [--trials 25] [--frames 16]

Writes chip_smoke.make_clip's synthetic clip (224x384, exact constant-shift
hierarchical2 flows) and, for each trial, a seeded smooth depth stream
(0.45 +- 0.04) and seeded cameras (positions N(0, 0.02), small rotations),
then runs chip_smoke.filters_card_vs_cpu on it: the processor phase's four
filters on the card and on the CPU. Each trial's lines give the filters'
relative max|err|; the median's line also gives its error against the
CPU's own pick and the pixels whose weighted median ties (MEDIAN_TIE), which
is how often the card's median takes a neighbouring sample. Prints the
card's name and power limit and the trials that failed. Needs one card.
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
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("filter_ties_cuda: CUDA is not available", file=sys.stderr)
        return 1
    from robust_cvd_tpu_torch.camera import CameraState
    from robust_cvd_tpu_torch.config import PoseOptParams
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.pipeline.processor import Op, ProcessorParams

    def params(**kw):
        kw["op"] = Op[kw["op"]]
        return ProcessorParams(pose_optimizer=PoseOptParams(), **kw)

    print(chip_smoke.device_line())
    n, failed = args.frames, []
    with tempfile.TemporaryDirectory(prefix="filter_ties_cuda_") as base:
        chip_smoke.make_clip(base, n, 0)
        store = VideoStore.open(base)
        yy, xx = np.mgrid[0:chip_smoke.H, 0:chip_smoke.W] / 100.0
        for t in range(args.trials):
            rng = np.random.default_rng(t)
            ph = rng.uniform(0, 6, 3)
            depth = np.stack([
                0.45 + 0.03 * np.sin(xx + ph[0] + 0.02 * i) * np.cos(yy + ph[1])
                + 0.01 * np.sin(3 * xx * yy + ph[2]) + rng.normal(0, 2e-3, xx.shape)
                for i in range(n)]).astype(np.float32)
            store.save_depth_stream("depth", depth)
            cam = CameraState.default(n, store.aspect)
            rot = np.concatenate([rng.normal(0, 0.01, (n, 3)), np.ones((n, 1))], 1)
            quat = torch.from_numpy(rot.astype(np.float32))
            store.camera = CameraState(
                torch.from_numpy(rng.normal(0, 0.02, (n, 3)).astype(np.float32)),
                quat / quat.norm(dim=1, keepdim=True), cam.vfov, cam.hfov)
            t0 = time.perf_counter()
            try:
                chip_smoke.filters_card_vs_cpu(store, "depth", n, params)
                verdict = "pass"
            except AssertionError as e:
                verdict = f"failed: {e}"
                failed.append(t)
            print(f"trial {t}: {verdict} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"{len(failed)} of {args.trials} trials failed {failed}")
    print(chip_smoke.device_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
