"""Registration against the truth on chip_smoke.py's flow store, JAX vs port.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/registration_share.py [--frames 100]

Builds the flow store of chip_smoke.py's flow phase (a seeded texture
panning 2 px a frame, color_flow 256x384 as the pipeline makes it), runs
the JAX package's register_pairs and the port's on the CPU over the
hierarchical2 pairs whose true shift is at most 96 px, in chunks of 16 as
the flow stage does, and prints for each package the share of pairs whose
H_BA maps the image centre within 1 px of the truth. chip_smoke.py holds
the port on the card to the JAX package's share (JAX_REGISTRATION_SHARE).

This tool runs the JAX package on purpose (it measures the reference), so
it is not one of the port's jax-free sources.
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

    import jax

    from robust_cvd_tpu.ops import homography as jh
    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, load_png_color
    from robust_cvd_tpu_torch.ops import homography as th
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    print(f"jax {jax.__version__} on {jax.devices()[0].platform}")
    with tempfile.TemporaryDirectory(prefix="registration_share_") as base:
        chip_smoke.flow_store(base, args.frames, args.seed)
        store = VideoStore.open(base)
        frames = np.stack([
            load_png_color(os.path.join(base, "color_flow", frame_name(i, ".png")))
            for i in range(store.num_frames)
        ])
    flow_hw = frames.shape[1:3]
    shift_px = chip_smoke.SHIFT * flow_hw[1] / chip_smoke.W
    pairs = [p for p in sample_pairs(args.frames, ("hierarchical2",), two_way=True)
             if abs(p[0] - p[1]) * shift_px <= 96]
    results = {"jax": {}, "torch": {}}
    t = {"jax": 0.0, "torch": 0.0}
    for s in range(0, len(pairs), 16):
        chunk = pairs[s : s + 16]
        im1 = frames[[i for i, _ in chunk]]
        im2 = frames[[j for _, j in chunk]]
        t0 = time.perf_counter()
        Hj = np.asarray(jh.register_pairs(im1, im2)[0])
        t1 = time.perf_counter()
        Ht = th.register_pairs(im1, im2)[0].numpy()
        t2 = time.perf_counter()
        t["jax"] += t1 - t0
        t["torch"] += t2 - t1
        for k, p in enumerate(chunk):
            results["jax"][p] = Hj[k]
            results["torch"][p] = Ht[k]
    worst_diff = max(np.abs(results["jax"][p] - results["torch"][p]).max() for p in pairs)
    print(f"{len(pairs)} pairs with |i - j| * {shift_px:g} <= 96 px at "
          f"{flow_hw[0]}x{flow_hw[1]}, {args.frames} frames, seed {args.seed}")
    for name, hs in results.items():
        hits, n, worst = chip_smoke.registration_truth(hs, flow_hw, shift_px)
        print(f"{name}: {hits} of {n} within 1 px, share {hits / n:.4f}, worst {worst:.4f} px "
              f"({t[name]:.1f} s on the CPU)")
    print(f"max |H_jax - H_torch| {worst_diff:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
