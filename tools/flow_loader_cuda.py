"""The flow stage's chunk loader on the card: `FlowStage.load_chunk` against
the loop it replaced, on the flow cell's own clip.

    PYTHONPATH=. python3 tools/flow_loader_cuda.py [--seed 7400000011]
        [--chunks K] [--device cuda|cpu --tiny]

Writes the `raft_things-1024.flow` cell's clip from the seed
(cvd_bench/stages/flow.py's `write_clip`: 100 color_flow PNGs of 576x1024),
then for each 16-pair chunk of its hierarchical2 pairs (the first K with
--chunks) compares load_chunk's two (16, 576, 1024, 3) float32 tensors,
copied back, with `np.array_equal` against `np.stack` of `load_png_color`
over every padded pair, the loop the loader replaced. Times both: the
loader on the host clock to a synchronize, with its `flow.decode` and
`flow.upload` spans; the loop's decodes, stack and blocking copy to the
device. Prints one JSON line. `--tiny` cuts the clip to 12 frames of
96x160 (a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def write_cell_clip(base: str, seed: int, tiny: bool) -> int:
    """The flow cell's clip under `base`; returns its frame count."""
    from cvd_bench import core
    from cvd_bench.stages import flow as bench_flow

    cfg = core.load_json(core.config_path("raft_things-1024"))
    if tiny:
        cfg["clip"].update(frames=12, flow_hw=[96, 160], down_hw=[48, 80])
    bench_flow.write_clip(base, cfg, core.load_json(core.mix_path("flow"))["shift_px"], seed)
    return cfg["clip"]["frames"]


def check_chunks(base: str, num_frames: int, batch: int, device: str, chunks=None) -> dict:
    """load_chunk against the loop over the clip's chunks: whether every
    chunk is bit-equal, the decodes a pair, and the milliseconds a chunk
    of each (medians)."""
    import numpy as np
    import torch

    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, load_png_color
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage
    from robust_cvd_tpu_torch.utils.spans import recent

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    stage = FlowStage(VideoStore.open(base), batch_size=batch, device=device)
    pairs = stage.sample_index_pairs(("hierarchical2",), num_frames)
    todo = [pairs[s : s + batch] for s in range(0, len(pairs), batch)][:chunks]
    stage.load_chunk(todo[0])  # the pool's threads and the pinned buffer
    sync()
    flow_dir = os.path.join(base, "color_flow")
    equal, frames, new_ms, decode_ms, upload_ms, loop_ms = True, [], [], [], [], []
    for chunk in todo:
        t0 = time.perf_counter()
        got = stage.load_chunk(chunk)
        sync()
        new_ms.append((time.perf_counter() - t0) * 1e3)
        [dec], [up] = recent("flow.decode", 1), recent("flow.upload", 1)
        frames.append(dec["attrs"]["frames"])
        decode_ms.append((dec["t1_ns"] - dec["t0_ns"]) / 1e6)
        upload_ms.append((up["t1_ns"] - up["t0_ns"]) / 1e6)
        padded = chunk + chunk[-1:] * (batch - len(chunk))
        t0 = time.perf_counter()
        want = [np.stack([load_png_color(os.path.join(flow_dir, frame_name(p[k], ".png")))
                          for p in padded]) for k in (0, 1)]
        [torch.from_numpy(w).to(device) for w in want]
        sync()
        loop_ms.append((time.perf_counter() - t0) * 1e3)
        equal &= all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got, want))
    med = statistics.median
    return {"chunks": len(todo), "pairs": sum(map(len, todo)), "bit_equal": bool(equal),
            "decodes_per_pair": sum(frames) / sum(map(len, todo)),
            "frames_min_max": [min(frames), max(frames)], "threads": dec["attrs"]["threads"],
            "loader_ms_a_chunk": med(new_ms), "decode_ms_a_chunk": med(decode_ms),
            "upload_ms_a_chunk": med(upload_ms), "loop_ms_a_chunk": med(loop_ms)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7400000011)
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    out = {}
    if args.device == "cuda":
        from cvd_bench.core import power_limit

        out["device"] = power_limit()
    with tempfile.TemporaryDirectory(prefix="flow_loader_") as tmp:
        base = os.path.join(tmp, "clip")
        n = write_cell_clip(base, args.seed, args.tiny)
        out.update(check_chunks(base, n, 16, args.device, args.chunks))
    print(json.dumps(out), flush=True)
    return 0 if out["bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
