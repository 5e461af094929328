"""The flow path of chip_smoke.py alone, on one GPU.

    PYTHONPATH=. python3 tools/flow_path_cuda.py [--frames 100] [--seed 0]

Builds the kernels, checks RAFT on the card against the CPU, then drives
the flow phases of chip_smoke.py on a fresh synthetic clip: FlowStage over
the hierarchical2 pairs with its checks (registration against the truth
among them), the exact-flow mask check, registration card vs CPU, RAFT
bf16 vs float32, the corner kernel checked and timed at the registration's
shape, and the flow-chunk profile. About a minute; the pose and fine-tune
paths are left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flow_path_cuda: CUDA is not available", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    print(chip_smoke.device_line())
    chip_smoke.build_kernels()
    chip_smoke.raft_device_check(args.seed)
    with tempfile.TemporaryDirectory(prefix="flow_path_") as base:
        launches, stage = chip_smoke.flow_phase(os.path.join(base, "clip"), args.frames,
                                                args.seed)
        chip_smoke.exact_mask_check(os.path.join(base, "exact"), args.frames, args.seed)
        chip_smoke.flow_card_checks(stage)
        print(json.dumps(chip_smoke.corner_flow_entry(stage, launches)))
        chip_smoke.flow_profile_phase(stage)
    print(f"total_s {time.perf_counter() - t0:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
