"""Time the port's two CUDA kernels on one NVIDIA GPU, without the paths
(the Adam kernel in each of its optax modes: Adam, RAdam, a bf16 first
moment).

    PYTHONPATH=. python3 tools/time_kernels_cuda.py [--repeats 3] [--checks]

Builds both kernels and times them exactly as chip_smoke.py's kernel phase
does (its `corner_entry` at 100x224x384, `--repeats` times, and its
`adam_phase`), which takes well under a minute instead of the smoke run's
four. `--checks` also runs chip_smoke.py's corner checks at every edge
shape. Prints each kernels-line entry and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels_cuda: CUDA is not available", file=sys.stderr)
        return 1
    from robust_cvd_tpu_torch.models.midas import MidasNet

    print(chip_smoke.device_line())
    chip_smoke.build_kernels()
    g = torch.Generator().manual_seed(args.seed)
    gray = torch.rand((100, chip_smoke.H, chip_smoke.W), generator=g).cuda()
    err = chip_smoke.corner_check(gray, "path")
    for _ in range(args.repeats):
        print(json.dumps(chip_smoke.corner_entry(gray, err)))
    if args.checks:
        chip_smoke.corner_phase(100, args.seed)
    with torch.device("meta"):
        n = sum(p.numel() for p in MidasNet().parameters())
    for entry in chip_smoke.adam_phase(n, args.seed):
        print(json.dumps(entry))
    print(chip_smoke.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
