"""The golden-scene quality gates alone on the card: chip_smoke.py's quality phase.

    PYTHONPATH=. python3 tools/quality_cuda.py

Runs chip_smoke.quality_phase (quality.py's static, dynamic and
contaminated-constraint gates at full size, 8 frames at 96x128, each held
to the JAX package's value on the CPU less chip_smoke.GATE_SLACK) once,
and prints the card's name and power limit, each
gate's value and seconds, and the phase's seconds. Needs one card.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("quality_cuda: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.device_line())
    t0 = time.perf_counter()
    chip_smoke.quality_phase()
    print(f"quality phase {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
