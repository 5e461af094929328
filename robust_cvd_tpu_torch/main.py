"""Command-line entry point of the port (reference main.py:8-20).

    python -m robust_cvd_tpu_torch --path <clip> [flags of main.py]

The flags are those of the JAX package's main.py (config.py). Every stage
runs on the GPU; from Python, main(argv, device="cpu") runs on the CPU.
"""

from __future__ import annotations

from .config import parse_config
from .pipeline.process import DatasetProcessor


def main(argv=None, device="cuda") -> DatasetProcessor:
    """Parses `argv` (sys.argv by default) and runs the pipeline; returns
    the DatasetProcessor, which holds the run's tracer and tuner."""
    proc = DatasetProcessor(parse_config(argv), device=device)
    proc.process()
    return proc
