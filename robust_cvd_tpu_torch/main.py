"""Command-line entry point of the port (reference main.py:8-20).

    python -m robust_cvd_tpu_torch --path <clip> [flags of main.py]
    torchrun --standalone --nproc_per_node N -m robust_cvd_tpu_torch --path <clip> [...]

The flags are those of the JAX package's main.py (config.py). Every stage
runs on the GPU; from Python, main(argv, device="cpu") runs on the CPU.
Under torchrun (WORLD_SIZE > 1) main makes the data mesh
(parallel/mesh.py: a card a rank, cuda:LOCAL_RANK, over nccl), runs the
pipeline data-parallel and tears the group down at the end; a caller that
has made the mesh itself (init_mesh) keeps it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .config import parse_config
from .parallel.mesh import destroy_mesh, init_mesh, pipeline_mesh
from .pipeline.process import DatasetProcessor


def main(argv=None, device="cuda") -> DatasetProcessor:
    """Parses `argv` (sys.argv by default) and runs the pipeline; returns
    the DatasetProcessor, which holds the run's tracer and tuner. On a mesh
    of the device's type the pipeline runs on the mesh's device."""
    cfg = parse_config(argv)
    own = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized()
    if own:
        # "cuda": the rank's own card, cuda:LOCAL_RANK
        init_mesh(device=None if str(device) == "cuda" else device)
    try:
        mesh = pipeline_mesh()
        if mesh is not None and mesh.device.type == torch.device(device).type:
            device = mesh.device
        proc = DatasetProcessor(cfg, device=device)
        proc.process()
    finally:
        if own:
            destroy_mesh()
    return proc
