"""Initial depth stage: batched depth-model inference over the whole clip.

Port of robust_cvd_tpu/pipeline/depth.py (reference process.py:115-124 +
depth_fine_tuning.py save_depth, 227-294). Writes
`depth_{model}/depth/frame_%06d.raw` (disparity-encoded).

Precision on the card: float32 weights and activations, cuDNN
convolutions in TF32, matrix products as the adapter's `precision` says
(models/depth_model.py), set explicitly for the stage.

On a data mesh (parallel/mesh.py) each rank infers its shard of the frames
(padded with copies of frame 0, as the JAX package pads), every rank gets
the whole clip's depth, and rank 0 saves the stream.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..io.store import VideoStore
from ..models.depth_model import depth_apply
from ..parallel import mesh as pmesh


def compute_initial_depth(
    store: VideoStore, adapter, model_type: str, batch: int = 16,
    stats: dict | None = None, device="cuda",
) -> np.ndarray:
    """The adapter's depth (N, h, w) of every `color_down` frame, saved as the
    `depth_{model_type}` stream; an existing full stream is loaded instead.
    Chunks of `batch` frames; the last chunk is padded by repeating its
    final frame, so the net sees the same batches as in the JAX package."""
    stream = f"depth_{model_type}"
    out_dir = store.depth_dir(stream)
    mesh = pmesh.pipeline_mesh()
    done = os.path.isdir(out_dir) and len(os.listdir(out_dir)) >= store.num_frames
    pmesh.barrier(mesh)  # every rank has looked before rank 0 writes
    if done:
        return store.load_depth_stream(stream)

    device = resolve_device(device)
    if stats is None:
        stats = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    net = adapter.net.to(device).eval()
    sync()
    stats["weights_h2d_s"] = time.perf_counter() - t0

    images = store.load_color_down()
    if mesh is not None:
        images = images[mesh.shard(images.shape[0])]
    n = images.shape[0]
    outs = []
    with torch.no_grad(), adapter.precision(True):
        for s in range(0, n, batch):
            t0 = time.perf_counter()
            chunk = images[s : s + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            d = depth_apply(net, torch.from_numpy(chunk).to(device))
            outs.append(d[: batch - pad].cpu().numpy())
            # the first chunk carries cuDNN's algorithm selection; the rest
            # is steady-state inference
            key = "first_dispatch_s" if s == 0 else "steady_infer_s"
            stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0
    depth = np.concatenate(outs, 0)
    if mesh is not None:
        depth = mesh.all_gather_leading(torch.from_numpy(depth), store.num_frames).numpy()
    t0 = time.perf_counter()
    if pmesh.is_writer(mesh):
        store.save_depth_stream(stream, depth)
    pmesh.barrier(mesh)
    stats["save_io_s"] = time.perf_counter() - t0
    return depth
