"""robust_cvd on PyTorch and CUDA (NVIDIA Hopper): the port of robust_cvd_tpu.

It mirrors the JAX package's module paths, imports neither jax nor
robust_cvd_tpu, and runs its entry points on the GPU unless the caller
passes device="cpu". The whole pipeline runs through its CLI,
`python -m robust_cvd_tpu_torch --path <clip>` (main.py, with the flags of
the JAX package's main.py), or `pipeline/process.py::DatasetProcessor`:
frames, MiDaS initial depth, RAFT flow with homography registration and
consistency masks, motion-segmentation dynamic masks, flow constraints,
the pose solve and test-time fine-tuning, with per-stage timings;
validation, GT-depth and COLMAP imports and recon=colmap too. The
golden-scene quality gates are in quality.py. What is not ported yet is
listed in ROADMAP.md.
"""
