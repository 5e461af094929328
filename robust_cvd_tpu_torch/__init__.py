"""robust_cvd on PyTorch and CUDA (NVIDIA Hopper): the port of robust_cvd_tpu.

It mirrors the JAX package's module paths, imports neither jax nor
robust_cvd_tpu, and runs its entry points on the GPU unless the caller
passes device="cpu". Ported so far: the pose stage (pipeline/depth.py,
pipeline/pose.py and what they use); see ROADMAP.md for the rest.
"""
