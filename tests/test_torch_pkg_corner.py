"""The corner response of the PyTorch port against the JAX package.

The port's plain version (the CPU path of ops/corner.py) must match both
robust_cvd_tpu/solver/constraints.py::corner_min_eigenval and the Pallas
kernel robust_cvd_tpu/ops/pallas_kernels.py::corner_min_eigenval_fused in
interpret mode, at atol 1e-4 (tests/test_pallas_kernels.py's tolerance).
The Hopper kernel itself runs only on a card: its test is marked `cuda`
and skips without one (chip_smoke.py runs the same shapes on the card).

The shapes cover every ragged path of the kernel (a warp walks a band of
128 columns down a strip of 32 rows): W % 4 in {1, 2, 3} (the scalar
path), H not a multiple of the strip, W narrower than one band, a partial
last band on the float4 path, and H = W = 2. Every shape also goes in as a
non-contiguous view (the transpose of an (N, W, H) array).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.ops.pallas_kernels import corner_min_eigenval_fused
from robust_cvd_tpu.solver.constraints import corner_min_eigenval as jnp_corner
from robust_cvd_tpu_torch.ops import corner

SHAPES = [(2, 24, 128), (3, 17, 33), (2, 40, 129), (1, 37, 130), (3, 64, 131),
          (2, 64, 200), (3, 2, 2)]


def _gray(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _transposed_view(gray: np.ndarray) -> torch.Tensor:
    """The same values as a non-contiguous tensor."""
    return torch.from_numpy(np.ascontiguousarray(gray.transpose(0, 2, 1))).transpose(1, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax(shape):
    gray = _gray(shape)
    got = corner.corner_min_eigenval_plain(torch.from_numpy(gray)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp_corner(jnp.asarray(gray))), atol=1e-4)
    fused = corner_min_eigenval_fused(jnp.asarray(gray), interpret=True)
    np.testing.assert_allclose(got, np.asarray(fused), atol=1e-4)
    view = corner.corner_min_eigenval_plain(_transposed_view(gray)).numpy()
    np.testing.assert_allclose(view, got, atol=1e-4)


def test_cpu_tensor_takes_the_plain_version():
    gray = torch.from_numpy(_gray((2, 9, 11), seed=1))
    before = corner.corner_min_eigenval.launches
    out = corner.corner_min_eigenval(gray)
    assert torch.equal(out, corner.corner_min_eigenval_plain(gray))
    assert corner.corner_min_eigenval.launches == before
    with pytest.raises(ValueError):
        corner.corner_min_eigenval(gray.double())
    with pytest.raises(ValueError):
        corner.corner_min_eigenval(gray[:, :1])


# On the card also the path's shape, N = 0 (no launch) and N = 70,000
# frames, more than gridDim.z could hold: the kernel folds frames into
# blockIdx.x.
@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", SHAPES + [(100, 224, 384), (1, 2, 2), (0, 24, 128), (70_000, 3, 5)])
def test_kernel_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    gray = _gray(shape, seed=2)
    for inp in (torch.from_numpy(gray).cuda(), _transposed_view(gray).cuda()):
        before = corner.corner_min_eigenval.launches
        got = corner.corner_min_eigenval(inp)
        torch.cuda.synchronize()
        assert corner.corner_min_eigenval.launches == before + (shape[0] > 0)
        assert got.shape == inp.shape
        ref = corner.corner_min_eigenval_plain(inp)
        if ref.numel():
            tol = 1e-4 * ref.abs().max().item() + 1e-5
            assert (got - ref).abs().max().item() <= tol
