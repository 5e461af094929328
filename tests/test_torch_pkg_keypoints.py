"""The JAX package's last unported public functions, JAX vs PyTorch port on
the CPU: ops/homography.py's detect_keypoints, patch_descriptors,
match_ratio and warp_perspective, and solver/xforms.py's init_depth_grid
and apply_depth_grid.

Seeded inputs: a smoothed random texture (64x96) and the same texture
moved by a small homography. Held: the keypoints equal (the same stable
strongest-first order after the greedy disk separation); the descriptors
within 1e-6; the matches equal; the warp within 1e-5 of max|ref|; the depth
grids equal exactly, initial and applied (linear and depth-wise), the
cubic grid applied within 1e-6 relative (XLA's fused weight polynomials).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.ops import homography as jh
from robust_cvd_tpu.solver import xforms as jx
from robust_cvd_tpu_torch.ops import homography as th
from robust_cvd_tpu_torch.solver import xforms as tx

H, W = 64, 96
HOMOGRAPHY = np.array([[1.02, 0.01, -1.5], [-0.015, 0.99, 2.0], [1e-4, -5e-5, 1.0]],
                      np.float32)


def _texture(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (H + 4, W + 4, 3)).astype(np.float32)
    x = sum(x[dy : dy + H, dx : dx + W] for dy in range(3) for dx in range(3)) / 9.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    a = _texture()
    b = np.asarray(jh.warp_perspective(jnp.asarray(a), HOMOGRAPHY))
    return a, b


def test_detect_keypoints(frames):
    for img in frames:
        gray = img.mean(-1)
        want = jh.detect_keypoints(gray, max_keypoints=200)
        got = th.detect_keypoints(gray, max_keypoints=200)
        assert len(want) > 20
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(th.detect_keypoints(torch.from_numpy(gray),
                                                          max_keypoints=200), want)


def test_descriptors_and_matches(frames):
    grays = [img.mean(-1) for img in frames]
    kps = [jh.detect_keypoints(g, max_keypoints=200) for g in grays]
    desc_j = [jh.patch_descriptors(g, k) for g, k in zip(grays, kps)]
    desc_t = [th.patch_descriptors(g, k) for g, k in zip(grays, kps)]
    for d_t, d_j in zip(desc_t, desc_j):
        assert d_t.shape == d_j.shape == (len(d_j), 225)
        np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    want = jh.match_ratio(*desc_j)
    got = th.match_ratio(*desc_t)
    assert len(want) > 10
    np.testing.assert_array_equal(got, want)
    assert th.match_ratio(desc_t[0][:1], desc_t[1]).shape == (0, 2)


def test_warp_perspective(frames):
    a = frames[0]
    for out_hw in (None, (48, 80)):
        want = np.asarray(jh.warp_perspective(jnp.asarray(a), HOMOGRAPHY, out_hw))
        got = th.warp_perspective(a, HOMOGRAPHY, out_hw).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spec", [
    dict(gx=4, gy=3), dict(gx=4, gy=3, cubic=True),
    dict(gx=3, gy=2, gz=3, disp_min=0.2, disp_max=1.5),
])
def test_depth_grid(spec):
    rng = np.random.default_rng(1)
    jspec, tspec = jx.GridSpec(**spec), tx.GridSpec(**spec)
    init = tx.init_depth_grid(5, tspec)
    np.testing.assert_array_equal(init.numpy(), np.asarray(jx.init_depth_grid(5, jspec)))
    assert init.dtype == torch.float32
    grid = rng.uniform(0.5, 1.5, (tspec.gz, tspec.gy, tspec.gx)).astype(np.float32)
    depth = rng.uniform(0.7, 4.0, (24, 40)).astype(np.float32)
    want = np.asarray(jx.apply_depth_grid(jnp.asarray(grid), jspec, jnp.asarray(depth)))
    got = tx.apply_depth_grid(torch.from_numpy(grid), tspec, torch.from_numpy(depth))
    if tspec.cubic:
        # XLA evaluates the Catmull-Rom weight polynomials in its own order
        # (fused multiply-adds): a few float32 ulps
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
