"""ops/filters.py: the JAX package vs the PyTorch port on the CPU.

Seeded inputs at N = 6, 24x32 with frame_radius 2 go through both
packages' flow_guided_filter (mean, median, with and without far
connections), bilateral_filter (mean and median, with and without colour)
and clip_max_depth. Flows are a one-pixel pan plus noise within +-0.2 px,
so every tracked location rounds away from a .5 boundary and every chain
target lies off the frame's in-bounds edge (-0.5, W - 0.5) by at least
0.1 px (0.3 px after one step); the far connections are single hops from integer pixels with the
same margin (whole-pixel hops plus noise within +-0.2 px). Both filters
are the same float32 arithmetic, but the z-depth's 3-term dot product is
summed in another order, so outputs agree within a few float32 ulps of the
largest depth (tolerance 1e-6 relative to max|depth| + 1e-6); a median
that picked another sample would differ by far more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.ops import filters as jf
from robust_cvd_tpu_torch.ops import filters as tf

from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

N, H, W, R, F = 6, 24, 32, 2, 3


def _flows(rng, shape, dx):
    """A dx-pixel pan plus noise, with the chained targets kept off the
    rounding and in-bounds boundaries."""
    f = np.zeros(shape + (2,), np.float32)
    f[..., 0] = dx + rng.uniform(-0.2, 0.2, shape)
    f[..., 1] = rng.uniform(-0.2, 0.2, shape)
    return f


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    depth = rng.uniform(1.0, 3.0, (N, H, W)).astype(np.float32)
    # world points 3-5 units in front of every camera: positive z-depths
    world = rng.normal(0, 0.3, (N, H, W, 3)).astype(np.float32)
    world[..., 2] -= 4.0
    pos = rng.normal(0, 0.1, (N, 3)).astype(np.float32)
    fwd = rng.normal(0, 0.05, (N, 3)).astype(np.float32)
    fwd[:, 2] -= 1.0
    intr = np.tile(np.array([20.0, 20.0, 15.5, 11.5], np.float32), (N, 1))
    far_tgt = np.stack([(np.arange(N) + d) % N for d in (3, 4, 5)], 1).astype(np.int32)
    far = dict(
        # whole-pixel hops plus noise within +-0.2 px
        far_flows=(rng.integers(-6, 7, (N, F, H, W, 2))
                   + rng.uniform(-0.2, 0.2, (N, F, H, W, 2))).astype(np.float32),
        far_masks=rng.uniform(0, 1, (N, F, H, W)) > 0.2,
        far_tgt=far_tgt,
        far_valid=rng.uniform(0, 1, (N, F)) > 0.3,
    )
    return dict(
        depth=depth, world=world, cams=(pos, fwd, intr),
        flows=(_flows(rng, (N, H, W), 1.0), rng.uniform(0, 1, (N, H, W)) > 0.2,
               _flows(rng, (N, H, W), -1.0), rng.uniform(0, 1, (N, H, W)) > 0.2),
        far=far, color=rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32),
    )


def _tol(ref):
    return 1e-6 * float(np.abs(ref).max()) + 1e-6


@pytest.mark.parametrize("median", [False, True], ids=["mean", "median"])
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
def test_flow_guided_filter(inputs, median, far):
    kw = inputs["far"] if far else {}
    j = np.asarray(jf.flow_guided_filter(
        jnp.asarray(inputs["depth"]), jnp.asarray(inputs["world"]),
        jf.FilterCameras(*map(jnp.asarray, inputs["cams"])),
        *map(jnp.asarray, inputs["flows"]), frame_radius=R, median=median,
        **{k: jnp.asarray(v) for k, v in kw.items()},
    ))
    t = tf.flow_guided_filter(
        torch.from_numpy(inputs["depth"]), torch.from_numpy(inputs["world"]),
        tf.FilterCameras(*map(torch.from_numpy, inputs["cams"])),
        *map(torch.from_numpy, inputs["flows"]), frame_radius=R, median=median,
        **{k: torch.from_numpy(v) for k, v in kw.items()},
    ).numpy()
    assert t.shape == (N, H, W) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=_tol(j))


@pytest.mark.parametrize("median", [False, True], ids=["mean", "median"])
@pytest.mark.parametrize("color", [False, True], ids=["depth", "color"])
def test_bilateral_filter(inputs, median, color):
    col = inputs["color"] if color else None
    j = np.asarray(jf.bilateral_filter(
        jnp.asarray(inputs["depth"]), 2, 1, 0.3,
        None if col is None else jnp.asarray(col), 0.2, median,
    ))
    t = tf.bilateral_filter(
        torch.from_numpy(inputs["depth"]), 2, 1, 0.3,
        None if col is None else torch.from_numpy(col), 0.2, median,
    ).numpy()
    assert t.shape == (N, H, W) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=_tol(j))


def test_clip_max_depth(inputs):
    d = inputs["depth"]
    j = np.asarray(jf.clip_max_depth(jnp.asarray(d), 2.0))
    t = tf.clip_max_depth(torch.from_numpy(d), 2.0).numpy()
    np.testing.assert_array_equal(t, j)
    assert t.max() == 2.0
