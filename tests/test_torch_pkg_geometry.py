"""ops/geometry.py of the PyTorch port against robust_cvd_tpu/ops/geometry.py.

Random inputs from a numpy seed go through both packages on the CPU.
Every ported function agrees within rtol 1e-5 (float32 on both sides; the
JAX einsums run at HIGHEST precision, the port's rotations are broadcast
multiply-adds). `grid_sample`'s forward and its data-gradient agree with
geometry.grid_sample and with the VJP of grid_sample_matmul (the sampler
the JAX loss stack uses on the CPU) within atol 1e-5, with samples inside,
on and past every border.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.ops import geometry as jg
from robust_cvd_tpu_torch.ops import geometry as tg

RTOL = 1e-5


def _rot(rng, n):
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q.astype(np.float32)


def _ext(rng, n):
    return np.concatenate(
        [_rot(rng, n), rng.normal(0, 1, (n, 3, 1)).astype(np.float32)], -1
    )


def _intr(rng, n, h, w):
    f = rng.uniform(20, 40, (n, 2))
    c = np.stack([rng.uniform(0.4, 0.6, n) * w, rng.uniform(0.4, 0.6, n) * h], -1)
    return np.concatenate([f, c], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_pixel_grid_and_intrinsics():
    rng = np.random.default_rng(0)
    _close(tg.pixel_grid((5, 7)).numpy(), jg.pixel_grid((5, 7)))
    vfov = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    hfov = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    _close(tg.intrinsics_px(_t(vfov), _t(hfov), (16, 24)),
           jg.intrinsics_px(jnp.asarray(vfov), jnp.asarray(hfov), (16, 24)))


def test_projection_family():
    rng = np.random.default_rng(1)
    b, h, w = 3, 6, 8
    intr = _intr(rng, b, h, w)
    ext, ext2 = _ext(rng, b), _ext(rng, b)
    depth = rng.uniform(1, 4, (b, h, w)).astype(np.float32)
    pix = rng.uniform(-2, 10, (b, h, w, 2)).astype(np.float32)
    pts = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    pts[..., 2] = -rng.uniform(1, 3, (b, h, w))

    _close(tg.pixels_to_rays(_t(pix), _t(intr)[:, None, None]),
           jg.pixels_to_rays(pix, intr[:, None, None]))
    _close(tg.project(_t(pts), _t(intr)[:, None, None]),
           jg.project(pts, intr[:, None, None]))
    _close(tg.pixels_to_points(_t(intr)[:, None, None], _t(depth), _t(pix)),
           jg.pixels_to_points(intr[:, None, None], depth, pix))
    e, e2 = _t(ext)[:, None, None], _t(ext2)[:, None, None]
    # world coordinates can cross zero, so the relative check gets an
    # absolute floor at float32 rounding of O(1) values
    _close(tg.points_cam_to_world(_t(pts), e),
           jg.points_cam_to_world(pts, ext[:, None, None]), atol=1e-6)
    _close(tg.world_to_points_cam(_t(pts), e),
           jg.world_to_points_cam(pts, ext[:, None, None]), atol=1e-6)
    _close(tg.reproject_points(_t(pts), e, e2),
           jg.reproject_points(pts, ext[:, None, None], ext2[:, None, None]), atol=1e-6)
    _close(tg.depth_to_points(_t(depth), _t(intr)), jg.depth_to_points(depth, intr))
    # a nearby target camera, so that no reprojected point grazes z = 0;
    # pixel coordinates near 0 get an absolute floor of 1e-5 px
    near = ext.copy()
    near[..., 3] += rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    _close(tg.warping_field(_t(ext), _t(intr), _t(depth), _t(near), _t(intr)),
           jg.warping_field(ext, intr, depth, near, intr), atol=1e-5)


@pytest.mark.parametrize("c", [1, 3])
def test_grid_sample_forward_and_data_gradient(c):
    rng = np.random.default_rng(2 + c)
    h, w = 7, 9
    data = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    uv = np.stack([rng.uniform(-3, w + 2, (5, 6)), rng.uniform(-3, h + 2, (5, 6))], -1)
    # exact borders, pixel centres and the last cell
    uv[0, :4] = [[0, 0], [w - 1, h - 1], [w - 1, 0], [0, h - 1]]
    uv[1, :2] = [[3, 2], [w - 1.5, h - 1.5]]
    uv = uv.astype(np.float32)
    ct = rng.normal(0, 1, (5, 6, c)).astype(np.float32)

    want = jg.grid_sample(jnp.asarray(data), jnp.asarray(uv))
    got = tg.grid_sample(_t(data), _t(uv))
    _close(got.numpy(), want, rtol=0, atol=1e-5)

    _, pull = jax.vjp(lambda d: jg.grid_sample_matmul(d, jnp.asarray(uv)), jnp.asarray(data))
    (want_g,) = pull(jnp.asarray(ct))
    _, pull_ref = jax.vjp(lambda d: jg.grid_sample(d, jnp.asarray(uv)), jnp.asarray(data))
    td = _t(data).requires_grad_(True)
    tg.grid_sample(td, _t(uv)).backward(_t(ct))
    _close(td.grad.numpy(), want_g, rtol=0, atol=1e-5)
    _close(td.grad.numpy(), pull_ref(jnp.asarray(ct))[0], rtol=0, atol=1e-5)


def test_grid_sample_batched_matches_vmap():
    rng = np.random.default_rng(7)
    b, h, w = 3, 5, 6
    data = rng.normal(0, 1, (b, h, w, 2)).astype(np.float32)
    uv = np.stack([rng.uniform(-1, w, (b, h, w)), rng.uniform(-1, h, (b, h, w))], -1)
    uv = uv.astype(np.float32)
    want = jax.vmap(jg.grid_sample)(jnp.asarray(data), jnp.asarray(uv))
    _close(tg.grid_sample(_t(data), _t(uv)).numpy(), want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tg.grid_sample(_t(data), _t(uv)[:2])
