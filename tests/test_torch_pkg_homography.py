"""Homography registration in the PyTorch port against the JAX package.

Same frames (numpy seeds), float32 on the CPU on both sides, the corner
response through each package's plain version. The pieces agree exactly
where the arithmetic is the same (keypoint order with ties, the hypothesis
table) and within 1e-5 relative otherwise; H and the registered frame
within 1e-3 (the refit sums a 9x9 eigensystem of ~1000 points in another
order; measured ~5e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.ops import homography as jh
from robust_cvd_tpu_torch.ops import homography as th

H_TOL = 1e-3


def textured(h, w, extra, seed):
    """A 3x3-box-blurred noise texture, wide enough to crop shifted frames."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0, 1, (h + 2, w + extra + 2, 3)).astype(np.float32)
    return sum(noise[dy:dy + h, dx:dx + w + extra]
               for dy in range(3) for dx in range(3)) / 9.0


@pytest.fixture(scope="module")
def pairs():
    """(im1, im2) stacks: a 6 px translation, an unrelated random pair and
    a 3 px translation the other way; JAX's and the port's registration."""
    h, w = 96, 128
    tex = textured(h, w, 16, 0)
    other = np.random.default_rng(1).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    im1 = np.stack([tex[:, :w], other[0], tex[:, 3:3 + w]])
    im2 = np.stack([tex[:, 6:6 + w], other[1], tex[:, :w]])
    Hj, rj = jh.register_pairs(im1, im2)
    Ht, rt = th.register_pairs(im1, im2)
    return im1, im2, (np.asarray(Hj), np.asarray(rj)), (Ht.numpy(), rt.numpy())


def test_register_pairs_matches_jax(pairs):
    _, _, (Hj, rj), (Ht, rt) = pairs
    np.testing.assert_allclose(Ht, Hj, atol=H_TOL)
    np.testing.assert_allclose(rt, rj, atol=H_TOL)


def test_known_translation_recovered(pairs):
    im1, _, _, (Ht, rt) = pairs
    want = np.eye(3, dtype=np.float32)
    want[0, 2] = 6.0
    np.testing.assert_allclose(Ht[0], want, atol=H_TOL)
    want[0, 2] = -3.0
    np.testing.assert_allclose(Ht[2], want, atol=H_TOL)
    # frame 2 registered into frame 1's frame is frame 1, but for the 6
    # columns on the left that frame 2 does not see (the clamp fills them)
    np.testing.assert_allclose(rt[0][:, 7:], im1[0][:, 7:], atol=1e-3)


def test_degenerate_frames_give_identity():
    flat = np.full((2, 64, 80, 3), 0.5, np.float32)
    Ht, rt = th.register_pairs(flat, flat)
    np.testing.assert_array_equal(Ht.numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)))
    np.testing.assert_array_equal(rt.numpy(), flat)
    H1, r1 = th.register_pair(flat[0], flat[1])
    assert isinstance(H1, np.ndarray) and np.array_equal(H1, np.eye(3))


def test_singular_hypothesis_raises_nothing():
    """Coincident and collinear quadruples (singular 8x8 systems) give a
    non-finite H, no exception, and score no inliers."""
    pts = torch.tensor([[[3.0, 4.0]] * 4,
                        [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]])
    Hs = th._dlt4(pts, pts + 1.0)
    assert not torch.isfinite(Hs).all(-1).all(-1).any()
    proj = th._apply_h(Hs, pts)
    assert not (torch.sqrt(((proj - pts) ** 2).sum(-1)) < 4.0).any()
    good = torch.tensor([[[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 12.0]]])
    np.testing.assert_allclose(th._dlt4(good, good + 2.0)[0].numpy(),
                               [[1, 0, 2], [0, 1, 2], [0, 0, 1]], atol=1e-5)


def test_topk_ties_in_index_order():
    """Equal responses (the plateau of zeros after suppression, and equal
    peaks) come out lower index first, as jax.lax.top_k's; so do equal
    similarities in the 2-NN match."""
    rng = np.random.default_rng(2)
    resp = np.zeros((2, 40, 50), np.float32)
    resp[:, 10:30:4, 10:40:5] = rng.choice([1.0, 2.0], (2, 5, 6))  # many equal peaks
    jx, jy, jv = jh._nms_topk(jnp.asarray(resp), 64)
    tx, ty, tv = th._nms_topk(torch.from_numpy(resp), 64)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    sim = rng.choice([0.1, 0.5, 0.9], (3, 7, 11)).astype(np.float32)
    import jax

    jvals, jidx = jax.lax.top_k(jnp.asarray(sim), 2)
    tvals, tidx = th._topk_stable(torch.from_numpy(sim), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


def test_nms_and_descriptors_match_jax():
    from robust_cvd_tpu.solver.constraints import corner_min_eigenval
    from robust_cvd_tpu_torch.ops.corner import corner_min_eigenval_plain

    gray = textured(64, 80, 0, 3)[..., 0][None].repeat(2, 0)
    gray[1] = gray[1, :, ::-1]
    rj = np.asarray(corner_min_eigenval(jnp.asarray(gray)))
    rt = corner_min_eigenval_plain(torch.from_numpy(gray.copy()))
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-5 * np.abs(rj).max())
    jx, jy, jv = jh._nms_topk(jnp.asarray(rj), 256)
    tx, ty, tv = th._nms_topk(torch.tensor(rj), 256)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tv.sum() > 50
    dj = np.asarray(jh._patch_descriptors_b(jnp.asarray(gray), jx, jy))
    dt = th._patch_descriptors_b(torch.from_numpy(gray.copy()), tx, ty).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-5)


def test_dlt_pieces_match_jax():
    rng = np.random.default_rng(4)
    Htrue = np.array([[1.02, 0.03, 4.0], [-0.01, 0.97, -2.0], [1e-4, -2e-4, 1.0]])
    a = rng.uniform(0, 100, (3, 40, 2))
    ph = np.concatenate([a, np.ones_like(a[..., :1])], -1) @ Htrue.T
    b = (ph[..., :2] / ph[..., 2:] + rng.normal(0, 0.3, a.shape)).astype(np.float32)
    a = a.astype(np.float32)
    w = (rng.uniform(0, 1, (3, 40)) > 0.2).astype(np.float32)
    want = np.asarray(jh._dlt_weighted(jnp.asarray(a), jnp.asarray(b), jnp.asarray(w)))
    got = th._dlt_weighted(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    want4 = np.asarray(jh._dlt4(jnp.asarray(a[:, :4]), jnp.asarray(b[:, :4])))
    got4 = th._dlt4(torch.from_numpy(a[:, :4]), torch.from_numpy(b[:, :4]))
    np.testing.assert_allclose(got4.numpy(), want4, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        th._apply_h(got, torch.from_numpy(a)).numpy(),
        np.asarray(jh._apply_h_j(jnp.asarray(want), jnp.asarray(a))), rtol=1e-5, atol=1e-4)


def test_hypothesis_table_identical():
    for k in (1024, 50):
        np.testing.assert_array_equal(th._hypothesis_table(k), jh._hypothesis_table(k))


def test_unwarp_flow_matches_jax():
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 3, (12, 16, 2)).astype(np.float32)
    H = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -1.0], [1e-4, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(th.unwarp_flow(flow, H), jh.unwarp_flow(flow, H), atol=1e-4)
