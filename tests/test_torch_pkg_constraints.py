"""Flow-constraint construction of the PyTorch port against the JAX package.

Both packages get the SAME corner array: the greedy picks follow a stable
sort on corner strength, so last-bit differences between two corner maps
could legitimately reorder near-ties. With equal inputs the outputs must be
exactly equal: pair and triplet constraints, static flags from dynamic
masks, and the flattened solver tensors.
"""

import numpy as np
import pytest

from robust_cvd_tpu.solver import constraints as jc
from robust_cvd_tpu_torch.solver import constraints as tc

H, W, N = 40, 72, 4


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    corner = rng.gamma(2.0, 1.0, (N, H, W)).astype(np.float32)
    corner[:, ::7, ::5] = 3.0  # exact ties between candidates
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)

    def flow(seed):
        r = np.random.default_rng(seed)
        f = np.stack([
            r.uniform(-6, 6) + 2.0 * np.sin(xx / 9.0 + r.uniform(0, 3)),
            r.uniform(-4, 4) + 1.5 * np.cos(yy / 7.0),
        ], -1).astype(np.float32)
        f[r.uniform(0, 1, (H, W)) < 0.01] = np.nan  # non-finite flow is skipped
        return f

    pair_keys = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (0, 2), (3, 1)]
    flows = {k: flow(10 * k[0] + k[1]) for k in pair_keys}
    masks = {k: rng.uniform(0, 1, (H, W)) < 0.7 for k in pair_keys}
    dyn = np.full((N, H, W), 255, np.uint8)
    dyn[:, 10:20, 30:45] = 0  # a dynamic object
    depth = rng.uniform(0.5, 4.0, (N, H, W)).astype(np.float32)
    depth[1, :3, :3] = 0.0  # invalid depth -> weight 0
    return corner, flows, masks, pair_keys, dyn, depth


def _build(mod, scene):
    corner, flows, masks, pair_keys, dyn, _ = scene
    inv_aspect = H / W
    pairs = {
        (i, j): mod.build_pair_constraints(corner[i], flows[(i, j)], masks[(i, j)], inv_aspect)
        for (i, j) in pair_keys
    }
    trip_keys = [1, 2]
    trips = {
        t: mod.build_triplet_constraints(
            corner[t], flows[(t, t - 1)], masks[(t, t - 1)],
            flows[(t, t + 1)], masks[(t, t + 1)], inv_aspect,
        )
        for t in trip_keys
    }
    dist = np.stack([mod.dynamic_distance(m, m.shape) for m in dyn])
    mod.set_static_flags(pair_keys, pairs, trip_keys, trips, dist, 8.0)
    return pairs, trips, trip_keys


def test_pair_and_triplet_constraints_equal(scene):
    jp, jt, keys = _build(jc, scene)
    tp, tt, _ = _build(tc, scene)
    assert sum(len(p.loc0) for p in tp.values()) > 100
    assert any((~p.is_static).any() for p in tp.values())
    for k in jp:
        for a, b in zip(tp[k], jp[k]):
            np.testing.assert_array_equal(a, b)
    for t in keys:
        for a, b in zip(tt[t], jt[t]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tc.rgb_to_gray(scene[4][..., None].repeat(3, -1) / 255.0),
        jc.rgb_to_gray(scene[4][..., None].repeat(3, -1) / 255.0),
    )
    assert np.array_equal(
        tc.dynamic_distance(None, (3, 4)), jc.dynamic_distance(None, (3, 4))
    )


def test_flatten_equal(scene):
    depth, pair_keys = scene[5], scene[3]
    jp, jt, keys = _build(jc, scene)
    tp, tt, _ = _build(tc, scene)
    jd = jc.flatten_pairs(pair_keys, jp, depth, H / W)
    td = tc.flatten_pairs(pair_keys, tp, depth, H / W)
    for name, a, b in zip(jd._fields, td, jd):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    jtr = jc.flatten_triplets(keys, jt, depth, H / W, 1.0, 0.5)
    ttr = tc.flatten_triplets(keys, tt, depth, H / W, 1.0, 0.5)
    for name, a, b in zip(jtr._fields, ttr, jtr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert tc.flatten_triplets([], tt, depth, H / W, 1.0, 0.5) is None
    with pytest.raises(RuntimeError, match="no usable flow constraints"):
        tc.flatten_pairs([], tp, depth, H / W)
