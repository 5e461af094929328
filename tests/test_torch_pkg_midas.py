"""MiDaS-v2 in the PyTorch port against the Flax network of the JAX package.

A small net (features=32, backbone_layers=(1, 1, 1, 1)) at 64x64 gets
Flax-initialised parameters with randomised BatchNorm statistics; the port
loads them through state_dict_from_jax. Disparity must agree within
1e-4 * max|ref| (float32 on both sides; only the convolution summation
order differs). state_dict_from_jax must invert the JAX package's
convert_midas_v2 exactly, and the full-width net must have the released
checkpoint's keys and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.models.torch_port import convert_midas_v2
from robust_cvd_tpu_torch.models import depth_model
from robust_cvd_tpu_torch.models import midas as tm


@pytest.fixture(scope="module")
def small_nets():
    rng = np.random.default_rng(0)
    fnet = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def randomize(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    params = jax.tree_util.tree_map_with_path(randomize, params)
    stats = jax.tree_util.tree_map_with_path(randomize, stats)
    params["output_conv3"]["bias"] = np.full((1,), 0.5, np.float32)
    tnet = tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1))
    tnet.load_state_dict(tm.state_dict_from_jax(params, stats), strict=True)
    return fnet, {"params": params, "batch_stats": stats}, tnet.eval()


def test_disparity_and_depth_match(small_nets):
    fnet, variables, tnet = small_nets
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(fnet.apply(variables, jm.normalize_images(jnp.asarray(x))))
    with torch.no_grad():
        got = tnet(tm.normalize_images(torch.from_numpy(x)).permute(0, 3, 1, 2)).numpy()
    assert (want > 0).mean() > 0.2, "output mostly clipped: the test would be vacuous"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    want_d = np.asarray(jm.depth_apply(fnet, variables, jnp.asarray(x)))
    with torch.no_grad():
        got_d = depth_model.depth_apply(tnet, torch.from_numpy(x)).numpy()
    live = want > 1e-3  # depth = 1/(disparity + 1e-7) explodes where clipped
    np.testing.assert_allclose(got_d[live], want_d[live], rtol=1e-3)


def test_state_dict_round_trip(small_nets):
    _, variables, tnet = small_nets
    sd = tnet.state_dict()
    params, stats = convert_midas_v2(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(stats)[0],
        jax.tree_util.tree_flatten_with_path(variables["batch_stats"])[0],
    ):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)


def test_full_width_layout_matches_checkpoint():
    from torch_layouts import make_midas_v21_state_dict

    with torch.device("meta"):
        net = tm.MidasNet()
    ours = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    golden = {k: tuple(v.shape) for k, v in make_midas_v21_state_dict().items()}
    assert ours == golden


def test_seeded_init_is_deterministic_and_positive():
    a = tm.seeded_init_(tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 3)
    b = tm.seeded_init_(tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        depth = depth_model.depth_apply(a.eval(), x)
    assert torch.isfinite(depth).all() and (depth > 0).all() and depth.max() < 10
