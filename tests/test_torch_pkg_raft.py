"""RAFT in the PyTorch port against the Flax RAFT of the JAX package.

Every comparison runs float32 on both sides with inputs made from numpy
seeds; only summation order and the lookup's weight arithmetic differ
(the port interpolates a gathered patch, the JAX package multiplies hat
selectors), so pieces agree within 1e-5 relative to their largest value
and the whole net (3 iterations) within 1e-4 of the largest flow. Weights
cross both ways: state_dict_from_jax from a Flax init, and the upstream
checkpoint layout (tests/torch_layouts.py) through the JAX package's
convert_raft against the port's load_checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robust_cvd_tpu.models import raft as jr
from robust_cvd_tpu.models import raft_eval as je
from robust_cvd_tpu.models.torch_port import convert_raft
from robust_cvd_tpu_torch.device import float32_precision
from robust_cvd_tpu_torch.models import raft as tr
from robust_cvd_tpu_torch.models import raft_eval as te

NET_TOL = 1e-4  # of max|flow|, 3 iterations, float32


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _pyramids(h, w, d=16, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(0, 1, (2, h, w, d)).astype(np.float32)
    f2 = rng.normal(0, 1, (2, h, w, d)).astype(np.float32)
    return jr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)), \
        tr.build_corr_pyramid(nchw(f1), nchw(f2))


@pytest.mark.parametrize("hw", [(6, 8), (8, 12), (5, 7)])
def test_corr_pyramid_matches_jax(hw):
    jp, tp = _pyramids(*hw)
    levels = []
    for a, b in zip(jp, tp):
        a = np.asarray(a)
        assert b.shape == (a.shape[0], a.shape[1] * a.shape[2]) + a.shape[3:]
        levels.append(a.shape[3:])
        if a.size:
            np.testing.assert_allclose(b.numpy(), a.reshape(b.shape),
                                       atol=1e-5 * np.abs(a).max())
    if hw == (6, 8):  # floor semantics down to an empty level
        assert levels == [(6, 8), (3, 4), (1, 2), (0, 1)]


@pytest.mark.parametrize("hw", [(6, 8), (8, 12)])
def test_lookup_corr_matches_jax(hw):
    """Coordinates well outside the map on every side, and at 6x8 an empty
    last level (its 81 channels are zeros)."""
    jp, tp = _pyramids(*hw)
    rng = np.random.default_rng(1)
    coords = rng.uniform(-7, max(hw) + 7, (2,) + hw + (2,)).astype(np.float32)
    coords[0, 0, 0] = (-40.0, 55.0)
    want = np.asarray(jr.lookup_corr(jp, jnp.asarray(coords), dtype=jnp.float32))
    got = nhwc(tr.lookup_corr(tp, nchw(coords), dtype=torch.float32))
    assert got.shape == want.shape == (2,) + hw + (4 * 81,)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    if hw == (6, 8):
        assert not got[..., 243:].any()


def test_lookup_channel_order_is_x_offset_major():
    """A volume that is 1 at one position of image 2: the query whose
    window holds it sees the 1 in channel a*K + b with (dx, dy) =
    (a - r, b - r)."""
    h, w, r = 7, 9, 4
    K = 2 * r + 1
    corr = torch.zeros(1, h * w, h, w)
    corr[:, :, 5, 2] = 1.0  # y = 5, x = 2 for every query
    coords = torch.zeros(1, 2, h, w)
    coords[0, 0], coords[0, 1] = 4.0, 3.0  # every query looks around (4, 3)
    out = tr.lookup_corr([corr], coords, radius=r, dtype=torch.float32)[0, :, 0, 0]
    a, b = 2 - 4 + r, 5 - 3 + r  # dx = -2, dy = +2
    assert out[a * K + b] == 1.0 and out.sum() == 1.0


def test_lookup_corr_equals_upstream_grid_sample():
    """The upstream formulation (reference corr.py:26-47): grid_sample with
    align_corners=True and zero padding over the window's meshgrid, the
    first meshgrid output added to x."""
    _, tp = _pyramids(16, 24)  # every level at least 2x2, as grid_sample needs
    rng = np.random.default_rng(2)
    coords = torch.from_numpy(rng.uniform(-6, 30, (2, 2, 16, 24)).astype(np.float32))
    got = tr.lookup_corr(tp, coords, dtype=torch.float32)
    r = 4
    d = torch.linspace(-r, r, 2 * r + 1)
    delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1)  # (K, K, 2)
    out = []
    B, _, H, W = coords.shape
    for i, corr in enumerate(tp):
        h2, w2 = corr.shape[-2:]
        c = coords.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2) / 2 ** i
        xy = c + delta.reshape(1, 2 * r + 1, 2 * r + 1, 2)
        grid = torch.stack([2 * xy[..., 0] / (w2 - 1) - 1, 2 * xy[..., 1] / (h2 - 1) - 1], -1)
        s = F.grid_sample(corr.reshape(B * H * W, 1, h2, w2), grid, align_corners=True)
        out.append(s.reshape(B, H, W, -1))
    want = torch.cat(out, -1).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 2, (2, 3, 5, 2)).astype(np.float32)
    mask = rng.normal(0, 1, (2, 3, 5, 576)).astype(np.float32)
    want = np.asarray(jr.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))
    got = nhwc(tr.upsample_flow_convex(nchw(flow), nchw(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_instance_norm_matches_jax():
    x = np.random.default_rng(4).normal(3, 2, (2, 6, 7, 5)).astype(np.float32)
    want = np.asarray(jr.instance_norm(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(tr.instance_norm(nchw(x))), want, atol=1e-5)


def _randomize_stats(tree, rng):
    def f(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.mark.parametrize("enc", ["fnet", "cnet"])
def test_encoders_match_jax(jax_raft, enc):
    """fnet (instance norm) and cnet (BatchNorm with randomised running
    statistics) alone."""
    _, v, net = jax_raft
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jenc = jr.BasicEncoder(256, "instance" if enc == "fnet" else "batch", dtype=jnp.float32)
    variables = {"params": v["params"][enc]}
    if enc == "cnet":
        variables["batch_stats"] = v["batch_stats"]["cnet"]
    want = np.asarray(jenc.apply(variables, jnp.asarray(x)))
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        got = nhwc(getattr(net, enc)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_raft():
    """A Flax RAFT(float32, 3 iterations) with randomised BatchNorm
    statistics, its variables, and the port's RAFT carrying them."""
    rng = np.random.default_rng(6)
    m = jr.RAFT(iters=3, dtype=jnp.float32)
    z = jnp.zeros((1, 64, 96, 3))
    v = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(0), z, z))
    v = {k: _randomize_stats(t, rng) for k, t in v.items()}
    net = tr.RAFT(iters=3, dtype=torch.float32)
    net.load_state_dict(tr.state_dict_from_jax(v["params"], v["batch_stats"]), strict=True)
    return m, v, net.eval()


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("hw", [(64, 96), (48, 64)])
def test_raft_matches_jax(jax_raft, hw):
    m, v, net = jax_raft
    im1, im2 = _images(*hw, seed=7)
    want = np.asarray(jax.jit(m.apply)(v, jnp.asarray(im1), jnp.asarray(im2)))
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        got = nhwc(net(nchw(im1), nchw(im2)))
    assert got.shape == want.shape == (2,) + hw + (2,)
    assert np.abs(want).max() > 0.5, "flows near zero: the test would be vacuous"
    np.testing.assert_allclose(got, want, atol=NET_TOL * np.abs(want).max())


def test_state_dict_round_trip(jax_raft):
    _, v, net = jax_raft
    params, stats = convert_raft(net.state_dict())
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        fa = jax.tree_util.tree_flatten_with_path(got)[0]
        fb = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (_, a), (_, b) in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_layout_loads_and_matches_jax(tmp_path):
    """The upstream raft-things layout (179 tensors, module. prefixes as a
    DataParallel checkpoint has them): the port loads it strictly and
    agrees with the JAX package's convert_raft of the same file."""
    from torch_layouts import make_raft_things_state_dict

    sd = make_raft_things_state_dict(seed=1)
    path = str(tmp_path / "raft-things.pth")
    torch.save({"module." + k: t for k, t in sd.items()}, path)
    net = tr.RAFT(iters=3, dtype=torch.float32)
    net.load_state_dict(tr.load_checkpoint(path), strict=True)
    assert len(net.state_dict()) == len(sd) == 179

    params, stats = convert_raft(sd)
    m = jr.RAFT(iters=3, dtype=jnp.float32)
    im1, im2 = _images(48, 64, seed=8)
    want = np.asarray(jax.jit(m.apply)({"params": params, "batch_stats": stats},
                                       jnp.asarray(im1), jnp.asarray(im2)))
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        got = nhwc(net.eval()(nchw(im1), nchw(im2)))
    np.testing.assert_allclose(got, want, atol=NET_TOL * np.abs(want).max())


def test_bf16_runs_in_bf16_and_returns_float32():
    net = tr.seeded_init_(tr.RAFT(iters=2), 0)
    assert net.dtype == torch.bfloat16
    im1, im2 = _images(48, 64, seed=9)
    with torch.no_grad():
        fmap = net.fnet(nchw(im1))
        flow = net(nchw(im1), nchw(im2))
    assert fmap.dtype == torch.bfloat16
    assert flow.dtype == torch.float32 and flow.shape == (2, 2, 48, 64)
    assert torch.isfinite(flow).all()


def test_seeded_init_is_deterministic():
    a = tr.seeded_init_(tr.RAFT(), 3).state_dict()
    b = tr.seeded_init_(tr.RAFT(), 3).state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# -- raft_eval ---------------------------------------------------------------


def test_flow_metrics_match_jax():
    rng = np.random.default_rng(10)
    gt = rng.normal(0, 5, (3, 8, 10, 2)).astype(np.float32)
    pred = gt + rng.normal(0, 3, gt.shape).astype(np.float32)
    valid = (rng.uniform(0, 1, (3, 8, 10)) > 0.3).astype(np.float32)
    valid[2] = 0.0  # an all-invalid image counts as 0
    for v in (None, valid):
        want = je.flow_metrics(jnp.asarray(pred), jnp.asarray(gt),
                               None if v is None else jnp.asarray(v))
        got = te.flow_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                              None if v is None else torch.from_numpy(v))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_evaluate_pairs_and_padding_match_jax():
    """The same flow function (edge-padded to multiples of 8, a fixed
    smooth field) through both harnesses: the same aggregates."""
    rng = np.random.default_rng(11)
    samples = [(rng.uniform(0, 255, (13, 21, 3)).astype(np.float32),
                rng.uniform(0, 255, (13, 21, 3)).astype(np.float32),
                rng.normal(0, 4, (13, 21, 2)).astype(np.float32),
                (rng.uniform(0, 1, (13, 21)) > 0.2).astype(np.float32)) for _ in range(5)]

    def field(p):  # (B, H, W, 3) padded images -> a flow from their colours
        return p[..., :2] / 40.0 - p[..., 2:3] / 80.0

    def jfn(im1, im2):
        p, _ = je.pad_to_multiple(im1 - im2)
        assert p.shape[1] % 8 == 0 and p.shape[2] % 8 == 0
        return field(p)[:, :13, :21]

    def tfn(im1, im2):
        p, pads = te.pad_to_multiple(im1 - im2)
        assert pads == (3, 3)
        return field(p)[:, :13, :21]

    want = je.evaluate_pairs(jfn, iter(samples), batch=2)
    got = te.evaluate_pairs(tfn, iter(samples), batch=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9)
    assert te.evaluate_pairs(tfn, iter([]), batch=2) == {}


def test_make_flow_fn_and_validate(tmp_path):
    net = tr.seeded_init_(tr.RAFT(iters=1, dtype=torch.float32), 0)
    im = torch.rand(1, 20, 30, 3, generator=torch.Generator().manual_seed(0)) * 255
    flow = te.make_flow_fn(net)(im, im)
    assert flow.shape == (1, 20, 30, 2) and torch.isfinite(flow).all()
    assert te.validate(net, str(tmp_path / "absent")) == {}


def test_readers(tmp_path):
    flow = np.random.default_rng(12).normal(0, 1, (6, 9, 2)).astype(np.float32)
    p = str(tmp_path / "x.flo")
    with open(p, "wb") as f:
        f.write(np.float32(202021.25).tobytes() + np.int32(9).tobytes()
                + np.int32(6).tobytes() + flow.tobytes())
    np.testing.assert_array_equal(te.read_flo(p), je.read_flo(p))
    img = np.random.default_rng(13).integers(0, 2 ** 16, (4, 5, 3)).astype(np.uint16)
    for a, b in zip(te.decode_kitti_flow(img), je.decode_kitti_flow(img)):
        np.testing.assert_array_equal(a, b)
