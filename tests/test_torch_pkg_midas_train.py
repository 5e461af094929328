"""MiDaS-v2 in train mode: the PyTorch port against the Flax network.

The small net (features=32, backbone_layers=(1, 1, 1, 1)) with Flax-
initialised parameters and randomised BatchNorm statistics runs a batch of
4 frames at 64x64 in train mode in both packages. The output and the
updated running mean and variance (Flax's update: momentum 0.9 with the
BIASED batch variance) agree within 1e-4 * max|ref| per tensor in float32.
A step whose guard flag is false leaves the running statistics bitwise
unchanged.

The parameter gradients of a scalar loss agree within 1e-4 * max|ref| per
tensor too, compared in float64 on both sides: with random weights a few of
the net's ~10^5 ReLU inputs lie within float32 rounding of 0, two float32
implementations then disagree on whether the ReLU passes them, and the
gradient of every layer upstream of that element changes by up to 10%
(found at layer4.0.bn1 of this net); in float64 both sides agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu_torch.models import layers
from robust_cvd_tpu_torch.models import midas as tm


@pytest.fixture(scope="module")
def nets():
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
        return x

    params = jax.tree_util.tree_map_with_path(randomize, params)
    stats = jax.tree_util.tree_map_with_path(randomize, stats)
    params["output_conv3"]["bias"] = np.full((1,), 0.5, np.float32)
    tnet = tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1))
    tnet.load_state_dict(tm.state_dict_from_jax(params, stats))
    x = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    ct = rng.normal(0, 1, (4, 64, 64)).astype(np.float32)
    return fnet, params, stats, tnet, x, ct


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    tol = 1e-4 * max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _nchw(x):
    return tm.normalize_images(torch.from_numpy(x)).permute(0, 3, 1, 2).contiguous()


def test_train_mode_output_and_stats(nets):
    fnet, params, stats, tnet, x, _ = nets
    apply = jax.jit(lambda v, xn: fnet.apply(v, xn, train=True, mutable=["batch_stats"]))
    want_out, upd = apply(
        {"params": params, "batch_stats": stats}, jm.normalize_images(jnp.asarray(x))
    )
    want_stats = upd["batch_stats"]

    tnet.train()
    with torch.no_grad():
        out = tnet(_nchw(x))
    assert (np.asarray(want_out) > 0).mean() > 0.2, "output mostly clipped"
    _close(out.detach().numpy(), want_out, "train-mode output")

    before = {k: v.clone() for k, v in tnet.state_dict().items() if "running" in k}
    layers.commit_batch_stats(tnet, torch.tensor(False))
    for k, v in tnet.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), f"{k} moved on a skipped step"

    # the same forward again, then the update with the flag set
    with torch.no_grad():
        tnet(_nchw(x))
    layers.commit_batch_stats(tnet, torch.tensor(True))
    want_sd = tm.state_dict_from_jax(params, jax.tree.map(np.asarray, want_stats))
    sd = tnet.state_dict()
    n_stats = 0
    for k, v in sd.items():
        if "running" in k:
            _close(v.numpy(), want_sd[k].numpy(), k)
            assert not torch.equal(v, before[k]), f"{k} did not move"
            n_stats += 1
    assert n_stats == 2 * len(layers.batch_norms(tnet)) > 0


def test_train_mode_parameter_gradients(nets):
    _, params, stats, _, x, ct = nets
    with jax.enable_x64(True):
        fnet = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float64)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        s64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)
        xn = jm.normalize_images(jnp.asarray(x, jnp.float64))

        def loss(p):
            out, _ = fnet.apply({"params": p, "batch_stats": s64}, xn, train=True,
                                mutable=["batch_stats"])
            return jnp.sum(out * ct)

        want = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(p64))

    tnet = tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1))
    tnet.load_state_dict(tm.state_dict_from_jax(params, stats))
    tnet = tnet.double().train()
    x64 = tm.normalize_images(torch.from_numpy(x).double()).permute(0, 3, 1, 2).contiguous()
    (tnet(x64) * torch.from_numpy(ct).double()).sum().backward()
    grad_sd = tm.state_dict_from_jax(want, stats)
    n = 0
    for k, p in tnet.named_parameters():
        if k.startswith("scratch.refinenet4.resConfUnit1"):
            assert p.grad is None  # the dead weights no Flax tree carries
            continue
        _close(p.grad.numpy(), grad_sd[k].numpy().astype(np.float64), k)
        n += 1
    assert n > 50
