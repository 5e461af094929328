"""training/losses.py of the PyTorch port against the JAX package's loss stack.

A batch of B = 2 pair samples at 16x24 (N = 2 frames per sample, or 6 with
the temporal terms) is made from a numpy seed: depths in [1, 3], nearly
identity cameras, small flows, spatial warps and soft masks. Every loss
family and `joint_loss` run in both packages on the CPU, at the default
LossParams and with every lambda on (temporal terms and the parameter loss
included). Losses and `parts` agree within rtol 1e-5; the gradient with
respect to the depths within 1e-4 * max|ref| (the JAX side samples through
grid_sample_matmul, whose data-gradient is a dense contraction; the port's
is autograd's scatter-add, so sums run in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.training import losses as jl
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.training import losses as tl

B, H, W = 2, 16, 24
ALL_ON = dict(
    lambda_static_disparity=1.0, lambda_static_depth_ratio=100.0,
    lambda_static_reprojection=1.0, lambda_scene_flow_static=1.0,
    lambda_smooth_disparity=1.0, lambda_smooth_depth_ratio=1.0,
    lambda_smooth_reprojection=1.0, lambda_parameter=1e-3,
    lambda_disparity_smooth=1.0, lambda_contrast_loss=1.0,
)
CONFIGS = {
    "default": {},
    "all_on": ALL_ON,
    "all_on_robust": dict(ALL_ON, distance_type_static="general", distance_alpha=0.5,
                          distance_type_smooth="cauchy", distance_scale=2.0),
}


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.normal(0, 0.02, (B, n, 3))
    rot = []
    for a in ang.reshape(-1, 3):
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        rot.append(np.eye(3) + k + 0.5 * k @ k)
    rot = np.asarray(rot).reshape(B, n, 3, 3)
    ext = np.concatenate([rot, rng.normal(0, 0.05, (B, n, 3, 1))], -1)
    intr = np.concatenate(
        [rng.uniform(18, 22, (B, n, 2)), np.broadcast_to([(W - 1) / 2, (H - 1) / 2], (B, n, 2))], -1
    )
    d = dict(
        depths=rng.uniform(1, 3, (B, n, H, W)),
        depths_orig=rng.uniform(1, 3, (B, n, H, W)),
        images=rng.uniform(0, 1, (B, n, H, W, 3)),
        extrinsics=ext,
        intrinsics=intr,
        flows=rng.normal(0, 1.5, (B, 2, H, W, 2)),
        masks=rng.uniform(0, 1, (B, 2, H, W)),
        warp=rng.normal(0, 0.01, (B, n, H, W, 2)),
        flows_n=rng.normal(0, 1.5, (B, 4, H, W, 2)),
        masks_n=rng.uniform(0, 1, (B, 4, H, W)),
        valid_n=np.array([[1.0, 0.0], [1.0, 1.0]]),
        params=rng.normal(0, 1, 50),
        params_init=rng.normal(0, 1, 50),
    )
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


META = ("extrinsics", "intrinsics", "flows", "masks", "warp", "flows_n", "masks_n", "valid_n")


def _families(lib, opt, x, depths, meta_cls, params, params_init, wrap):
    """name -> (total, parts) of every loss family, in one package."""
    meta = meta_cls(**{k: wrap(x[k]) for k in META})
    images, orig = wrap(x["images"]), wrap(x["depths_orig"])
    out = {
        "consistency": lib.consistency_loss(depths, meta, opt),
        "scene_flow": lib.scene_flow_loss(depths, meta, opt),
        "disparity_smooth": lib.disparity_smooth_loss(images, depths, opt),
        "contrast": (lib.contrast_loss(orig, depths, opt), {}),
        "parameter": (lib.parameter_loss(params, params_init, opt), {}),
        "joint": lib.joint_loss(opt, images, orig, depths, meta, params=params,
                                params_init=params_init),
    }
    return out


def _jax_side(opt, x):
    params = {"w": jnp.asarray(x["params"])}
    init = {"w": jnp.asarray(x["params_init"])}

    def total(depths):
        return _families(jl, opt, x, depths, jl.LossMeta, params, init, jnp.asarray)["joint"][0]

    fams = _families(jl, opt, x, jnp.asarray(x["depths"]), jl.LossMeta, params, init, jnp.asarray)
    grad = jax.grad(total)(jnp.asarray(x["depths"]))
    return fams, np.asarray(grad)


def _torch_side(opt, x):
    depths = torch.from_numpy(x["depths"]).requires_grad_(True)
    fams = _families(
        tl, opt, x, depths, tl.LossMeta, torch.from_numpy(x["params"]),
        torch.from_numpy(x["params_init"]), torch.from_numpy,
    )
    fams["joint"][0].backward()
    return fams, depths.grad.numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_families_and_joint_loss(name):
    kw = CONFIGS[name]
    x = _inputs(6 if name != "default" else 2)
    jopt = jconfig.LossParams(**kw)
    topt = tconfig.LossParams(**kw)
    jf, jgrad = _jax_side(jopt, x)
    tf, tgrad = _torch_side(topt, x)
    for fam, (jtotal, jparts) in jf.items():
        ttotal, tparts = tf[fam]
        np.testing.assert_allclose(ttotal.detach().numpy(), np.asarray(jtotal), rtol=1e-5,
                                   err_msg=f"{name}/{fam}")
        assert set(tparts) == set(jparts), (fam, set(tparts), set(jparts))
        for key in jparts:
            np.testing.assert_allclose(tparts[key].detach().numpy(), np.asarray(jparts[key]),
                                       rtol=1e-5, err_msg=f"{name}/{fam}/{key}")
    if name == "default":
        assert set(tf["joint"][1]) == {"reproj", "depth_ratio", "contrast"}
    else:
        assert len(tf["joint"][1]) == 10
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=1e-4 * np.abs(jgrad).max())


@pytest.mark.parametrize("kind,alpha", [("l1", 1.0), ("l2", 1.0), ("smooth_l1", 1.0),
                                        ("cauchy", 1.0), ("general", -np.inf),
                                        ("general", -2.0), ("general", 0.5)])
def test_distances(kind, alpha):
    x = np.random.default_rng(3).normal(0, 2, 64).astype(np.float32)
    jopt = jconfig.LossParams(distance_alpha=alpha, distance_scale=0.7)
    topt = tconfig.LossParams(distance_alpha=alpha, distance_scale=0.7)
    want = np.asarray(jl.make_distance(kind, jopt)(jnp.asarray(x)))
    got = tl.make_distance(kind, topt)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    w = np.abs(x[:32]).reshape(2, 16)
    np.testing.assert_allclose(
        tl.weighted_mean(torch.from_numpy(x[32:].reshape(2, 16)), torch.from_numpy(w)).numpy(),
        np.asarray(jl.weighted_mean(jnp.asarray(x[32:].reshape(2, 16)), jnp.asarray(w))),
        rtol=1e-5,
    )


def test_parameter_loss_gradient_at_its_start():
    """At the first step every parameter equals its initial value; the
    port's |x| has jnp.abs's derivative 1 there, not torch.abs's 0."""
    opt = tconfig.LossParams(lambda_parameter=0.5)
    p = torch.zeros(5, requires_grad=True)
    tl.parameter_loss(p, torch.zeros(5), opt).backward()
    want = jax.grad(lambda q: jl.parameter_loss({"w": q}, {"w": jnp.zeros(5)},
                                                dataclasses.replace(jconfig.LossParams(),
                                                                    lambda_parameter=0.5)))(
        jnp.zeros(5))
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want))
