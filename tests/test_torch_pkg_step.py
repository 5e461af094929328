"""One fine-tune train step: the PyTorch port against the JAX package.

The small MiDaS net (features=32, backbone_layers=(1, 1, 1, 1)) with
Flax-initialised weights and randomised BatchNorm statistics, carried to the
port through state_dict_from_jax, takes one step on a 4-frame 32x64 clip
(numpy-seeded images, depths, flows and masks; a pose state from random
poses, a 2x3 depth grid and a spatial warp) at the default LossParams:
robust_cvd_tpu/training/fine_tune.py::_make_step_body with optax.adam
against training/fine_tune.py::train_step with FlatAdam (the plain Adam on
the CPU). The JAX optimizer is chained behind a pass-through that keeps
the gradients in its state, so both sides expose them.

The step runs in float64 on both sides (the net, the pose state, the loss
and Adam; the clip's float32 values are exact in float64). In float32, a
random-weight net has some of its ~10^5 ReLU inputs within rounding of 0,
two float32 implementations disagree on whether those pass, and every
gradient upstream of such an element moves by up to 1e-3 of the largest
gradient (measured here: the port's and the JAX package's float32 steps
both against float64). In float64 the step is compared at the stated
tolerances: loss and parts within 1e-5 relative; gradients, mu, nu and the
BatchNorm statistics after the step within 1e-4 * max|ref| per tensor.
Parameters: the first Adam step moves each one by about lr times the sign
of its gradient, so parameters whose gradient is far from 0 must move
alike (within 1e-3 lr), and none may differ by more than 2 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.solver.residuals import SolverParams as JSolverParams
from robust_cvd_tpu.training import fine_tune as jft
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.solver.residuals import SolverParams as TSolverParams
from robust_cvd_tpu_torch.training import fine_tune as tft
from robust_cvd_tpu_torch.training.optimizer import FlatAdam

N, H, W = 4, 32, 64
LR = 1e-4


def _clip_inputs(rng):
    images = rng.uniform(0, 1, (N, H, W, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (N, H, W)).astype(np.float32)
    flow_list, flows, masks = [], {}, {}
    for i in range(N):
        for j in range(N):
            if i != j and abs(i - j) <= 2:
                flow_list.append((i, j, 0.9))
                flows[(i, j)] = rng.normal(0, 1.0, (H, W, 2)).astype(np.float32)
                masks[(i, j)] = (rng.uniform(0, 1, (H, W)) > 0.3).astype(np.float32)
    return images, depth, flow_list, flows, masks


def _solver_params(rng):
    return dict(
        pose=rng.normal(0, 0.02, (N, 6)).astype(np.float32),
        focal=np.full((N,), 0.5, np.float32),
        depth_grid=rng.uniform(0.8, 1.2, (N, 1, 2, 3)).astype(np.float32),
        spatial_grid=rng.normal(0, 0.01, (N, 1, 1, 2)).astype(np.float32),
    )


def _capture():
    """Pass-through transformation that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (u, u)
    )


def _setup():
    rng = np.random.default_rng(0)
    fnet = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])

    def randomize(path, x):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    stats = jax.tree_util.tree_map_with_path(randomize, stats)
    params["output_conv3"]["bias"] = np.full((1,), 1.0, np.float32)
    return fnet, params, stats, _clip_inputs(rng), _solver_params(rng), np.array([2, 0], np.int64)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module")
def steps():
    _, params, stats, (images, depth, flow_list, flows, masks), sp, ids = _setup()

    # JAX package, float64
    with jax.enable_x64(True):
        fnet = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float64)
        jclip = jft.build_clip_data(images, depth, flow_list, flows, masks, 0.2)
        jps = jft.pose_state_from_solver(
            JSolverParams(**_f64(sp)), (H, W), W / H, jnp.asarray(jclip.depth_orig, jnp.float64)
        )
        optimizer = optax.chain(_capture(), optax.adam(LR))
        jparams = _f64(params)
        body = jax.jit(jft._make_step_body(fnet, jconfig.LossParams(), optimizer, False))
        new_params, new_stats, new_opt, loss, parts = body(
            jparams, _f64(stats), optimizer.init(jparams),
            jnp.asarray(ids, jnp.int32), jclip, jps, jparams,
        )
        adam_state = new_opt[1][0]
        jax_out = dict(
            loss=float(loss), parts={k: np.asarray(v) for k, v in parts.items()},
            params=jax.tree.map(np.asarray, new_params),
            stats=jax.tree.map(np.asarray, new_stats),
            grads=jax.tree.map(np.asarray, new_opt[0]),
            mu=jax.tree.map(np.asarray, adam_state.mu),
            nu=jax.tree.map(np.asarray, adam_state.nu),
            count=int(adam_state.count),
        )

    # the port, float64
    net = tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1))
    net.load_state_dict(tm.state_dict_from_jax(params, stats))
    net = net.double()
    opt = FlatAdam(list(net.named_parameters()), LR)
    tclip = tft.build_clip_data(images, depth, flow_list, flows, masks, 0.2, device="cpu")
    tclip = tft.ClipData(*[t.double() if t is not None and t.is_floating_point() else t
                           for t in tclip])
    tps = tft.pose_state_from_solver(
        TSolverParams(**{k: torch.from_numpy(v).double() for k, v in sp.items()}),
        (H, W), W / H, tclip.depth_orig,
    )
    p0 = opt.flat.clone()
    tloss, tparts, ok = tft.train_step(
        net, opt, tconfig.LossParams(), torch.from_numpy(ids), tclip, tps, False
    )
    return dict(jax=jax_out, params0=params, stats0=stats, net=net, opt=opt, p0=p0,
                loss=tloss, parts=tparts, ok=ok)


def _named(opt, tree, stats0):
    """A Flax tree shaped like the params -> {port parameter name: float64
    array} (state_dict_from_jax's layout moves, without its float32 cast)."""
    hi = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    lo = jax.tree.map(lambda a: a - np.asarray(a, np.float32).astype(np.float64), hi)
    sd_hi = tm.state_dict_from_jax(hi, stats0)
    sd_lo = tm.state_dict_from_jax(lo, stats0)
    return {n: sd_hi[n].double().numpy() + sd_lo[n].double().numpy() for n in opt.names}


def _flat(opt, tree, stats0):
    named = _named(opt, tree, stats0)
    return np.concatenate([named[n].reshape(-1) for n in opt.names])


def _close_per_tensor(opt, buf, tree, stats0, what):
    want = _named(opt, tree, stats0)
    checked = 0
    for n, got in opt.named_views(buf).items():
        w = want[n]
        if n.startswith("scratch.refinenet4.resConfUnit1"):
            assert not got.any() and not w.any()  # dead weights: no gradient
            continue
        assert np.abs(w).max() > 0, (what, n)
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=f"{what} {n}")
        checked += 1
    assert checked > 50


def test_loss_and_parts(steps):
    j = steps["jax"]
    assert bool(steps["ok"]) and int(steps["opt"].count) == j["count"] == 1
    np.testing.assert_allclose(float(steps["loss"]), j["loss"], rtol=1e-5)
    assert set(steps["parts"]) == set(j["parts"]) == {"reproj", "depth_ratio", "contrast"}
    for k, v in j["parts"].items():
        np.testing.assert_allclose(steps["parts"][k].numpy(), v, rtol=1e-5, err_msg=k)


def test_gradients_and_moments(steps):
    j, opt = steps["jax"], steps["opt"]
    _close_per_tensor(opt, opt.grad, j["grads"], steps["stats0"], "gradient")
    _close_per_tensor(opt, opt.mu, j["mu"], steps["stats0"], "mu")
    _close_per_tensor(opt, opt.nu, j["nu"], steps["stats0"], "nu")


def test_parameters_and_batch_stats(steps):
    j, opt = steps["jax"], steps["opt"]
    p0 = steps["p0"].numpy()
    d_port = opt.flat.numpy() - p0
    d_jax = _flat(opt, j["params"], steps["stats0"]) - p0
    assert np.abs(d_jax).max() > 0.5 * LR
    assert np.abs(d_port - d_jax).max() <= 2 * LR * (1 + 1e-3)
    g = np.abs(_flat(opt, j["grads"], steps["stats0"]))
    clear = g > 1e-6 * g.max()  # gradients far from 0: the update is ~lr sign(g)
    assert clear.mean() > 0.9
    np.testing.assert_allclose(d_port[clear], d_jax[clear], rtol=0, atol=1e-3 * LR)

    want = tm.state_dict_from_jax(j["params"], j["stats"])
    before = tm.state_dict_from_jax(j["params"], steps["stats0"])
    moved = 0
    for k, v in steps["net"].state_dict().items():
        if "running" in k:
            w = want[k].numpy()
            assert not np.array_equal(w, before[k].numpy()), k
            np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=k)
            moved += 1
    assert moved > 0
