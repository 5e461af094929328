"""The optimizer and solver options and the projections: the JAX package vs
the PyTorch port on the CPU.

- FlatAdam's RAdam and bf16-first-moment modes (the plain twins of the Adam
  kernel's modes 2 and 3) against jitted optax.radam and
  optax.adam(mu_dtype=jnp.bfloat16), as the JAX fine-tune step runs them,
  over 8 taken steps from the same gradients (RAdam's ro_t crosses 5
  between steps 5 and 6) and one skipped step that changes nothing.
  Parameters and float32 moments within 1e-6 of their largest magnitude
  (one float32 rounding step at most per update, 8 updates); the bf16 first
  moment within one bf16 ulp, because XLA fuses its b1 * mu + (1 - b1) * g
  and the port rounds each product, so the float32 sums can differ in their
  last bit and round to neighbouring bf16 values.
- Hutchinson-probe preconditioning: both packages' `_diag_estimate` on a
  diagonal operator, where (A z) * z equals the diagonal for every
  Rademacher probe, so the two estimates agree exactly though their probes
  differ (floor included); the port's estimate on a dense SPD operator
  against its true diagonal, within 5 standard deviations of the estimator;
  a pose solve with probes in both packages (see its docstring for the
  tolerance).
- The non-perspective projections: tests/test_camera.py:128-173's cases in
  parity form (float32, same formulas: 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robust_cvd_tpu.config import PoseOptParams
from robust_cvd_tpu.ops import geometry as jgeo
from robust_cvd_tpu.solver import lm as jlm
from robust_cvd_tpu.solver import pose_opt as jpo
from robust_cvd_tpu_torch.ops import geometry as tgeo
from robust_cvd_tpu_torch.solver import lm as tlm
from robust_cvd_tpu_torch.solver import pose_opt as tpo
from robust_cvd_tpu_torch.solver import residuals as tres
from robust_cvd_tpu_torch.training.optimizer import FlatAdam

from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-2
STEPS = 9
SKIP = 4  # the guard-off step: a non-finite loss


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("mode", ["radam", "mu_bf16"])
def test_flat_adam_modes_match_optax(mode):
    rng = np.random.default_rng(21)
    shapes = [(37,), (5, 8)]  # 77 elements: the kernel's scalar tail too
    init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    n = sum(a.size for a in init)
    grads = (rng.normal(0, 1, (STEPS, n)) * rng.uniform(0.01, 2.0, (STEPS, 1))).astype(np.float32)

    params = [(f"p{i}", torch.nn.Parameter(torch.from_numpy(a.copy()))) for i, a in enumerate(init)]
    opt = FlatAdam(params, LR, rectified=mode == "radam", mu_bf16=mode == "mu_bf16")
    assert opt.mu.dtype == (torch.bfloat16 if mode == "mu_bf16" else torch.float32)

    tx = optax.radam(LR) if mode == "radam" else optax.adam(LR, mu_dtype=jnp.bfloat16)
    jp = jnp.asarray(np.concatenate([a.ravel() for a in init]))
    state = tx.init(jp)

    @jax.jit
    def jstep(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    taken = 0
    for k in range(STEPS):
        opt.grad.copy_(torch.from_numpy(grads[k]))
        if k == SKIP:
            before = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
            ok = opt.step(torch.tensor(float("nan")))
            assert not bool(ok)
            assert all(torch.equal(a, b) for a, b in zip(before, (opt.flat, opt.mu, opt.nu, opt.count)))
            continue
        assert bool(opt.step(torch.tensor(1.0)))
        taken += 1
        jp, state = jstep(jp, state, jnp.asarray(grads[k]))
        adam_state = state[0]
        want_p, want_mu = np.asarray(jp), np.asarray(adam_state.mu.astype(jnp.float32))
        want_nu = np.asarray(adam_state.nu)
        got_p, got_mu = opt.flat.numpy(), opt.mu.float().numpy()
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6 * np.abs(want_p).max())
        np.testing.assert_allclose(opt.nu.numpy(), want_nu, rtol=0, atol=1e-6 * want_nu.max())
        if mode == "mu_bf16":
            assert np.all(np.abs(got_mu - want_mu) <= _bf16_ulp(want_mu)), k
        else:
            np.testing.assert_allclose(got_mu, want_mu, rtol=0, atol=1e-6 * np.abs(want_mu).max())
        assert int(opt.count) == int(adam_state.count) == taken
    assert taken == STEPS - 1
    # the views of the net's parameters moved with the buffer
    assert torch.equal(params[1][1].detach().reshape(-1), opt.flat[37:])


def test_radam_branch_turns_between_steps_5_and_6():
    """The plain twin's rectification switch, read from what one step does:
    before ro_t reaches 5 the update is lr * mu_hat, the bias-corrected
    first moment alone, from step 6 on it is rescaled."""
    from robust_cvd_tpu_torch.ops.adam import adam_update_plain

    g = torch.full((4,), 0.5)
    for count, rectified in ((4, False), (5, True)):
        p, mu, nu = torch.zeros(4), torch.full((4,), 0.2), torch.full((4,), 0.1)
        adam_update_plain(p, g, mu, nu, torch.tensor(count, dtype=torch.int32),
                          torch.tensor(True), LR, rectified=True)
        mu_hat = mu / (1 - torch.tensor(0.9, dtype=torch.float64) ** (count + 1)).float()
        assert torch.allclose(p, -LR * mu_hat) != rectified


# -- Hutchinson probes ---------------------------------------------------------


def test_diag_estimate_on_a_diagonal_operator():
    rng = np.random.default_rng(31)
    diag = [rng.normal(0, 2, (7, 6)).astype(np.float32), rng.normal(0, 2, (5,)).astype(np.float32)]
    diag[1][2] = 0.0  # clipped to the floor in both
    jd = jlm._diag_estimate(lambda z: [a * b for a, b in zip(map(jnp.asarray, diag), z)],
                            [jnp.zeros(d.shape) for d in diag], jax.random.PRNGKey(17), 4)
    gen = torch.Generator().manual_seed(17)
    td = tlm._diag_estimate(lambda z: [a * b for a, b in zip(map(torch.from_numpy, diag), z)],
                            [torch.zeros(d.shape) for d in diag], gen, 4)
    for j, t, d in zip(jd, td, diag):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)
        np.testing.assert_allclose(t.numpy(), np.maximum(np.abs(d), t.numpy().min()), rtol=1e-6)
    floor = 1e-6 * sum(np.abs(d).sum() for d in diag) / sum(d.size for d in diag)
    assert np.isclose(td[1][2].item(), floor, rtol=1e-5)


def test_diag_estimate_statistics_on_a_dense_operator():
    """E[(A z) * z] = diag(A); each entry's estimator has variance
    sum_{j != i} A_ij^2 / probes."""
    rng = np.random.default_rng(32)
    m = 48
    q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    a = torch.from_numpy((q * rng.uniform(0.5, 4.0, m)) @ q.T).float()
    probes = 256
    gen = torch.Generator().manual_seed(17)
    est = tlm._diag_estimate(lambda z: [a @ z[0]], [torch.zeros(m)], gen, probes)[0]
    true = torch.diagonal(a)
    std = torch.sqrt(((a * a).sum(1) - true * true) / probes)
    assert torch.all((est - true).abs() <= 5 * std)
    assert (est - true).abs().mean() < 1.5 * std.mean()
    again = tlm._diag_estimate(lambda z: [a @ z[0]], [torch.zeros(m)], gen, probes)[0]
    assert not torch.equal(again, est)  # fresh probes from the advancing generator


def test_pose_solve_with_probes_matches():
    """A cold pose_opt.run with the exact diagonal off and 4 Hutchinson
    probes per outer step, in both packages, on the 6-frame exact problem of
    tests/test_torch_pkg_solver.py::test_pose_opt_run_matches, with an
    outer-step and CG budget that converges it (cost about 1e-11 of a start
    of 10).

    Tolerance 2.5e-3 on the poses. The probes differ (jax.random against a
    torch.Generator), so the CG solves take different steps. The minimum is
    flat along a direction the exact constraints leave free: with one and
    the same preconditioner the two packages agree within 1.2e-7, while one
    package's converged solves under the exact, the probe and no
    preconditioner spread by up to 1.8e-3 (measured on the CPU, this
    problem). The port's probe solve is held to its own exact-preconditioner
    solve at the same tolerance."""
    from bench import make_clip_problem

    from tests.test_torch_pkg_solver import port_type, to_torch

    jin, _ = make_clip_problem(num_frames=6, samples_per_pair=16, seed=0)
    exact = dataclasses.replace(
        PoseOptParams(), num_steps=1, ctf_long=3, ctf_short=2, lm_max_outer=20,
        lm_cg_iters=32,
    )
    opt = dataclasses.replace(exact, lm_precond_exact=False, lm_precond_probes=4)
    tin = tpo.PoseOptInputs(
        data=port_type(jin.data, tres.ConstraintData),
        median_depth=to_torch(jin.median_depth), aspect=jin.aspect,
        num_frames=jin.num_frames,
    )
    log = []
    jp = jpo.run(opt, jin)
    tp = tpo.run(opt, tin, log=log)
    assert np.abs(tp.pose.numpy() - np.asarray(jp.pose)).max() <= 2.5e-3
    assert (tp.pose - tpo.run(exact, tin).pose).abs().max() <= 2.5e-3
    assert [e["stage"] for e in log] == ["normalize", "step0"]
    assert all(e["cost"] < 1e-6 * e["cost0"] for e in log)


def test_probes_only_without_an_exact_diagonal():
    """Probes engage only without an exact diagonal: with diag_fn the solve
    never draws from a generator (a probe count changes nothing)."""
    p = tres.SolverParams(
        pose=torch.zeros(1, 6), focal=torch.ones(1),
        depth_grid=torch.ones(1, 1, 1, 1), spatial_grid=torch.zeros(1, 1, 1, 2),
    )

    def res(q, w, aux):
        return torch.cat([2.0 * q.pose.reshape(-1) - 1.0, q.focal - 3.0])

    def diag(q, w, aux):
        return tres.SolverParams(torch.full((1, 6), 4.0), torch.ones(1),
                                 torch.zeros(1, 1, 1, 1), torch.zeros(1, 1, 1, 2))

    mask = tlm.make_mask(p)
    a = tlm.solve(res, None, p, mask, tlm.LMConfig(precond_probes=0), diag_fn=diag)
    b = tlm.solve(res, None, p, mask, tlm.LMConfig(precond_probes=3), diag_fn=diag)
    assert torch.equal(a.params.pose, b.params.pose) and a.cost == b.cost


# -- projections ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["equirect", "cylindrical"])
def test_projection_roundtrip_matches(kind):
    h, w = 18, 40
    vfov, hfov = (1.0, 2.0) if kind == "equirect" else (0.8, 2.5)
    lat, lon = (0.1, -0.2) if kind == "equirect" else (0.05, 0.3)
    rng = np.random.default_rng(3 if kind == "equirect" else 4)
    dist = rng.uniform(1.0, 5.0, (h, w)).astype(np.float32)
    jpix, tpix = jgeo.pixel_grid((h, w)), tgeo.pixel_grid((h, w))
    unproj, proj = f"pixels_to_points_{kind}", f"project_{kind}"
    jpts = getattr(jgeo, unproj)(jpix, jnp.asarray(dist), (h, w), vfov, hfov, lat, lon)
    tpts = getattr(tgeo, unproj)(tpix, torch.from_numpy(dist), (h, w), vfov, hfov, lat, lon)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(tpts.numpy(), axis=-1), dist, rtol=1e-5)
    jback = getattr(jgeo, proj)(jpts, (h, w), vfov, hfov, lat, lon)
    tback = getattr(tgeo, proj)(tpts, (h, w), vfov, hfov, lat, lon)
    np.testing.assert_allclose(tback.numpy(), np.asarray(jback), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tback.numpy(), tpix.numpy(), atol=1e-3)
    if kind == "equirect":
        ctr = tgeo.pixels_to_points_equirect(
            torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0]), torch.tensor(2.0), (h, w), vfov, hfov)
        np.testing.assert_allclose(ctr.numpy(), [0.0, 0.0, -2.0], atol=1e-6)


@pytest.mark.parametrize("code", [0, 1, 2])
def test_projection_dispatch_matches(code):
    h, w = 12, 16
    vfov, hfov = 0.7, 0.9
    jpix, tpix = jgeo.pixel_grid((h, w)), tgeo.pixel_grid((h, w))
    depth = np.full((h, w), 3.0, np.float32)
    jpts = jgeo.pixels_to_points_proj(code, jpix, jnp.asarray(depth), (h, w), vfov, hfov)
    tpts = tgeo.pixels_to_points_proj(code, tpix, torch.from_numpy(depth), (h, w), vfov, hfov)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=1e-5, atol=1e-5)
    back = tgeo.project_proj(code, tpts, (h, w), vfov, hfov)
    np.testing.assert_allclose(back.numpy(), np.asarray(jgeo.project_proj(code, jpts, (h, w), vfov, hfov)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), tpix.numpy(), atol=1e-3)
    if code == tgeo.PROJECTION_PERSPECTIVE:
        ref = tgeo.pixels_to_points(
            tgeo.intrinsics_px(torch.tensor(vfov), torch.tensor(hfov), (h, w)),
            torch.from_numpy(depth), tpix)
        np.testing.assert_allclose(tpts.numpy(), ref.numpy(), atol=1e-6)
    assert (tgeo.PROJECTION_PERSPECTIVE, tgeo.PROJECTION_EQUIRECTANGULAR,
            tgeo.PROJECTION_CYLINDRICAL) == (jgeo.PROJECTION_PERSPECTIVE,
                                             jgeo.PROJECTION_EQUIRECTANGULAR,
                                             jgeo.PROJECTION_CYLINDRICAL)
