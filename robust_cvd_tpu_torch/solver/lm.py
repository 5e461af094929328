"""Matrix-free Levenberg-Marquardt with IRLS robustification (PyTorch).

Port of robust_cvd_tpu/solver/lm.py, the replacement for the reference's
Ceres solve (lib/PoseOptimizer.cpp:954-962: SPARSE_NORMAL_CHOLESKY,
CauchyLoss):

  - all residuals are one batched tensor program (residuals.py),
  - Cauchy robustification as frozen IRLS weights per outer iteration,
  - the damped normal equations (J^T J + lam*I) dx = -J^T r are solved
    matrix-free with (preconditioned) conjugate gradients, where J v and
    J^T u are one torch.func.jvp / vjp through the residual function.

The parameters are a SolverParams whose `depth_shift` may be None; the
solver works on the list of its present tensors (`_leaves`), so the
transforms see tensors only.

The JAX package runs CG as a lax.while_loop and the outer steps as a
fori_loop over chunks of `chunk` steps with lax.cond skipping converged
steps. Here both are Python loops with the same caps, exits and count of
outer steps; each CG iteration and each outer step reads one flag back to
the host (`LMResult.syncs` counts them).

Preconditioning: the exact Jacobi (or pose-block Jacobi) diagonal of
`diag_fn`, else, with `precond_probes > 0`, a Hutchinson estimate from
Rademacher probes. The probes come from a torch.Generator, not from
jax.random, so the estimate agrees with the JAX package's only where it
does not depend on the probes (a diagonal operator) and in distribution.

Sharded solves: where the residual function covers one rank's share of
the constraints (parallel/mesh.py::shard_pose_inputs), `all_reduce` sums a
flat buffer over the ranks in place. The solver sums the cost and J^T r
(one buffer), each CG matvec's J^T J v, the exact diagonal with its pose
blocks or the Hutchinson probes' products (all probes in one buffer), and
the trial cost: one all-reduce a CG iteration and three an outer step
beyond them (two without a preconditioner). Everything else (CG's
vectors, lambda, the accept flag, every exit) is computed from summed
values on replicated parameters, so every rank takes the same decisions
and holds the same bits; Hutchinson probes come from the same seed on
every rank.

Masking (fix_poses etc., reference lib/PoseOptimizer.cpp:915-948) is a 0/1
SolverParams applied inside the CG operator. Lower bounds (scale >= 0 in
depth normalization, lib/PoseOptimizer.cpp:1105-1115) are enforced by
projection after each step.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


class LMConfig(NamedTuple):
    max_outer: int = 50
    cg_iters: int = 64
    lam_init: float = 1e-3
    lam_up: float = 4.0
    lam_down: float = 0.5
    lam_min: float = 1e-9
    lam_max: float = 1e8
    rtol: float = 1e-8
    # IRLS robustness scale (Cauchy a); <= 0 disables robustification.
    robustness: float = 0.5
    # convergence bookkeeping restarts every `chunk` outer steps and the
    # step cap is max_outer rounded up to whole chunks, as in the JAX solver
    chunk: int = 10
    # Hutchinson probes per outer step for a diagonal preconditioner where
    # no exact diagonal is given; 0 = off
    precond_probes: int = 0


class LMResult(NamedTuple):
    params: object
    cost: float  # final cost
    cost0: float  # cost at the start point
    iterations: int  # outer steps run
    cg_iterations: int  # CG iterations over all outer steps
    syncs: int  # device -> host reads of a flag or cost
    lam: torch.Tensor
    all_reduces: int = 0  # sums over the ranks (0 without all_reduce)
    # the Hutchinson probes' generator state after the solve (None: no
    # probes); equal states from seed 17 mean the same probes were drawn
    probe_state: torch.Tensor | None = None


# -- parameter leaves ---------------------------------------------------------


def _leaves(p) -> List[torch.Tensor]:
    """The present tensors of a SolverParams-like NamedTuple (None skipped)."""
    return [x for x in p if x is not None]


def _rebuild(template, leaves):
    """A NamedTuple like `template` holding `leaves` where it holds tensors."""
    it = iter(leaves)
    return type(template)(*[None if x is None else next(it) for x in template])


def _tdot(a, b) -> torch.Tensor:
    out = a[0].new_zeros(())
    for x, y in zip(a, b):
        out = out + torch.dot(x.reshape(-1), y.reshape(-1))
    return out


def _taxpy(alpha, x, y):
    """alpha * x + y."""
    return [alpha * a + b for a, b in zip(x, y)]


def _tmul(a, b):
    return [x * y for x, y in zip(a, b)]


def _summed(all_reduce, tensors):
    """`tensors` summed over the ranks through one all-reduce of one flat
    buffer; `tensors` themselves without all_reduce."""
    if all_reduce is None:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
    parts = flat.split([t.numel() for t in tensors])
    return [x.view_as(t) for x, t in zip(parts, tensors)]


def _cg(matvec: Callable, b, iters: int, rtol: float = 0.01, minv=None):
    """(Preconditioned) conjugate gradients on leaf lists, with the
    inexact-Newton stop ||r|| < rtol * ||b|| or `iters` iterations. `minv`
    is None, a leaf list (M^-1 = 1/diag) or a callable. The stop reads the
    TRUE residual norm. Returns (x, iterations, host syncs)."""
    x = [torch.zeros_like(t) for t in b]
    b2 = _tdot(b, b)
    tol2 = (rtol * rtol) * b2

    def apply_minv(r):
        if minv is None:
            return r
        if callable(minv):
            return minv(r)
        return _tmul(r, minv)

    r = b
    p = apply_minv(b)
    rz = _tdot(b, p)
    r2 = b2
    it = 0
    syncs = 0
    while it < iters:
        syncs += 1
        if not bool(r2 > tol2):
            break
        ap = matvec(p)
        denom = _tdot(p, ap)
        alpha = torch.where(denom > 0, rz / denom.clamp_min(1e-30), torch.zeros_like(rz))
        x = _taxpy(alpha, p, x)
        r = _taxpy(-alpha, ap, r)
        z = apply_minv(r)
        rz_new = _tdot(r, z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = _taxpy(beta, p, z)
        rz = rz_new
        r2 = _tdot(r, r)
        it += 1
    return x, it, syncs


def _diag_estimate(matvec: Callable, template, gen: torch.Generator, probes: int,
                   total: Callable | None = None):
    """Hutchinson estimate of the matvec operator's diagonal with Rademacher
    probes drawn from `gen`: diag ~ E[(A z) * z], z in {+-1}. `total`, if
    given, maps the sum of the probes' products to the operator's (a
    sharded solve: matvec is this rank's share, `total` sums over the ranks
    once). Clipped to a positive floor, 1e-6 of the mean magnitude, so that
    the inverse stays defined for parameters the problem barely touches."""
    acc = None
    for _ in range(probes):
        z = [
            torch.randint(0, 2, t.shape, generator=gen, device=t.device).to(t.dtype) * 2 - 1
            for t in template
        ]
        az = _tmul(matvec(z), z)
        acc = az if acc is None else _taxpy(1.0, az, acc)
    if total is not None:
        acc = total(acc)
    d = [x * (1.0 / probes) for x in acc]
    total = sum(x.abs().sum() for x in d)
    count = sum(x.numel() for x in d)
    floor = 1e-6 * total / count + 1e-30
    return [torch.maximum(x.abs(), floor) for x in d]


def _one_outer_step(
    weighted_residual_fn, robust_residual_fn, project_fn, cfg: LMConfig,
    params, lam, mask, aux, diag_fn=None, gen=None, all_reduce=None,
):
    """One LM outer iteration: frozen IRLS weights, CG on the damped normal
    equations, trial step with accept/reject and lambda update. `gen` draws
    the Hutchinson probes (cfg.precond_probes > 0 and no diag_fn);
    `all_reduce` sums over the ranks (see the module docstring). Returns
    (params, lam, cost, accept, rel_decrease, start cost, CG iterations,
    host syncs); the scalars stay on the device."""
    if robust_residual_fn is None:
        w = params.pose.new_ones((1,))
    else:
        r = robust_residual_fn(params, aux)
        s = (r * r).sum(-1)
        w = 1.0 / torch.sqrt(1.0 + s / (cfg.robustness * cfg.robustness))

    def res_w(*leaves):
        return weighted_residual_fn(_rebuild(params, leaves), w, aux)

    x0 = _leaves(params)
    mask_l = _leaves(mask)
    r0, vjp_fn = torch.func.vjp(res_w, *x0)

    def jt(u):
        return list(vjp_fn(u))

    def j(v):
        return torch.func.jvp(res_w, tuple(x0), tuple(v))[1]

    cost, *g = _summed(all_reduce, [0.5 * torch.dot(r0, r0)] + jt(r0))
    g = _tmul(g, mask_l)

    def jtj(v):  # this rank's J^T J v on the masked parameters
        return jt(j(_tmul(v, mask_l)))

    def matvec(v):
        return _taxpy(lam, v, _tmul(_summed(all_reduce, jtj(v)), mask_l))

    minv = None
    if diag_fn is not None:
        # exact diag(J^T J) (residuals.build_diag_fn); masked parameters
        # keep only the damping term, like matvec's lam * v there
        d = diag_fn(params, w, aux)
        # exact-type check: the plain diagonal is a NamedTuple (a tuple
        # subclass); only a BARE 2-tuple carries (diag, pose blocks)
        if type(d) is tuple:
            # block Jacobi: the damped, masked 6x6 pose block of each frame
            # is inverted; every other parameter stays elementwise
            *dl, blocks = _summed(all_reduce, _leaves(d[0]) + [d[1]])
            mp = mask.pose
            bm = blocks * mp[:, :, None] * mp[:, None, :] + lam * torch.eye(
                blocks.shape[-1], dtype=blocks.dtype, device=blocks.device
            )
            binv = torch.linalg.inv(bm)  # PSD blocks + lam*I: invertible
            elem = [1.0 / (dd * m + lam) for dd, m in zip(dl, mask_l)]

            def minv(r, _binv=binv, _elem=elem):
                z = _tmul(r, _elem)
                z[0] = torch.einsum("nij,nj->ni", _binv, r[0])  # leaf 0 = pose
                return z
        else:
            dl = _summed(all_reduce, _leaves(d))
            minv = [1.0 / (dd * m + lam) for dd, m in zip(dl, mask_l)]
    elif cfg.precond_probes > 0:
        # fresh probes every outer step: `gen` advances with each draw (the
        # JAX package folds lam's bits into its key instead). The probes'
        # J^T J products are summed over the ranks in one all-reduce, then
        # masked and damped as in matvec (z * z = 1).
        def damped(acc):
            return [x * m + lam * cfg.precond_probes
                    for x, m in zip(_summed(all_reduce, acc), mask_l)]

        d = _diag_estimate(jtj, x0, gen, cfg.precond_probes, total=damped)
        minv = [1.0 / x for x in d]
    dx, cg_it, syncs = _cg(matvec, [-t for t in g], cfg.cg_iters, minv=minv)
    trial = _rebuild(params, [p + d * m for p, d, m in zip(x0, dx, mask_l)])
    if project_fn is not None:
        trial = project_fn(trial)
    r_new = res_w(*_leaves(trial))
    new_cost, = _summed(all_reduce, [0.5 * torch.dot(r_new, r_new)])

    accept = new_cost < cost
    out = _rebuild(params, [
        torch.where(accept, a, b) for a, b in zip(_leaves(trial), x0)
    ])
    lam_out = torch.where(
        accept,
        (lam * cfg.lam_down).clamp_min(cfg.lam_min),
        (lam * cfg.lam_up).clamp_max(cfg.lam_max),
    )
    rel_decrease = (cost - new_cost) / cost.clamp_min(1e-30)
    return (out, lam_out, torch.where(accept, new_cost, cost), accept,
            rel_decrease, cost, cg_it, syncs)


def solve(
    weighted_residual_fn: Callable,
    robust_residual_fn: Callable | None,
    params0,
    mask,
    cfg: LMConfig,
    aux=None,
    project_fn: Callable | None = None,
    diag_fn: Callable | None = None,
    all_reduce: Callable | None = None,
) -> LMResult:
    """Minimize 0.5 * || weighted_residual_fn(params, irls_w, aux) ||^2.

    weighted_residual_fn(params, irls_w, aux) -> flat residual vector, with
      `irls_w` (per-robust-block sqrt weights) already folded in.
    robust_residual_fn(params, aux) -> (M, d) raw robust-block residuals used
      to recompute IRLS weights between outer iterations (None: no
      robustification; irls_w is all-ones).
    params0 / mask: SolverParams and a same-structure 0/1 SolverParams.
    project_fn(params) -> params: optional feasibility projection.
    diag_fn(params, irls_w, aux) -> exact diag(J^T J) (or with the pose
      blocks) for a Jacobi preconditioner; without it and with
      cfg.precond_probes > 0, Hutchinson probes from a torch.Generator on
      the parameters' device, seeded with 17 for each solve, estimate it.
    all_reduce(flat) -> flat summed over the ranks in place, for residual
      functions over one rank's share of the constraints (None: one
      process).
    """
    params = params0
    device = params.pose.device
    lam = torch.tensor(cfg.lam_init, dtype=torch.float32, device=device)
    gen = None
    if diag_fn is None and cfg.precond_probes > 0:
        gen = torch.Generator(device=device).manual_seed(17)
    reduces = 0
    if all_reduce is not None:
        reduce_sum = all_reduce

        def all_reduce(t):
            nonlocal reduces
            reduces += 1
            return reduce_sum(t)

    cost = cost0 = None
    steps = cg_total = syncs = 0
    chunks = max(1, -(-cfg.max_outer // cfg.chunk))
    done = False
    for _ in range(chunks):
        rejects = 0
        for _ in range(cfg.chunk):
            params, lam, cost, accept, rel, start, cg_it, cg_syncs = _one_outer_step(
                weighted_residual_fn, robust_residual_fn, project_fn, cfg,
                params, lam, mask, aux, diag_fn, gen, all_reduce,
            )
            if cost0 is None:
                cost0 = start
            steps += 1
            cg_total += cg_it
            accepted, rel_v, lam_v = torch.stack(
                [accept.float(), rel, lam]
            ).tolist()
            syncs += cg_syncs + 1
            rejects = 0 if accepted else rejects + 1
            converged = accepted and rel_v < cfg.rtol
            stuck = rejects >= 3 and lam_v >= cfg.lam_max
            if converged or stuck:
                done = True
                break
        if done:
            break
    cost, cost0 = torch.stack([cost, cost0]).tolist()
    return LMResult(
        params=params, cost=cost, cost0=cost0, iterations=steps,
        cg_iterations=cg_total, syncs=syncs + 1, lam=lam, all_reduces=reduces,
        probe_state=None if gen is None else gen.get_state(),
    )


def make_mask(params, fix_poses=False, fix_focal=False, fix_depth=False,
              fix_spatial=False):
    """0/1 mask with the structure of a SolverParams."""

    def m(x, fixed):
        return torch.zeros_like(x) if fixed else torch.ones_like(x)

    shift = params.depth_shift
    return type(params)(
        pose=m(params.pose, fix_poses),
        focal=m(params.focal, fix_focal),
        depth_grid=m(params.depth_grid, fix_depth),
        spatial_grid=m(params.spatial_grid, fix_spatial),
        depth_shift=None if shift is None else m(shift, fix_depth),
    )
