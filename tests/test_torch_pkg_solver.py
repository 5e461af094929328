"""Parity of the PyTorch port's solver with the JAX package, on the CPU.

The same numpy-seeded inputs go through robust_cvd_tpu.solver and
robust_cvd_tpu_torch.solver. Tolerances: transforms and residual families
rtol 1e-5 / atol 1e-6 (float32, same formulas, different summation order
only); exact diag(J^T J) with pose blocks rtol 1e-4 (long contractions);
a whole pose_opt.run: poses within 1e-3 and final cost within 1% (two
iterative solves whose float32 rounding differs step by step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import camera as jcam
from robust_cvd_tpu.config import PoseOptParams
from robust_cvd_tpu.solver import pose_opt as jpo
from robust_cvd_tpu.solver import residuals as jres
from robust_cvd_tpu.solver import xforms as jx
from robust_cvd_tpu_torch import camera as tcam
from robust_cvd_tpu_torch.solver import pose_opt as tpo
from robust_cvd_tpu_torch.solver import residuals as tres
from robust_cvd_tpu_torch.solver import xforms as tx

RTOL, ATOL = 1e-5, 1e-6


def to_torch(tree):
    """A JAX NamedTuple (or array) -> the same structure of CPU tensors."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_torch(x) for x in tree])
    a = np.array(tree)
    if a.dtype.kind == "i":
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def port_type(tree, cls):
    return cls(*[to_torch(x) for x in tree])


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol,
    )


def _problem(value_xform="Scale", grid=(1, 2, 3), sgrid=(2, 3), seed=0):
    """3 frames, 3 pairs x 5 samples, non-trivial grids and poses."""
    rng = np.random.default_rng(seed)
    n, pairs, c = 3, [(0, 1), (1, 2), (0, 2)], 5
    p = len(pairs)
    data = dict(
        pair=np.asarray(pairs, np.int32),
        loc0=rng.uniform(-0.8, 0.8, (p, c, 2)).astype(np.float32),
        loc1=rng.uniform(-0.8, 0.8, (p, c, 2)).astype(np.float32),
        depth0=rng.uniform(1.5, 3.0, (p, c)).astype(np.float32),
        depth1=rng.uniform(1.5, 3.0, (p, c)).astype(np.float32),
        weight=rng.uniform(0.5, 1.0, (p, c)).astype(np.float32),
    )
    params = dict(
        pose=rng.uniform(-0.1, 0.1, (n, 6)).astype(np.float32),
        focal=np.asarray([0.47, 0.55, 0.6], np.float32),
        depth_grid=rng.uniform(0.8, 1.2, (n,) + grid).astype(np.float32),
        spatial_grid=rng.uniform(-0.02, 0.02, (n,) + sgrid + (2,)).astype(np.float32),
        depth_shift=(
            rng.uniform(-0.05, 0.05, (n,) + grid).astype(np.float32)
            if value_xform == "ScaleShift" else None
        ),
    )
    trip = dict(
        frame=np.asarray([1, 1, 1, 1], np.int32),
        loc=rng.uniform(-0.7, 0.7, (4, 4, 3, 2)).astype(np.float32),
        depth=rng.uniform(1.5, 3.0, (4, 4, 3)).astype(np.float32),
        weight=rng.uniform(0.3, 1.0, (4, 4)).astype(np.float32),
    )
    jp = jres.SolverParams(**{k: None if v is None else jnp.asarray(v) for k, v in params.items()})
    jd = jres.ConstraintData(**{k: jnp.asarray(v) for k, v in data.items()})
    jt = jres.TripletData(**{k: jnp.asarray(v) for k, v in trip.items()})
    return jp, jd, jt


def _cfgs(jp, intr_opt="PerFrame", static="ReproDisparity", smooth="ReproDisparityLaplacian",
          cubic=False):
    gz, gy, gx = jp.depth_grid.shape[1:]
    sy, sx = jp.spatial_grid.shape[1:3]
    kw = dict(
        aspect=4 / 3, static_loss_type=static, smooth_loss_type=smooth,
        intr_opt=intr_opt, fixed_vfocal=0.5,
    )
    jcfg = jres.SceneConfig(
        depth_spec=jx.GridSpec(gx=gx, gy=gy, gz=gz, disp_min=0.2, disp_max=0.8),
        spatial_spec=jx.GridSpec(gx=sx, gy=sy, cubic=cubic), **kw,
    )
    tcfg = tres.SceneConfig(
        depth_spec=tx.GridSpec(*jcfg.depth_spec), spatial_spec=tx.GridSpec(*jcfg.spatial_spec),
        **kw,
    )
    return jcfg, tcfg


# ---------------------------------------------------------------------------
# xforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    (4, 3, 1, False), (4, 3, 1, True), (1, 1, 1, False), (3, 2, 3, True), (1, 1, 4, False),
])
def test_xforms_taps_and_maps(spec):
    gx, gy, gz, cubic = spec
    js = jx.GridSpec(gx=gx, gy=gy, gz=gz, cubic=cubic, disp_min=0.2, disp_max=0.9)
    ts = tx.GridSpec(*js)
    rng = np.random.default_rng(1)
    loc = rng.uniform(-1.0, 1.0, (7, 9, 2)).astype(np.float32)
    loc[0, :4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]  # the clamped borders
    depth = rng.uniform(1.0, 6.0, (7, 9)).astype(np.float32)
    ji, jw = jx.grid_gather(js, jnp.asarray(loc), jnp.asarray(depth))
    ti, tw = tx.grid_gather(ts, torch.from_numpy(loc), torch.from_numpy(depth))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tw, jw)
    close(
        tres.dense_tap_weights(ts, torch.from_numpy(loc), torch.from_numpy(depth)),
        jres.dense_tap_weights(js, jnp.asarray(loc), jnp.asarray(depth)),
    )
    grid = rng.uniform(0.5, 1.5, (gz, gy, gx)).astype(np.float32)
    src = rng.uniform(1.0, 6.0, (6, 8)).astype(np.float32)
    close(
        tx.depth_param_map(torch.from_numpy(grid), ts, (6, 8), torch.from_numpy(src)),
        jx.depth_param_map(jnp.asarray(grid), js, (6, 8), jnp.asarray(src)),
    )
    close(
        tx.depth_deform_residuals(torch.from_numpy(grid)),
        jx.depth_deform_residuals(jnp.asarray(grid)),
    )
    close(
        tx.shift_deform_residuals(torch.from_numpy(grid)),
        jx.shift_deform_residuals(jnp.asarray(grid)),
    )
    warp = rng.uniform(-0.1, 0.1, (gy, gx, 2)).astype(np.float32)
    close(
        tx.spatial_warp_map(torch.from_numpy(warp), cubic, (6, 8)),
        jx.spatial_warp_map(jnp.asarray(warp), cubic, (6, 8)),
    )
    grids = rng.uniform(0.5, 1.5, (3, gz, gy, gx)).astype(np.float32)
    new = tx.GridSpec(gx=gx + 3, gy=gy + 2, gz=gz)
    close(
        tx.split_grid(torch.from_numpy(grids), new),
        jx.split_grid(jnp.asarray(grids), jx.GridSpec(*new)),
    )
    mask = (rng.uniform(0, 1, (3, 12, 16)) > 0.3).astype(np.uint8) * 255
    close(
        tx.adaptive_deform_weights(mask, ts, 0.1, 0.5),
        jx.adaptive_deform_weights(mask, js, 0.1, 0.5),
    )


def test_camera_helpers():
    rng = np.random.default_rng(2)
    pose = rng.uniform(-0.5, 0.5, (5, 6)).astype(np.float32)
    pose[0, 3:] = 0.0  # the first-order branch at zero rotation
    focal = rng.uniform(0.3, 0.7, 5).astype(np.float32)
    jc = jcam.pose_params_to_camera(jnp.asarray(pose), jnp.asarray(focal), 1.5)
    tc = tcam.pose_params_to_camera(torch.from_numpy(pose), torch.from_numpy(focal), 1.5)
    for a, b in zip(tc, jc):
        close(a, b)
    close(tcam.quat_to_matrix(tc.quaternion), jax.vmap(jcam.quat_to_matrix)(jc.quaternion))
    close(
        tcam.axis_angle_to_matrix(torch.from_numpy(pose[:, 3:])),
        jax.vmap(jcam.axis_angle_to_matrix)(jnp.asarray(pose[:, 3:])),
    )
    back, f = tcam.camera_to_pose_params(tc)
    close(back, pose, atol=1e-5)
    close(f, focal)


# ---------------------------------------------------------------------------
# residual families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value_xform", ["Scale", "ScaleShift"])
@pytest.mark.parametrize("static", ["Euclidean", "ReproDisparity", "ReproDepthRatio", "ReproLogDepth"])
def test_static_scene_residuals(value_xform, static):
    jp, jd, _ = _problem(value_xform)
    jcfg, tcfg = _cfgs(jp, static=static)
    tp, td = port_type(jp, tres.SolverParams), port_type(jd, tres.ConstraintData)
    want = jres.static_scene_residuals(jp, jcfg, jd)
    close(tres.static_scene_residuals(tp, tcfg, td), want)
    locs = jpo.scale_reg_grid_locs(PoseOptParams(), 4 / 3)
    jt = jres.build_dense_taps(jcfg, jd, jnp.full((3,), 2.0), locs)
    tt = tres.build_dense_taps(tcfg, td, torch.full((3,), 2.0), to_torch(locs))
    close(tres.static_scene_residuals(tp, tcfg, td, tt),
          jres.static_scene_residuals(jp, jcfg, jd, jt))


@pytest.mark.parametrize("smooth", [
    "EuclideanLaplacian", "ReproDisparityLaplacian", "ReproDepthRatioConsistency",
    "ReproLogDepthConsistency",
])
@pytest.mark.parametrize("intr_opt", ["PerFrame", "Shared", "Fixed"])
def test_smoothness_and_regularizers(smooth, intr_opt):
    jp, _, jt = _problem("ScaleShift")
    jcfg, tcfg = _cfgs(jp, intr_opt=intr_opt, smooth=smooth, cubic=True)
    tp, tt = port_type(jp, tres.SolverParams), port_type(jt, tres.TripletData)
    close(tres.smoothness_residuals(tp, tcfg, tt), jres.smoothness_residuals(jp, jcfg, jt))
    locs = jpo.scale_reg_grid_locs(PoseOptParams(), 4 / 3)
    med = np.asarray([1.5, 2.0, 2.5], np.float32)
    close(
        tres.scale_reg_residuals(tp, tcfg, torch.from_numpy(med), to_torch(locs)),
        jres.scale_reg_residuals(jp, jcfg, jnp.asarray(med), locs),
    )
    close(tres.position_reg_residuals(tp), jres.position_reg_residuals(jp))
    close(tres.focal_reg_residuals(tp, tcfg), jres.focal_reg_residuals(jp, jcfg))
    r = np.random.default_rng(3).normal(size=(3, 5, 3)).astype(np.float32)
    close(tres.cauchy_irls_weight(torch.from_numpy(r), 0.5),
          jres.cauchy_irls_weight(jnp.asarray(r), 0.5))


def _stage(value_xform, intr_opt, use_triplets, use_adaptive):
    """A stage of both packages at random parameters: (j, t) tuples of
    (params, aux, cfg), the opt and the IRLS weights."""
    jp, jd, jt = _problem(value_xform, grid=(2, 3, 2), sgrid=(2, 2))
    opt = dataclasses.replace(
        PoseOptParams(), intr_opt=intr_opt, position_regularization=0.3,
        value_xform=value_xform,
    )
    inputs = jpo.PoseOptInputs(
        data=jd, median_depth=jnp.asarray([1.8, 2.0, 2.4]), aspect=4 / 3, num_frames=3,
        triplets=jt,
    )
    jcfg = jpo._make_cfg(opt, inputs, jp)
    jaux = jpo._aux(opt, inputs, use_triplets, cfg=jcfg)
    tinputs = tpo.PoseOptInputs(
        data=port_type(jd, tres.ConstraintData), median_depth=to_torch(inputs.median_depth),
        aspect=4 / 3, num_frames=3, triplets=port_type(jt, tres.TripletData),
    )
    tp = port_type(jp, tres.SolverParams)
    tcfg = tpo._make_cfg(opt, tinputs, tp)
    taux = tpo._aux(opt, tinputs, use_triplets, cfg=tcfg)
    if use_adaptive:
        e = jx.depth_deform_residuals(jp.depth_grid[0]).shape[0]
        aw = np.random.default_rng(5).uniform(0.1, 0.8, (3, e)).astype(np.float32)
        jaux = jaux._replace(adaptive_weights=jnp.asarray(aw))
        taux = taux._replace(adaptive_weights=torch.from_numpy(aw))
    w = np.random.default_rng(1).uniform(0.4, 1.0, jd.weight.shape).astype(np.float32)
    return (jp, jaux, jcfg), (tp, taux, tcfg), opt, w


STAGES = [
    ("Scale", "PerFrame", False, False),
    ("ScaleShift", "PerFrame", False, False),
    ("Scale", "PerFrame", True, False),
    ("Scale", "Shared", True, False),
    ("ScaleShift", "Fixed", True, True),
]


@pytest.mark.parametrize("value_xform,intr_opt,use_triplets,use_adaptive", STAGES)
def test_residual_fn(value_xform, intr_opt, use_triplets, use_adaptive):
    (jp, jaux, jcfg), (tp, taux, tcfg), opt, w = _stage(
        value_xform, intr_opt, use_triplets, use_adaptive
    )
    jfn = jres.build_residual_fn(jcfg, opt, 0.7, use_triplets, use_adaptive)
    tfn = tres.build_residual_fn(tcfg, opt, 0.7, use_triplets, use_adaptive)
    close(tfn(tp, torch.from_numpy(w), taux), jfn(jp, jnp.asarray(w), jaux))


@pytest.mark.parametrize("value_xform,intr_opt,use_triplets,use_adaptive", STAGES)
def test_diag_fn_pose_blocks(value_xform, intr_opt, use_triplets, use_adaptive):
    (jp, jaux, jcfg), (tp, taux, tcfg), opt, w = _stage(
        value_xform, intr_opt, use_triplets, use_adaptive
    )
    # jit: one compile is far quicker on the CPU than op-by-op dispatch
    jd, jb = jax.jit(
        jres.build_diag_fn(jcfg, opt, 0.7, use_triplets, use_adaptive, pose_blocks=True)
    )(jp, jnp.asarray(w), jaux)
    td, tb = tres.build_diag_fn(tcfg, opt, 0.7, use_triplets, use_adaptive, pose_blocks=True)(
        tp, torch.from_numpy(w), taux
    )
    for name in jres.SolverParams._fields:
        a, b = getattr(td, name), getattr(jd, name)
        assert (a is None) == (b is None), name
        if a is not None:
            close(a, b, rtol=1e-4, atol=1e-6)
    close(tb, jb, rtol=1e-4, atol=1e-6)
    plain = tres.build_diag_fn(tcfg, opt, 0.7, use_triplets, use_adaptive)(
        tp, torch.from_numpy(w), taux
    )
    assert type(plain) is tres.SolverParams


# ---------------------------------------------------------------------------
# a whole cold solve
# ---------------------------------------------------------------------------


def test_pose_opt_run_matches():
    """One pose_opt.run on a 6-frame problem shaped like
    bench.py::make_clip_problem (hierarchical2 pairs, exact reprojections,
    corrupted per-frame depth scales), 16 samples per pair."""
    from bench import make_clip_problem

    jin, _ = make_clip_problem(num_frames=6, samples_per_pair=16, seed=0)
    opt = dataclasses.replace(
        PoseOptParams(), num_steps=1, ctf_long=3, ctf_short=2, lm_max_outer=4,
        lm_cg_iters=8,
    )
    tin = tpo.PoseOptInputs(
        data=port_type(jin.data, tres.ConstraintData),
        median_depth=to_torch(jin.median_depth), aspect=jin.aspect,
        num_frames=jin.num_frames,
    )
    jp = jpo.run(opt, jin)
    log = []
    tp = tpo.run(opt, tin, log=log)
    close(tp.pose, jp.pose, rtol=0, atol=1e-3)
    assert [e["stage"] for e in log] == ["normalize", "step0"]
    assert all(e["cost"] < e["cost0"] for e in log)

    # final cost of both solutions under the last stage's objective
    jcfg = jpo._make_cfg(opt, jin, jp)
    jaux = jpo._aux(opt, jin, False, cfg=jcfg)
    jw = jres.cauchy_irls_weight(jres.static_scene_residuals(jp, jcfg, jin.data, jaux.taps), opt.robustness)
    jr = jres.build_residual_fn(jcfg, opt, opt.deformation_regularization_final)(jp, jw, jaux)
    tcfg = tpo._make_cfg(opt, tin, tp)
    taux = tpo._aux(opt, tin, False, cfg=tcfg)
    tw = tres.cauchy_irls_weight(tres.static_scene_residuals(tp, tcfg, tin.data, taux.taps), opt.robustness)
    tr = tres.build_residual_fn(tcfg, opt, opt.deformation_regularization_final)(tp, tw, taux)
    jcost, tcost = 0.5 * float(jnp.vdot(jr, jr)), 0.5 * float(torch.dot(tr, tr))
    assert abs(tcost - jcost) <= 0.01 * jcost


def test_hutchinson_probes_raise():
    from robust_cvd_tpu_torch.solver import lm

    p = tres.SolverParams(
        pose=torch.zeros(1, 6), focal=torch.ones(1),
        depth_grid=torch.ones(1, 1, 1, 1), spatial_grid=torch.zeros(1, 1, 1, 2),
    )

    def res(q, w, aux):
        return torch.cat([q.pose.reshape(-1) - 1.0, q.focal])

    # Hutchinson probes are ported (tests/test_torch_pkg_options.py): on this
    # operator, diagonal in every parameter, the estimate is exact, and the
    # solve reaches the plain solve's minimum
    plain = lm.solve(res, None, p, lm.make_mask(p), lm.LMConfig())
    probed = lm.solve(res, None, p, lm.make_mask(p), lm.LMConfig(precond_probes=2))
    assert probed.cost < 1e-6 * probed.cost0
    torch.testing.assert_close(probed.params.pose, plain.params.pose, rtol=0, atol=1e-5)
    torch.testing.assert_close(probed.params.pose, torch.ones(1, 6), rtol=0, atol=1e-5)
