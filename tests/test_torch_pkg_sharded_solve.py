"""The pose solve sharded over the constraints of a data mesh, on the CPU:
the port's torch.distributed ranks against its one-process solve and the
JAX package's solves, single-device and sharded over its 8-device mesh
(tests/test_parallel_solver.py).

Three scenes on tests/test_solver.py's make_scene(num_frames=4,
pts_per_pair=24) (exact reprojections of a static scene, made with numpy
from a seed):
  - "static": test_parallel_solver's _opt() (2 steps to a 4x3 grid, 10 LM
    steps and 16 CG iterations a solve, the default pose-block Jacobi
    diagonal);
  - "triplets": with a scene-flow triplet of static points a centre frame
    (smooth_static_weight 1), block Jacobi, 1 step;
  - "probes": the exact diagonal off and 4 Hutchinson probes an outer
    step, 1 step.
The port runs each in one process and on 2 and 3 spawned gloo ranks
(file:// store, one torch thread; tests/torch_pkg_mesh_ranks.py), all of
them while the JAX package runs. Padding: 6 pairs and 2 triplets pad to 8
on the JAX mesh, the triplets to 3 on 3 ranks (rank 2 holds a pad row
only).

Held: poses within 5e-3 and depth grids within 2e-2 relative of each other
(test_parallel_solver's bounds: the sums over the constraints run in
another order); each LM solve's start and final costs against the
one-process run's (FINAL_COST_SHARE says how); every rank's SolverParams
bitwise equal after every LM solve; the probes' generator state equal on
every rank and to one process's after every solve; one all-reduce a CG
iteration and three an outer step beyond them, none for the normalize
solve (it reads per-frame data only and runs whole on every rank); the
triplet rows shared over the ranks, 3 ranks leaving a pad row of weight 0. JAX_RUNS says which JAX runs each scene meets. Beside
it: shard_pose_inputs's blocks, padding and zero pad weights against the
JAX package's own for 1-4 and 8 ranks.
"""

import hashlib
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_pkg_mesh_ranks as ranks
from robust_cvd_tpu.config import PoseOptParams as JOpt
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.solver import pose_opt as jpo
from robust_cvd_tpu.solver import residuals as jres
from robust_cvd_tpu_torch.parallel import mesh as tmesh
from robust_cvd_tpu_torch.solver import pose_opt as tpo
from robust_cvd_tpu_torch.solver.residuals import ConstraintData, TripletData
from test_solver import make_scene
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

POSE_ATOL, GRID_RTOL, COST_RTOL = 5e-3, 2e-2, 1e-3
# Costs: each solve's start and final cost within COST_RTOL relative of
# one process's plus FINAL_COST_SHARE of the largest start cost of the
# schedule so far. The exact scenes end their capped solves in the slow
# tail, 1e-12 to 1e-5 of their start, where the order of the sums moves
# the end point (the triplet scene's step ended at 3.8e-06 in one process
# and at 3.8e-06 and 3.1e-06 on 2 and 3 ranks, from 0.805; the probe
# scene's at 1.2e-07, 7.4e-07 and 5.7e-07; the static scene's last step
# starts and ends at round-off, 2-4e-12), so no relative bound holds
# there alone.
FINAL_COST_SHARE = 1e-4
RANKS = (2, 3)
JOIN_S = 300
# The JAX package's runs of each scene. Its compiles take most of the
# file's time (12-22 s a run on the CPU), so it runs the single-device
# solve of the static scene only, which tests/test_parallel_solver.py
# holds to its sharded solve.
# On the probe scene the JAX package's probes come from jax.random: with no
# pose fixed the scene's solutions form a family, and two probe sequences
# end 0.025 apart in the poses at the same round-off cost (2.9e-11), so
# that scene is held to the port's one-process run only.
JAX_RUNS = {"static": ("single", "sharded"), "triplets": ("sharded",), "probes": ()}
# tests/test_parallel_solver.py::_opt
OPT = dict(num_steps=2, ctf_long=4, ctf_short=3, lm_max_outer=10, lm_cg_iters=16,
           graduate_deformation_regularization=True)


def triplets(true, pts, seed=1):
    """A triplet of static points a centre frame t (1..n-2) of make_scene's
    cameras `true`, seen in frames t-1, t and t+1 by exact reprojection."""
    num_frames = int(true.pose.shape[0])
    rng = np.random.default_rng(seed)
    centre = np.arange(1, num_frames - 1)
    t = len(centre)
    ndc = rng.uniform(-0.6, 0.6, (t, pts, 2)).astype(np.float32)
    depth = rng.uniform(1.5, 3.0, (t, pts)).astype(np.float32)
    f = jnp.full((t,), 0.5)
    world = jres.camera_to_world(jnp.concatenate([ndc, depth[..., None]], -1), f, f,
                                 true.pose[centre])
    prev, nxt = (np.asarray(jres.world_to_camera(world, f, f, true.pose[centre + k]))
                 for k in (-1, 1))
    trip = dict(
        frame=centre.astype(np.int32),
        loc=np.stack([prev[..., :2], ndc, nxt[..., :2]], 2),
        depth=np.stack([prev[..., 2], depth, nxt[..., 2]], 2),
        weight=np.ones((t, pts), np.float32),
    )
    return trip


def _scenes():
    """name -> (JAX ConstraintData, triplet arrays or None, options)."""
    true, _, static = make_scene(num_frames=4, pts_per_pair=24)
    return {
        "static": (static, None, OPT),
        "triplets": (static, triplets(true, 24), dict(OPT, num_steps=1, smooth_static_weight=1.0,
                                                      lm_precond_pose_blocks=True)),
        "probes": (static, None, dict(OPT, num_steps=1, lm_precond_exact=False,
                                      lm_precond_probes=4)),
    }


def _numpy(a):
    a = np.asarray(a)
    return a.astype(np.int64) if a.dtype.kind == "i" else a.astype(np.float32)


def _save_scenes(path, scenes):
    arrays, listed = {}, []
    for name, (data, trip, opt) in scenes.items():
        n = int(np.asarray(data.pair).max()) + 1
        for f in ConstraintData._fields:
            arrays[f"{name}/data/{f}"] = _numpy(getattr(data, f))
        if trip is not None:
            for f in TripletData._fields:
                arrays[f"{name}/trip/{f}"] = _numpy(trip[f])
        arrays[f"{name}/median"] = np.full((n,), 2.5, np.float32)
        arrays[f"{name}/focal"] = np.full((n,), 0.5, np.float32)
        listed.append(dict(name=name, aspect=1.0, num_frames=n, triplets=trip is not None,
                           opt=opt))
    np.savez(path, scenes=json.dumps(listed), **arrays)


def _jax_inputs(data, trip):
    n = int(np.asarray(data.pair).max()) + 1
    triplets = None if trip is None else jres.TripletData(
        **{k: jnp.asarray(v) for k, v in trip.items()})
    return jpo.PoseOptInputs(data=data, median_depth=jnp.full((n,), 2.5), aspect=1.0,
                             num_frames=n, triplets=triplets), n


def _spawn(size, *args):
    return mp.start_processes(ranks.solve_rank, args=(size, *args), nprocs=size, join=False,
                              start_method="spawn")


def _join(ctx):
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in {JOIN_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_solve")
    scenes = _scenes()
    scenes_file = str(root / "scenes.npz")
    _save_scenes(scenes_file, scenes)
    # the port in one process (size 1) and on each mesh, meanwhile JAX
    ctxs = [_spawn(size, str(root / f"store{size}"), scenes_file, str(root))
            for size in (1,) + RANKS]
    try:
        jax_runs = {}
        for name, (data, trip, opt) in scenes.items():
            inputs, n = _jax_inputs(data, trip)
            runs = {"single": inputs,
                    "sharded": jmesh.shard_pose_inputs(inputs, jmesh.make_mesh(8))}
            jax_runs[name] = {k: jpo.run(JOpt(**opt), runs[k], focal=jnp.full((n,), 0.5))
                              for k in JAX_RUNS[name]}
    finally:
        for ctx in ctxs:
            _join(ctx)

    def load(size, r):
        got = np.load(root / f"solve_{size}_rank{r}.npz")
        fields = {k.split("/")[1] for k in got.files}
        return {name: {f: got[f"{name}/{f}"] for f in fields} for name in scenes}

    # normalize and one solve a step
    solves = {name: 1 + opt["num_steps"] for name, (_, _, opt) in scenes.items()}
    return dict(scenes=scenes, jax=jax_runs, single=load(1, 0), solves=solves,
                mesh={size: [load(size, r) for r in range(size)] for size in RANKS})


@pytest.mark.parametrize("scene", ["static", "triplets", "probes"])
def test_sharded_solve_matches_one_process_and_jax(runs, scene):
    ref = runs["single"][scene]
    want = [("port, one process", ref)]
    want += [(f"JAX {k}", {"pose": np.asarray(v.pose), "depth_grid": np.asarray(v.depth_grid)})
             for k, v in runs["jax"][scene].items()]
    for size in RANKS:
        got = runs["mesh"][size][0][scene]
        for label, w in want:
            np.testing.assert_allclose(got["pose"], w["pose"], rtol=0, atol=POSE_ATOL,
                                       err_msg=f"{size} ranks vs {label}")
            np.testing.assert_allclose(got["depth_grid"], w["depth_grid"], rtol=GRID_RTOL,
                                       err_msg=f"{size} ranks vs {label}")
        assert len(got["cost"]) == len(ref["cost"]) == runs["solves"][scene]
        scale = FINAL_COST_SHARE * np.maximum.accumulate(ref["cost0"])
        for key in ("cost0", "cost"):
            assert (np.abs(got[key] - ref[key]) <= COST_RTOL * ref[key] + scale).all(), (
                key, got[key], ref[key])
    # the port's one-process solve itself against the JAX package's
    for label, w in want[1:]:
        np.testing.assert_allclose(ref["pose"], w["pose"], rtol=0, atol=POSE_ATOL, err_msg=label)


@pytest.mark.parametrize("size", RANKS)
def test_replicas_and_probes_are_bitwise_equal(runs, size):
    fresh = hashlib.sha256(torch.Generator().manual_seed(17).get_state().numpy().tobytes())
    first = runs["mesh"][size][0]
    for name in runs["scenes"]:
        assert all(first[name]["digests"]), name
        for r, rep in enumerate(runs["mesh"][size][1:], 1):
            assert rep[name]["digests"].tolist() == first[name]["digests"].tolist(), (name, r)
            assert np.array_equal(rep[name]["pose"], first[name]["pose"])
            assert rep[name]["probes"].tolist() == first[name]["probes"].tolist(), (name, r)
        # every rank's generator, seeded with 17 each solve, ends where one
        # process's does: the same probes were drawn
        probes = first[name]["probes"].tolist()
        assert probes == runs["single"][name]["probes"].tolist()
        if name == "probes":
            assert all(probes) and fresh.hexdigest() not in probes
        else:
            assert not any(probes)


@pytest.mark.parametrize("size", RANKS)
def test_all_reduces_a_solve(runs, size):
    """Each sharded LM solve: one all-reduce a CG iteration and three an
    outer step (cost and J^T r, the exact diagonal or all of the probes'
    products, the trial cost); the normalize solve runs whole on every
    rank and needs none, nor does one process."""
    for name in runs["scenes"]:
        for rep in runs["mesh"][size]:
            got = rep[name]
            step = got["stage"] != "normalize"
            assert step.sum() == runs["solves"][name] - 1
            np.testing.assert_array_equal(got["all_reduces"][step],
                                          got["cg"][step] + 3 * got["outer"][step], err_msg=name)
            assert (got["all_reduces"][~step] == 0).all()
        assert (runs["single"][name]["all_reduces"] == 0).all()


@pytest.mark.parametrize("size", RANKS)
def test_triplet_scene_solves_its_triplets_on_every_rank(runs, size):
    """The triplets' rows are shared over the ranks and the solve reads
    them: 2 triplets give each rank one row on 2 ranks and leave rank 2 a
    pad row of weight 0 on 3; the smoothness residuals move the solve off
    the static scene's."""
    weights = [rep["triplets"]["trip_weight"] for rep in runs["mesh"][size]]
    assert all(w.shape == (1, 24) for w in weights)
    assert all((w == 1.0).all() for w in weights[:2])
    if size == 3:
        assert not weights[2].any()
    single = runs["single"]
    assert single["triplets"]["trip_weight"].shape == (2, 24)
    assert single["triplets"]["cost0"][1] != single["static"]["cost0"][1]


def test_one_all_reduce_a_cg_iteration():
    """The counts of lm.solve: cost and gradient, the diagonal, each CG
    matvec and the trial cost, each one all-reduce."""
    from robust_cvd_tpu_torch.solver import lm

    p = tpo.default_solver_params(3, torch.full((3,), 0.5))
    calls = []

    def reduce_(t):
        calls.append(t.numel())
        return t

    def res(q, w, aux):
        return torch.cat([2.0 * q.pose.reshape(-1) - 1.0, q.focal - 3.0])

    def diag(q, w, aux):
        return lm._rebuild(q, [torch.full_like(t, 4.0) for t in lm._leaves(q)])

    out = lm.solve(res, None, p, lm.make_mask(p), lm.LMConfig(max_outer=3, cg_iters=5),
                   diag_fn=diag, all_reduce=reduce_)
    plain = lm.solve(res, None, p, lm.make_mask(p), lm.LMConfig(max_outer=3, cg_iters=5),
                     diag_fn=diag)
    assert out.all_reduces == len(calls) == out.cg_iterations + 3 * out.iterations
    assert plain.all_reduces == 0 and torch.equal(out.params.pose, plain.params.pose)
    n = sum(t.numel() for t in lm._leaves(p))
    assert calls[:3] == [n + 1, n, n]  # cost + J^T r, the diagonal, a matvec


@pytest.mark.parametrize("scene", ["static", "triplets"])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_shard_pose_inputs_matches_jax(scene, size):
    data, trip, _ = _scenes()[scene]
    jin, n = _jax_inputs(data, trip)
    tin = tpo.PoseOptInputs(
        data=ConstraintData(*[torch.from_numpy(_numpy(x)) for x in data]),
        median_depth=torch.full((n,), 2.5), aspect=1.0, num_frames=n,
        triplets=None if trip is None else TripletData(
            *[torch.from_numpy(_numpy(trip[f])) for f in TripletData._fields]),
    )
    jsh = jmesh.shard_pose_inputs(jin, jmesh.make_mesh(size))
    parts = [tmesh.shard_pose_inputs(tin, tmesh.Mesh(r, size, torch.device("cpu")))
             for r in range(size)]
    for field in ("data", "triplets"):
        if getattr(jin, field) is None:
            assert all(getattr(p, field) is None for p in parts)
            continue
        rows = int(getattr(jin, field).weight.shape[0])
        for k, name in enumerate(getattr(jin, field)._fields):
            want = _numpy(getattr(getattr(jsh, field), name))
            got = np.concatenate([getattr(p, field)[k].numpy() for p in parts])
            np.testing.assert_array_equal(got, want, err_msg=f"{field}.{name}")
        pad = _numpy(getattr(jsh, field).weight)[rows:]
        assert pad.size == 0 or not pad.any()
        for p in parts:
            assert p.mesh is not None and torch.equal(p.median_depth, tin.median_depth)
