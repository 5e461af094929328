"""The ranks of tests/test_torch_pkg_mesh.py: functions that a spawned
process runs as one rank of a CPU data mesh (gloo over a file:// store),
each leaving its results in a .npz file for the test to read. They import
only torch, numpy and the port, so that a rank starts without JAX."""

import os

import numpy as np
import torch

from robust_cvd_tpu_torch.parallel.mesh import Mesh, destroy_mesh, init_mesh


def _init(rank: int, size: int, store_file: str) -> Mesh:
    torch.set_num_threads(1)
    return init_mesh(device="cpu", init_method=f"file://{store_file}", rank=rank,
                     world_size=size, timeout_s=300)


def gather_rank(rank: int, size: int, store_file: str, out_dir: str, counts) -> None:
    """For every group of the first k ranks (k = 1..size) and every n of
    `counts`: this rank's shard of n items (item i is 10 i + 1) gathered
    with all_gather_leading, saved by the group's members."""
    import torch.distributed as dist

    _init(rank, size, store_file)
    try:
        out = {}
        for k in range(1, size + 1):
            group = dist.new_group(list(range(k)))
            if rank >= k:
                continue
            mesh = Mesh(rank=rank, size=k, device=torch.device("cpu"), group=group)
            for n in counts:
                items = torch.arange(n, dtype=torch.float32) * 10 + 1
                mine = items[mesh.shard(n)][:, None].repeat(1, 3)
                out[f"k{k}_n{n}"] = mesh.all_gather_leading(mine, n).numpy()
        np.savez(os.path.join(out_dir, f"gather_rank{rank}.npz"), **out)
    finally:
        destroy_mesh()


def slice_rank(rank: int, size: int, store_file: str, clip: str, out_dir: str, opt: dict,
               ft: dict) -> None:
    """One rank of the mesh run on the slice clip `clip` (shared by the
    ranks): compute_initial_depth, the flow masks and pair stats, then
    DatasetProcessor.fine_tune with the small MiDaS net of
    tests/test_torch_pkg_finetune.py. Then the guard: a step in which this
    rank's loss alone is non-finite (rank 1's masks set to inf), and a
    FlatAdam step in which only rank 1 passes an infinite loss, must be
    skipped by every rank. Saves the flat parameters, the BatchNorm
    buffers, the epochs' losses, the guard's flags, the poses and the
    SolverParams digest and all-reduces of every LM solve (every rank
    solves on its share of the constraints)."""
    from robust_cvd_tpu_torch import config
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    _init(rank, size, store_file)
    try:
        net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
        adapter = midas.MidasV2Adapter(net)
        store = VideoStore.open(clip)
        depth = compute_initial_depth(store, adapter, "midas2", device="cpu")
        pairs = sample_pairs(store.num_frames, ("hierarchical2",), two_way=True)
        stage = FlowStage(store, device="cpu")
        stage.compute_flow_masks(pairs)
        stage.compute_flow_pair_stats(pairs)
        cfg = config.PipelineConfig(path=clip, opt=config.PoseOptParams(**opt),
                                    ft=config.FineTuneParams(**ft))
        tuner = DatasetProcessor(cfg, models={"depth": adapter}, device="cpu").fine_tune(
            store, depth)

        opt_ = tuner.optimizer
        flat, count = opt_.flat.clone(), int(opt_.count)
        order = torch.arange(int(tuner.clip.pair_idx.shape[0]))
        _, ids = tuner.epoch_batches(order)[0]
        clip_data = tuner.clip
        if rank == 1:
            tuner.clip = clip_data._replace(masks=torch.full_like(clip_data.masks, torch.inf))
        # rank 0's data are untouched and its local loss finite
        loss, _, ok_step = tuner.train_step(ids)
        tuner.clip = clip_data
        opt_.grad.zero_()
        ok_adam = opt_.step(torch.tensor(torch.inf if rank == 1 else 1.0))
        np.savez(
            os.path.join(out_dir, f"rank{rank}.npz"),
            flat=flat.numpy(), count=count,
            buffers=torch.cat([b.reshape(-1).double() for b in net.buffers()]).numpy(),
            losses=np.array([h["loss"] for h in tuner.history]),
            skipped=np.array([h["skipped"] for h in tuner.history]),
            steps=np.array([h["steps"] for h in tuner.history]),
            guard=np.array([bool(ok_step), bool(ok_adam), torch.equal(opt_.flat, flat),
                            int(opt_.count) == count, bool(torch.isfinite(loss))]),
            pose=tuner.solver_params.pose.numpy(),
            stages=np.array([e["stage"] for e in tuner.solve_log]),
            digests=np.array([e["digest"] for e in tuner.solve_log]),
            all_reduces=np.array([e["all_reduces"] for e in tuner.solve_log]),
            pairs=int(tuner.pose_inputs.data.pair.shape[0]),
            current_depth=tuner.current_depth.numpy(),
        )
    finally:
        destroy_mesh()


def solve_scenes(scenes_file: str, mesh=None) -> dict:
    """pose_opt.run on every scene of tests/test_torch_pkg_sharded_solve.py
    (`scenes_file`, an .npz of numpy arrays and a JSON list of scenes), on
    this rank's shard (shard_pose_inputs) with a mesh, else on the whole
    problem. Returns, per scene, the poses, depth grid, the share of the
    triplets' weights on this rank (empty without triplets) and, for each
    LM solve, its cost0, cost, outer steps, CG iterations and all-reduces,
    the SolverParams digest (on a mesh) and the digest of the Hutchinson
    probes' generator state ("" without probes)."""
    import json

    from robust_cvd_tpu_torch.config import PoseOptParams
    from robust_cvd_tpu_torch.parallel.mesh import shard_pose_inputs
    from robust_cvd_tpu_torch.solver import pose_opt
    from robust_cvd_tpu_torch.solver.residuals import ConstraintData, TripletData

    arrays = np.load(scenes_file)
    scenes = json.loads(str(arrays["scenes"]))

    def tensors(prefix, fields):
        return {f: torch.from_numpy(arrays[f"{prefix}/{f}"]) for f in fields}

    out = {}
    for s in scenes:
        name = s["name"]
        trip = None
        if s["triplets"]:
            trip = TripletData(**tensors(f"{name}/trip", TripletData._fields))
        inputs = pose_opt.PoseOptInputs(
            data=ConstraintData(**tensors(f"{name}/data", ConstraintData._fields)),
            median_depth=torch.from_numpy(arrays[f"{name}/median"]), aspect=s["aspect"],
            num_frames=s["num_frames"], triplets=trip,
        )
        if mesh is not None:
            inputs = shard_pose_inputs(inputs, mesh)
        log = []
        sp = pose_opt.run(PoseOptParams(**s["opt"]), inputs,
                          focal=torch.from_numpy(arrays[f"{name}/focal"]), log=log)
        out[name] = dict(
            pose=sp.pose.numpy(), depth_grid=sp.depth_grid.numpy(),
            trip_weight=(np.zeros((0, 0), np.float32) if inputs.triplets is None
                         else inputs.triplets.weight.numpy()),
            stage=np.array([e["stage"] for e in log]),
            cost0=np.array([e["cost0"] for e in log]),
            cost=np.array([e["cost"] for e in log]),
            outer=np.array([e["outer"] for e in log]),
            cg=np.array([e["cg"] for e in log]),
            all_reduces=np.array([e.get("all_reduces", 0) for e in log]),
            digests=np.array([e.get("digest", "") for e in log]),
            probes=np.array([e.get("probes", "") for e in log]),
        )
    return out


def solve_rank(rank: int, size: int, store_file: str, scenes_file: str, out_dir: str) -> None:
    """One rank of a sharded solve of every scene (solve_scenes), saved to
    solve_<size>_rank<r>.npz; size 1: one process without a mesh."""
    if size == 1:
        torch.set_num_threads(1)
        res = solve_scenes(scenes_file)
    else:
        mesh = _init(rank, size, store_file)
        try:
            res = solve_scenes(scenes_file, mesh)
        finally:
            destroy_mesh()
    np.savez(os.path.join(out_dir, f"solve_{size}_rank{rank}.npz"),
             **{f"{k}/{f}": v for k, r in res.items() for f, v in r.items()})
